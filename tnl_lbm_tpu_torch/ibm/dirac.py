"""Regularized Dirac delta kernels for IBM interpolation and spreading
(counterpart of ``tnl_lbm_tpu/ibm/dirac.py``; reference dirac.h:7-58).

Four kernel families, named directly (the reference's switch index i=1..4
maps to phi3, phi2, phi1, phi4 per its comments):

- phi1: 4-point smooth kernel (Peskin), support |r| < 2
- phi2: cosine kernel, support |r| < 2
- phi3: hat/linear kernel, support |r| < 1
- phi4: 3-point kernel (Roma et al.), support |r| < 1.5

3D weights are separable products (reference dirac.h:60-82).  The kernels
run in the dtype of ``r``: the IBM passes float32, as the JAX package
evaluates them (x64 off), so that the weights, and the pruning of
near-empty stencil nodes that depends on their last bits, follow it.
"""

from __future__ import annotations

import math

import torch

#: half-width of the support per kernel name
SUPPORT = {"phi1": 2.0, "phi2": 2.0, "phi3": 1.0, "phi4": 1.5}


def dirac_support(name: str) -> int:
    """Number of stencil nodes per axis covering the kernel support."""
    return int(2 * math.ceil(SUPPORT[name]))


def dirac_delta(name: str, r: torch.Tensor) -> torch.Tensor:
    """1D regularized delta, zero outside its support."""
    a = torch.abs(r)
    if name == "phi3":
        val = 1 - a
        nz = a < 1.0
    elif name == "phi2":
        val = 0.25 * (1 + torch.cos(math.pi * r * 0.5))
        nz = a < 2.0
    elif name == "phi1":
        inner = (3 - 2 * a + torch.sqrt(torch.clamp_min(1 + 4 * a - 4 * r * r, 0.0))) / 8.0
        outer = (5 - 2 * a - torch.sqrt(torch.clamp_min(-7 + 12 * a - 4 * r * r, 0.0))) / 8.0
        val = torch.where(a > 1.0, outer, inner)
        nz = a < 2.0
    elif name == "phi4":
        inner = (1 + torch.sqrt(torch.clamp_min(1 - 3 * r * r, 0.0))) / 3.0
        outer = (5 - 3 * a - torch.sqrt(torch.clamp_min(-2 + 6 * a - 3 * r * r, 0.0))) / 6.0
        val = torch.where(a > 0.5, outer, inner)
        nz = a < 1.5
    else:
        raise ValueError(f"unknown dirac kernel {name}")
    return torch.where(nz, val, torch.zeros((), dtype=val.dtype, device=val.device))


def dirac_delta_3d(name: str, dx, dy, dz) -> torch.Tensor:
    """Separable 3D product (reference dirac.h:60-82)."""
    return dirac_delta(name, dx) * dirac_delta(name, dy) * dirac_delta(name, dz)
