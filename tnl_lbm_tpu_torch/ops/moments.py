"""Macroscopic moments of distribution functions (counterpart of
``tnl_lbm_tpu/ops/moments.py``; reference d3q27/common.h:17-50,
common_well.h:16-51).

``f`` is ``[Q, *S]``, ``u`` is ``[D, *S]``, ``rho`` is ``[*S]``.  The
velocity carries the half-force correction ``u = (sum_q c_q f_q + F/2) / rho``.
"""

from __future__ import annotations

import torch

from tnl_lbm_tpu_torch.models import LatticeDescriptor
from tnl_lbm_tpu_torch.ops.contract import lattice_dot


def density(lat: LatticeDescriptor, f: torch.Tensor, well: bool = False,
            high_precision: bool = False) -> torch.Tensor:
    """rho = sum_q f_q (+1 for well-conditioned deviation storage).

    ``high_precision`` uses Neumaier compensated summation over Q
    (reference USE_HIGH_PRECISION_RHO, d3q27/common.h:19-28).
    """
    if high_precision:
        s = f[0]
        comp = torch.zeros_like(s)
        for q in range(1, f.shape[0]):
            x = f[q]
            t = s + x
            comp = comp + torch.where(torch.abs(s) >= torch.abs(x), (s - t) + x, (x - t) + s)
            s = t
        rho = s + comp
    else:
        rho = torch.sum(f, dim=0)
    if well:
        rho = rho + 1
    return rho


def momentum(lat: LatticeDescriptor, f: torch.Tensor) -> torch.Tensor:
    """j_a = sum_q c_qa f_q, shape [D, *S]."""
    return lattice_dot(lat.c.T, f)


def density_velocity(lat: LatticeDescriptor, f: torch.Tensor, force=None,
                     well: bool = False, high_precision: bool = False):
    """Returns (rho, u) with the half-force velocity correction."""
    rho = density(lat, f, well=well, high_precision=high_precision)
    j = momentum(lat, f)
    if force is not None:
        j = j + 0.5 * force
    return rho, j / rho
