"""Dtype policy ("Traits") as torch dtypes.

Counterpart of ``tnl_lbm_tpu/utils/dtypes.py`` (reference defs.h:71-119):

- ``compute_dtype``: dtype of the distribution functions and macro fields
  on the device (float32 by default, as the reference's ``TraitsSP``);
- ``host_dtype``: float64 for host-side unit conversions and analytic
  solutions;
- ``map_dtype``: geometry-map code per site (uint8);
- ``index_dtype``: int64 - site offsets of a 512^3 D3Q27 state exceed
  2^31, so the kernels index with 64-bit offsets.

``ulp`` and ``state_agrees`` hold two computations of a state to one
bound, also when it is stored in 16 bits (half storage).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Traits:
    compute_dtype: torch.dtype = torch.float32
    host_dtype: type = np.float64
    map_dtype: torch.dtype = torch.uint8
    index_dtype: torch.dtype = torch.int64


TraitsSP = Traits(compute_dtype=torch.float32)
TraitsDP = Traits(compute_dtype=torch.float64)


def ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One unit in the last place of the floating ``dtype`` at the
    magnitudes of ``x`` (float64; subnormals count as the least normal)."""
    fi = torch.finfo(dtype)
    mag = x.double().abs().clamp_min(fi.tiny)
    return torch.exp2(torch.floor(torch.log2(mag))) * fi.eps


#: float32 discrepancy of two computations allowed before a 16-bit narrowing:
#: near zero a bfloat16 ulp is smaller than it
HALF_SLACK = 2e-8
#: share of a 16-bit state that may differ at all between two computations;
#: a narrowing that does not round to nearest even moves about half of it
HALF_MAX_DIFFERING = 1e-3


def state_agrees(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> bool:
    """Two computations of one state stored in ``dtype`` agree: within
    1e-6 in float32; in 16 bits, every element within one ulp of the larger
    magnitude plus ``HALF_SLACK``, and at most ``HALF_MAX_DIFFERING`` of
    the elements different at all."""
    a, b = a.double(), b.double()
    if dtype == torch.float32:
        return float((a - b).abs().max()) <= 1e-6
    d = (a - b).abs()
    within = bool((d <= ulp(torch.maximum(a.abs(), b.abs()), dtype) + HALF_SLACK).all())
    return within and float((d != 0).double().mean()) <= HALF_MAX_DIFFERING
