"""Dtype policy ("Traits") as torch dtypes.

Counterpart of ``tnl_lbm_tpu/utils/dtypes.py`` (reference defs.h:71-119):

- ``compute_dtype``: dtype of the distribution functions and macro fields
  on the device (float32 by default, as the reference's ``TraitsSP``);
- ``host_dtype``: float64 for host-side unit conversions and analytic
  solutions;
- ``map_dtype``: geometry-map code per site (uint8);
- ``index_dtype``: int64 - site offsets of a 512^3 D3Q27 state exceed
  2^31, so the kernels index with 64-bit offsets.
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
