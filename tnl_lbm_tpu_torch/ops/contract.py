"""Exact unrolled lattice contractions.

Counterpart of ``tnl_lbm_tpu/ops/contract.py``.  Every lattice-coefficient
contraction (c.u, momentum, moment masks) has coefficients in {-1, 0, +1}
or small rationals, so it is written as an unrolled sum of +-terms - the
same arithmetic as the reference's generated CUDA and as this package's
kernels - never as a matmul, whose reduced-precision modes (TF32 on the
card) would round the inputs.
"""

from __future__ import annotations

import numpy as np
import torch


def lattice_dot(coef, arr) -> torch.Tensor:
    """``out[r] = sum_i coef[r, i] * arr[i]`` with the loops unrolled in Python.

    ``coef`` is a static [R, I] array (numpy / nested lists); ``arr`` is an
    [I, *S] tensor or a length-I sequence of [*S] tensors.  Zero
    coefficients are skipped, +-1 become adds/subtracts, other scalars
    multiply as Python floats.
    """
    coef = np.asarray(coef, np.float64)
    squeeze = coef.ndim == 1
    if squeeze:
        coef = coef[None]
    rows = []
    for r in range(coef.shape[0]):
        acc = None
        for i in range(coef.shape[1]):
            c = float(coef[r, i])
            if c == 0.0:
                continue
            term = arr[i] if c == 1.0 else (-arr[i] if c == -1.0 else c * arr[i])
            acc = term if acc is None else acc + term
        rows.append(torch.zeros_like(arr[0]) if acc is None else acc)
    if squeeze:
        return rows[0]
    return torch.stack(rows)
