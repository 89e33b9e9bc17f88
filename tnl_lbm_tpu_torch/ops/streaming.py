"""Streaming as whole-array shifts (counterpart of ``tnl_lbm_tpu/ops/streaming.py``).

- ``f`` has shape [Q, *S]; a padded array ``fpad`` has shape [Q, *(S+2)].
- pull: f_in[q](x) = f[q](x - c_q)   (A-B streaming / A-A odd write)
- A-A odd read: f_in[q](x) = f[opp q](x - c_q)  (``pull_from`` with opp)
"""

from __future__ import annotations

import torch

from tnl_lbm_tpu_torch.models import LatticeDescriptor


def pad_halo(f: torch.Tensor, periodic: tuple[bool, ...]) -> torch.Tensor:
    """Pad a 1-wide halo on every spatial axis of ``f [Q, *S]``.

    Periodic axes wrap; non-periodic axes replicate the edge value, which
    reproduces the reference's index clamping at the global boundary
    (reference kernels.h:50-55).
    """
    for axis, per in enumerate(periodic):
        dim = axis + 1
        n = f.shape[dim]
        if per:
            lo, hi = f.narrow(dim, n - 1, 1), f.narrow(dim, 0, 1)
        else:
            lo, hi = f.narrow(dim, 0, 1), f.narrow(dim, n - 1, 1)
        f = torch.cat([lo, f, hi], dim=dim)
    return f


def _shift_slices(fpad_q: torch.Tensor, offsets, shape) -> torch.Tensor:
    """Slice a padded [*(S+2)] array at halo offset: out(x) = fpad(x + 1 + off)."""
    index = tuple(slice(1 + o, 1 + o + n) for o, n in zip(offsets, shape))
    return fpad_q[index]


def pull(lat: LatticeDescriptor, fpad: torch.Tensor, shape) -> torch.Tensor:
    """Pull streaming: f_in[q](x) = f[q](x - c_q)."""
    return torch.stack([
        _shift_slices(fpad[q], [-int(c) for c in lat.c[q]], shape) for q in range(lat.Q)
    ])


def pull_from(lat: LatticeDescriptor, fpad: torch.Tensor, shape, src_perm) -> torch.Tensor:
    """Pull with a source-direction permutation: f_in[q](x) = f[perm[q]](x - c_q).

    With ``src_perm = lat.opp`` this is the A-A odd-step read
    (reference streaming_AA.h:86-115).
    """
    return torch.stack([
        _shift_slices(fpad[int(src_perm[q])], [-int(c) for c in lat.c[q]], shape)
        for q in range(lat.Q)
    ])
