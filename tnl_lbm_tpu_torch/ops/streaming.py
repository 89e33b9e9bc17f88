"""Streaming as whole-array shifts (counterpart of ``tnl_lbm_tpu/ops/streaming.py``).

- ``f`` has shape [Q, *S]; a padded array ``fpad`` has shape [Q, *(S+2)].
- pull: f_in[q](x) = f[q](x - c_q)   (A-B streaming / A-A odd write)
- A-A odd read: f_in[q](x) = f[opp q](x - c_q)  (``pull_from`` with opp)
- outflow pulls at the +x boundary: ``pull_shift_x`` (OUTFLOW_RIGHT) and
  ``pull_interp_right`` (OUTFLOW_RIGHT_INTERP)
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


def pull_shift_x(lat: LatticeDescriptor, fpad: torch.Tensor, shape, dx: int = -1,
                 src_perm=None) -> torch.Tensor:
    """Pull with the x-offset fixed to ``dx`` for every direction: the
    GEO_OUTFLOW_RIGHT trick ``xp = x = xm`` (reference d3q27/bc.h:64-65),
    every direction pulled from x+dx, y-c_y, z-c_z.  ``src_perm`` permutes
    the source direction as in :func:`pull_from` (``lat.opp``: the A-A odd
    step's outflow read)."""
    out = []
    for q in range(lat.Q):
        off = [-int(c) for c in lat.c[q]]
        off[0] = dx
        src = q if src_perm is None else int(src_perm[q])
        out.append(_shift_slices(fpad[src], off, shape))
    return torch.stack(out)


#: speed of sound used by the interpolated outflow (reference streaming_AB.h:214)
SPEED_OF_SOUND = 0.5773502691896257


def pull_interp_right(lat: LatticeDescriptor, fpad: torch.Tensor, shape) -> torch.Tensor:
    """Geier (2015) speed-of-sound interpolated outflow at the +x boundary:
    directions with c_x >= 0 stream normally; the incoming ones (c_x = -1)
    blend x-1 and x instead of reading the missing x+1 neighbour
    (reference streaming_AB.h:209-242)."""
    cs = SPEED_OF_SOUND
    out = []
    for q in range(lat.Q):
        off = [-int(c) for c in lat.c[q]]
        if int(lat.c[q][0]) == -1:
            off_a, off_b = list(off), list(off)
            off_a[0], off_b[0] = -1, 0
            out.append(cs * _shift_slices(fpad[q], off_a, shape)
                       + (1 - cs) * _shift_slices(fpad[q], off_b, shape))
        else:
            out.append(_shift_slices(fpad[q], off, shape))
    return torch.stack(out)
