"""Bandwidth probes of the A-A kernels: CUDA on CUDA tensors, plain PyTorch on CPU tensors.

Counterparts of the Pallas probes in ``scripts/profile_floor.py`` (P1) and
``scripts/probe_pair2_pipeline.py`` (P2), at any shape (the scripts fix
256^3).  The kernels are in ``csrc/probes.cu``; each has its plain version
here, the CPU path and the oracle it is held against on the card.

- :func:`copy_permute` (P1): the even step's I/O with no collision, the
  card's copy floor for the A-A kernels.
- :func:`pair_pipeline` (P2a): the one-kernel pair's tiles and halo windows
  with an affine map in place of the collisions: its memory half.
- :func:`pair_compute_only` (P2b): the same grid and arithmetic with only
  block 0's window loaded and only its tile stored: its compute half.

``KERNELS`` holds one launch count per probe.
"""

from __future__ import annotations

import ctypes

import torch

from tnl_lbm_tpu_torch.kernels.build import load_library
from tnl_lbm_tpu_torch.kernels.fused import CudaKernel, _periodic_bits
from tnl_lbm_tpu_torch.kernels.fused_aa import PAIR_TILE

Q = 27
#: the bench duct's periodic axes (x only), for the P2a halo
_BENCH_PERIODIC_BITS = _periodic_bits((True, False, False))

KERNELS = {
    "copy_permute": CudaKernel("copy_permute", "tnl_lbm_tpu_torch/csrc/probes.cu",
                               "scripts/profile_floor.py:36"),
    "pair_pipeline": CudaKernel("pair_pipeline", "tnl_lbm_tpu_torch/csrc/probes.cu",
                                "scripts/probe_pair2_pipeline.py:73"),
    "pair_compute_only": CudaKernel("pair_compute_only", "tnl_lbm_tpu_torch/csrc/probes.cu",
                                    "scripts/probe_pair2_pipeline.py:151"),
}


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _check(f: torch.Tensor) -> tuple[int, int, int]:
    if f.dtype != torch.float32 or f.dim() != 4 or f.shape[0] != Q or not f.is_contiguous():
        raise ValueError(f"f must be a contiguous float32 [{Q}, X, Y, Z] tensor")
    return tuple(f.shape[1:])


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    KERNELS[name].launches += 1


def _stream(f):
    return ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)


def affine(x: torch.Tensor, passes: int) -> torch.Tensor:
    """``passes`` rounds of x * 1.000001 + 1e-12, each rounded twice."""
    for _ in range(passes):
        x = x * 1.000001 + 1e-12
    return x


def copy_permute_plain(f, with_macro: bool = True):
    rows = f.flip(0)
    s = rows[0]
    for q in range(1, Q):
        s = s + rows[q]
    if not with_macro:
        return rows.contiguous(), None, None
    return rows.contiguous(), s, torch.stack([s, s, s])


def copy_permute(f, with_macro: bool = True):
    """P1: ``fout[q] = f[Q-1-q]``, rho = the sum of the rows of fout in
    order, u = (rho, rho, rho) -> (fout, rho, u)."""
    X, Y, Z = _check(f)
    if f.device.type != "cuda":
        return copy_permute_plain(f, with_macro)
    fout = torch.empty_like(f)
    rho = torch.empty((X, Y, Z), dtype=f.dtype, device=f.device) if with_macro else None
    u = torch.empty((3, X, Y, Z), dtype=f.dtype, device=f.device) if with_macro else None
    rc = load_library().tnl_lbm_copy_permute(
        f.data_ptr(), fout.data_ptr(), rho.data_ptr() if with_macro else None,
        u.data_ptr() if with_macro else None, X, Y, Z, int(with_macro), _stream(f))
    _launched("copy_permute", rc)
    return fout, rho, u


def pair_pipeline_plain(f, passes: int):
    return affine(f, passes)


def pair_pipeline(f, passes: int):
    """P2a: every tile's halo window in, ``affine`` on the interior, the
    interior out -> the new state.  The halo wraps along x and clamps along
    y and z, as the pair's does on the bench duct."""
    X, Y, Z = _check(f)
    if f.device.type != "cuda":
        return pair_pipeline_plain(f, passes)
    fout = torch.empty_like(f)
    rc = load_library().tnl_lbm_pair_pipeline(f.data_ptr(), fout.data_ptr(), X, Y, Z,
                                              _BENCH_PERIODIC_BITS, int(passes), _stream(f))
    _launched("pair_pipeline", rc)
    return fout


def first_block(shape) -> tuple[int, int, int]:
    """Extent of the pair kernel's block 0: its tile, clipped to the domain."""
    return tuple(min(t, n) for t, n in zip(PAIR_TILE, shape))


def pair_compute_only_plain(f, passes: int):
    bx, by, bz = first_block(tuple(f.shape[1:]))
    return affine(f[:, :bx, :by, :bz], passes).contiguous()


def pair_compute_only(f, passes: int):
    """P2b: the pair grid runs ``affine`` on every tile, but only block 0
    loads its window and stores its tile -> that tile,
    ``[27, *first_block(shape)]``."""
    X, Y, Z = _check(f)
    if f.device.type != "cuda":
        return pair_compute_only_plain(f, passes)
    tile = torch.empty((Q,) + first_block((X, Y, Z)), dtype=f.dtype, device=f.device)
    rc = load_library().tnl_lbm_pair_compute_only(f.data_ptr(), tile.data_ptr(), X, Y, Z,
                                                  int(passes), _stream(f))
    _launched("pair_compute_only", rc)
    return tile
