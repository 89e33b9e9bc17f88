"""Bandwidth probes of the A-A kernels: CUDA on CUDA tensors, plain PyTorch on CPU tensors.

Counterparts of the Pallas probes in ``scripts/profile_floor.py`` (P1),
``scripts/probe_pair2_pipeline.py`` (P2), ``scripts/probe_element_pipeline.py``
(P3) and ``scripts/probe_dma_align.py`` (P4), at any shape the kernels'
tiles divide (the scripts fix 256^3).  The kernels are in
``csrc/probes.cu``; each has its plain version here, the CPU path and the
oracle it is held against on the card.

- :func:`copy_permute` (P1): the even step's I/O with no collision, the
  card's copy floor for the A-A kernels.
- :func:`pair_pipeline` (P2a): the one-kernel pair's x-march (its 8x32
  column tiles, x segments and one-site halo windows, each window plane
  loaded once a segment) with an affine map in place of the collisions: its
  memory half, through one of three load paths (``PIPELINE_LOADS``).
- :func:`pair_compute_only` (P2b): the affine passes on every site of the
  march's column tiles and x segments, only the first tile's first segment
  (``first_block``) loaded and stored: the march's compute half, on P2a's
  decomposition.
- :func:`element_pipeline` (P3): overlapping halo windows of a padded
  state, each window plane loaded once by TMA into a ring of plane buffers
  as blocks march along x, the affine passes on each tile's interior: do
  copies and compute overlap?
- :func:`window_copy` (P4): window copies at y offsets into shared memory
  at a row offset, the interior tile written out, through 4-byte or
  16-byte ``cp.async`` or TMA bulk copies, pipelined through a ring of
  plane buffers (:func:`window_stages` of them).

``KERNELS`` holds one launch count per probe (P2a, P4: per load path).
"""

from __future__ import annotations

import ctypes

import torch

from tnl_lbm_tpu_torch.kernels.build import load_library
from tnl_lbm_tpu_torch.kernels.fused import CudaKernel, _periodic_bits
from tnl_lbm_tpu_torch.kernels.fused_aa import PAIR_COLUMN

Q = 27
#: the march's x segment (csrc/pair_march.cuh SEG_MAX): P2b's items are its
#: column tiles (``PAIR_COLUMN``) over segments of this many planes
PAIR_SEG_MAX = 32
#: keys of :func:`compute_only_geometry` (csrc/probes.cu tnl_lbm_pair_compute_only_info)
_COMPUTE_ONLY_KEYS = ("threads", "smem_bytes", "seg_len", "segments", "columns", "units",
                      "blocks", "blocks_per_sm")
#: P2a's load paths -> the ``load`` code of ``tnl_lbm_pair_pipeline``
#: (csrc/probes.cu p2a::LOAD_*) and the launch counter: the pair's staged rows,
#: global reads by the window threads, a producer warp's TMA plane ring
PIPELINE_LOADS = {"stages": (0, "pair_pipeline_stages"), "direct": (1, "pair_pipeline_direct"),
                  "ring": (2, "pair_pipeline_ring")}
#: P2a's default load path: the fastest at 256^3 and 20 passes on the card
#: (PERF.md section 6)
PIPELINE_DEFAULT = "stages"
#: keys of :func:`pipeline_geometry` (csrc/probes.cu tnl_lbm_pair_pipeline_info)
_PIPELINE_KEYS = ("smem_bytes", "threads", "seg_len", "segments", "columns", "plane_buffers",
                  "boxed_columns")
#: the bench duct's periodic axes (x only), for the P2a halo
_BENCH_PERIODIC_BITS = _periodic_bits((True, False, False))

KERNELS = {
    "copy_permute": CudaKernel("copy_permute", "tnl_lbm_tpu_torch/csrc/probes.cu",
                               "scripts/profile_floor.py:36"),
    **{name: CudaKernel(name, "tnl_lbm_tpu_torch/csrc/probes.cu",
                        "scripts/probe_pair2_pipeline.py:73")
       for _, name in PIPELINE_LOADS.values()},
    "pair_compute_only": CudaKernel("pair_compute_only", "tnl_lbm_tpu_torch/csrc/probes.cu",
                                    "scripts/probe_pair2_pipeline.py:151"),
    "element_pipeline": CudaKernel("element_pipeline", "tnl_lbm_tpu_torch/csrc/probes.cu",
                                   "scripts/probe_element_pipeline.py:32"),
    "window_copy": CudaKernel("window_copy", "tnl_lbm_tpu_torch/csrc/probes.cu",
                              "scripts/probe_dma_align.py:50"),
    "window_copy_ld4": CudaKernel("window_copy_ld4", "tnl_lbm_tpu_torch/csrc/probes.cu",
                                  "scripts/probe_dma_align.py:50"),
    "window_copy_ld16": CudaKernel("window_copy_ld16", "tnl_lbm_tpu_torch/csrc/probes.cu",
                                   "scripts/probe_dma_align.py:50"),
}

#: scripts/probe_element_pipeline.py main()'s variants: (tx, ty, passes)
ELEMENT_VARIANTS = ((8, 32, 0), (8, 32, 20), (8, 32, 60), (16, 32, 0))
#: the padded state's ring (scripts/probe_element_pipeline.py and
#: probe_dma_align.py): interior at x origin 2 and y origin 8
X_ORG, Y_ORG = 2, 8
#: scripts/probe_dma_align.py's tile
DMA_TX, DMA_TY = 16, 32
#: scripts/probe_dma_align.py main()'s variants: (y_off, wy, label, dst_off)
DMA_VARIANTS = (
    (0, DMA_TY + 16, "aligned start, ty+16 (status quo)", 0),
    (6, DMA_TY + 8, "start+6 (unaligned), ty+8", 0),
    (6, DMA_TY + 4, "start+6 (unaligned), ty+4 (ragged size)", 0),
    (8, DMA_TY + 8, "aligned start+8, ty+8 (control)", 0),
    (6, DMA_TY + 4, "start+6 -> dst+6 (congruent), ty+4", 6),
    (6, DMA_TY + 8, "start+6 -> dst+6 (congruent), ty+8", 6),
    (2, DMA_TY + 4, "start+2 -> dst+2 (congruent), ty+4", 2),
)
#: window_copy's load paths -> the ``load`` code of ``tnl_lbm_window_copy``
#: and the launch counter
LOADS = {"ld4": (0, "window_copy_ld4"), "ld16": (1, "window_copy_ld16"),
         "tma": (2, "window_copy")}
#: x planes of output one element_pipeline block marches over, in whole tiles
ELEMENT_SEG_PLANES = 32
#: element_pipeline's ring: at most this many plane buffers (csrc/probes.cu
#: ESTAGES_MAX), within the window probes' 200 KB of shared memory a block
ELEMENT_STAGES_MAX = 4
_WINDOW_SMEM = 200 * 1024


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


def pipeline_geometry(shape, load: str = PIPELINE_DEFAULT) -> dict:
    """P2a's launch for a [27, *shape] state (CUDA only): shared memory and
    threads per block, the x segment and the segments, the column tiles, the
    plane buffers in flight and the columns the ring loads as tensor boxes."""
    code, _ = _pipeline_load(load)
    out = (ctypes.c_int * len(_PIPELINE_KEYS))()
    rc = load_library().tnl_lbm_pair_pipeline_info(code, *shape, out)
    if rc != 0:
        raise RuntimeError(f"tnl_lbm_pair_pipeline_info failed: CUDA error {rc}")
    return dict(zip(_PIPELINE_KEYS, out))


def _pipeline_load(load: str):
    if load not in PIPELINE_LOADS:
        raise ValueError(f"load must be one of {sorted(PIPELINE_LOADS)}, got {load!r}")
    return PIPELINE_LOADS[load]


def pair_pipeline(f, passes: int, load: str = PIPELINE_DEFAULT):
    """P2a: the pair's x-march over ``f``'s column tiles and x segments,
    every window plane in once, ``affine`` on the tiles' interiors, the
    interiors out -> the new state.  The halo wraps along x and clamps
    along y and z, as the pair's does on the bench duct.  ``load`` picks the
    load path of ``PIPELINE_LOADS`` ("stages" and "ring" need Z % 4 == 0 and
    a 16-byte aligned state); the result does not depend on it."""
    X, Y, Z = _check(f)
    code, name = _pipeline_load(load)
    if f.device.type != "cuda":
        return pair_pipeline_plain(f, passes)
    if load != "direct" and (Z % 4 or f.data_ptr() % 16):
        raise ValueError(f"the {load!r} load path needs Z % 4 == 0 and a 16-byte aligned state")
    fout = torch.empty_like(f)
    rc = load_library().tnl_lbm_pair_pipeline(f.data_ptr(), fout.data_ptr(), X, Y, Z,
                                              _BENCH_PERIODIC_BITS, int(passes), code,
                                              _stream(f))
    _launched(name, rc)
    return fout


def first_block(shape) -> tuple[int, int, int]:
    """Extent of P2b's first item, the only one loaded and stored: the first
    column tile's first x segment, clipped to the domain."""
    return tuple(min(t, n) for t, n in zip((PAIR_SEG_MAX,) + PAIR_COLUMN, shape))


def compute_only_geometry(shape) -> dict:
    """P2b's launch for a [27, *shape] state (CUDA only): threads and shared
    memory per block, the x segment and segments, the column tiles, the
    units (column tile planes) its persistent grid splits, the blocks and
    the blocks resident an SM."""
    out = (ctypes.c_int * len(_COMPUTE_ONLY_KEYS))()
    rc = load_library().tnl_lbm_pair_compute_only_info(*shape, out)
    if rc != 0:
        raise RuntimeError(f"tnl_lbm_pair_compute_only_info failed: CUDA error {rc}")
    return dict(zip(_COMPUTE_ONLY_KEYS, out))


def pair_compute_only_plain(f, passes: int):
    bx, by, bz = first_block(tuple(f.shape[1:]))
    return affine(f[:, :bx, :by, :bz], passes).contiguous()


def pair_compute_only(f, passes: int):
    """P2b: ``affine`` on every site of the march's column tiles and x
    segments, but only the first item's sites are loaded and stored -> those,
    ``[27, *first_block(shape)]``.  On the card a persistent grid splits the
    column tile planes evenly over the resident blocks; the other sites
    compute on what their shared-memory slots hold."""
    X, Y, Z = _check(f)
    if f.device.type != "cuda":
        return pair_compute_only_plain(f, passes)
    tile = torch.empty((Q,) + first_block((X, Y, Z)), dtype=f.dtype, device=f.device)
    rc = load_library().tnl_lbm_pair_compute_only(f.data_ptr(), tile.data_ptr(), X, Y, Z,
                                                  int(passes), _stream(f))
    _launched("pair_compute_only", rc)
    return tile


def _padded(fpad: torch.Tensor) -> tuple[int, int, int]:
    """(X, Y, Z) of a padded [27, X+4, Y+16, Z] float32 state."""
    if (fpad.dtype != torch.float32 or fpad.dim() != 4 or fpad.shape[0] != Q
            or not fpad.is_contiguous() or fpad.shape[1] <= 4 or fpad.shape[2] <= 16):
        raise ValueError(f"fpad must be a contiguous float32 [{Q}, X+4, Y+16, Z] tensor")
    return fpad.shape[1] - 4, fpad.shape[2] - 16, fpad.shape[3]


def interior(fpad: torch.Tensor) -> torch.Tensor:
    """The interior [27, X, Y, Z] view of a padded state."""
    X, Y, _ = _padded(fpad)
    return fpad[:, X_ORG : X_ORG + X, Y_ORG : Y_ORG + Y]


def element_geometry(tx: int, ty: int, X: int, Z: int) -> dict:
    """element_pipeline's launch: tiles per x segment (ELEMENT_SEG_PLANES
    planes, at least one tile), segments, plane buffers in the ring (as
    many (ty+16) Z planes as fit 200 KB, 2 to ELEMENT_STAGES_MAX) and the
    bytes of one plane."""
    plane = (ty + 16) * Z * 4
    stages = min(ELEMENT_STAGES_MAX, _WINDOW_SMEM // plane)
    if Z % 4 or stages < 2:
        raise ValueError(f"element_pipeline needs Z % 4 == 0 and two ({ty + 16}, {Z}) window "
                         f"planes within {_WINDOW_SMEM} bytes; got Z = {Z}")
    seg_tiles = max(1, ELEMENT_SEG_PLANES // tx)
    return {"seg_tiles": seg_tiles, "segments": -(-(X // tx) // seg_tiles), "stages": stages,
            "plane_bytes": plane}


def _element_check(fpad, tx, ty):
    X, Y, Z = _padded(fpad)
    if tx <= 0 or ty <= 0 or X % tx or Y % ty:
        raise ValueError(f"the ({tx}, {ty}) tiles must divide X = {X}, Y = {Y}")
    return X, Y, Z


def element_pipeline_plain(fpad, tx: int, ty: int, passes: int):
    _element_check(fpad, tx, ty)
    out = torch.empty_like(fpad)
    interior(out)[...] = affine(interior(fpad), passes)
    return out


def element_pipeline(fpad, tx: int, ty: int, passes: int):
    """P3: ``out[:, 2:X+2, 8:Y+8, :] = affine(fpad[same], passes)`` tile by
    tile from each tile's (tx+4, ty+16) window, into a new
    [27, X+4, Y+16, Z] tensor whose ring is left unwritten (``torch.empty``),
    as the Pallas kernel leaves it: compare ``interior(out)`` only.  On the
    card each block marches over ``element_geometry``'s x segment of a
    column of tiles, its window planes loaded once each by TMA."""
    X, Y, Z = _element_check(fpad, tx, ty)
    if fpad.device.type != "cuda":
        return element_pipeline_plain(fpad, tx, ty, passes)
    geo = element_geometry(tx, ty, X, Z)
    if fpad.data_ptr() % 16:
        raise ValueError("element_pipeline needs a 16-byte aligned state")
    out = torch.empty_like(fpad)
    rc = load_library().tnl_lbm_element_pipeline(fpad.data_ptr(), out.data_ptr(), X, Y, Z, tx,
                                                 ty, geo["seg_tiles"], geo["stages"],
                                                 int(passes), _stream(fpad))
    _launched("element_pipeline", rc)
    return out


def window_covers(y_off: int, wy: int, dst_off: int) -> bool:
    """Whether the window of ``scripts/probe_dma_align.py make_copy`` holds
    its tile's interior rows: they are read at scratch rows
    ``dst_off + 8 - y_off`` up to ``+ TY``, and the copy fills rows
    ``dst_off`` up to ``dst_off + wy``."""
    yo = dst_off + Y_ORG - y_off
    return dst_off <= yo and yo + DMA_TY <= dst_off + wy


def _window_check(fpad, y_off, wy, dst_off):
    X, Y, Z = _padded(fpad)
    if X % DMA_TX or Y % DMA_TY:
        raise ValueError(f"the ({DMA_TX}, {DMA_TY}) tiles must divide X = {X}, Y = {Y}")
    if dst_off < 0 or y_off < 0 or y_off + wy > DMA_TY + 2 * Y_ORG:
        raise ValueError(f"window (y_off={y_off}, wy={wy}) leaves the padded state")
    if not window_covers(y_off, wy, dst_off):
        raise ValueError(
            f"window (y_off={y_off}, wy={wy}, dst_off={dst_off}) does not cover its tile: the "
            f"interior rows {dst_off + Y_ORG - y_off}..{dst_off + Y_ORG - y_off + DMA_TY} of "
            f"the buffer, the copy fills {dst_off}..{dst_off + wy}; the Pallas probe reads the "
            f"rest from stale scratch (ROADMAP C, P4 variant 7)")
    return X, Y, Z


def window_copy_plain(fpad, y_off: int, wy: int, dst_off: int = 0):
    _window_check(fpad, y_off, wy, dst_off)
    return interior(fpad).contiguous()


def window_stages(Z: int, wy: int, dst_off: int = 0) -> int:
    """The plane buffers of one window_copy block (CUDA only): as many as
    fit in 200 KB of shared memory (one block per SM), 2 to 4."""
    return load_library().tnl_lbm_window_copy_stages(Z, wy, dst_off)


def window_copy(fpad, y_off: int, wy: int, dst_off: int = 0, load: str = "tma"):
    """P4: each [27, TX+4, wy, Z] window from y row ``j TY + y_off`` copied
    into shared memory at row ``dst_off``, its interior tile written out ->
    ``fpad[:, 2:X+2, 8:Y+8, :]`` as a new [27, X, Y, Z] tensor.  ``load``:
    "ld4" (4-byte ``cp.async``), "ld16" (16-byte ``cp.async``) or "tma" (one
    bulk copy per window plane), each plane's copy in flight while earlier
    planes are stored.  A window that does not cover its tile raises (never
    read from stale shared memory)."""
    X, Y, Z = _window_check(fpad, y_off, wy, dst_off)
    if load not in LOADS:
        raise ValueError(f"load must be one of {sorted(LOADS)}, got {load!r}")
    if fpad.device.type != "cuda":
        return window_copy_plain(fpad, y_off, wy, dst_off)
    if Z % 4 or fpad.data_ptr() % 16:
        raise ValueError("window_copy needs Z % 4 == 0 and a 16-byte aligned state")
    code, name = LOADS[load]
    out = torch.empty((Q, X, Y, Z), dtype=fpad.dtype, device=fpad.device)
    rc = load_library().tnl_lbm_window_copy(fpad.data_ptr(), out.data_ptr(), X, Y, Z, y_off, wy,
                                            dst_off, code, _stream(fpad))
    _launched(name, rc)
    return out
