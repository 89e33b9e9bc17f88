"""Sparse structure builders for the IBM solver (counterpart of
``tnl_lbm_tpu/ibm/sparse.py``: the same arrays in the same order).

The Lagrangian cloud is static, so all structure is built once: the unique
stencil nodes, the neighbour pairs of a bucket-grid search - O(m *
neighbours), no m^2 anything - and the ELLPACK packing of pair values.
The per-step solve (``ibm/lagrange.py``) then runs over these arrays on
the device.

Key reduction (dense clouds): with W the [m, u] interpolation matrix over
the u UNIQUE stencil nodes, the velocity-correction system
``(W W^T) x = b`` only ever feeds the physics through ``y = W^T x``, and
``y = W^T (W W^T)^+ b = (W^T W)^+ W^T b`` (Moore-Penrose identity).  When
points are denser than the lattice the node-space Gram ``B = W^T W`` is a
small dense SPD matrix and the whole per-step solve is [u, u] matmuls.

``neighbor_pairs`` runs on the device it is given, in chunks of at most
``chunk`` candidate pairs: the JAX function materialises every candidate
on the host at once (up to 3e8 int64 pairs and their float64 differences).
"""

from __future__ import annotations

import numpy as np
import torch


def unique_nodes(nodes: np.ndarray, shape) -> tuple[np.ndarray, np.ndarray]:
    """Deduplicate clipped stencil nodes.

    nodes: [m, s3, 3] integer lattice coordinates (may exceed the grid;
    clipped to ``shape`` exactly like interpolate/spread do).
    Returns (uflat [u] int32 flat grid ids sorted ascending,
             uid [m, s3] int32 index into uflat per stencil slot).
    """
    nx, ny, nz = shape
    ix = np.clip(nodes[..., 0], 0, nx - 1)
    iy = np.clip(nodes[..., 1], 0, ny - 1)
    iz = np.clip(nodes[..., 2], 0, nz - 1)
    flat = (ix.astype(np.int64) * ny + iy) * nz + iz
    uflat, inv = np.unique(flat.reshape(-1), return_inverse=True)
    return uflat.astype(np.int32), inv.reshape(flat.shape).astype(np.int32)


def neighbor_pairs(pts: np.ndarray, radius: float, max_candidates: int = 300_000_000,
                   device="cpu", chunk: int = 1 << 24) -> tuple[np.ndarray, np.ndarray]:
    """All ordered pairs (k, l) with per-dim |pts[k] - pts[l]| < radius
    (Chebyshev metric - separable dirac kernels have box support).

    Bucket-grid search: cells of edge ``radius``; candidates are the 27
    surrounding cells, each run of equal cell ids found by sort +
    searchsorted.  Includes the diagonal (k, k).  Raises MemoryError when
    the candidates number more than ``max_candidates``, as the JAX
    function does (the IBM build's operator choice depends on it).
    Returns (ks, ls) int32 arrays in the JAX function's order: by offset
    (ox, oy, oz), then by sorted k, then along each run.
    """
    dev = torch.device(device)
    p = torch.as_tensor(np.asarray(pts, np.float64), device=dev)
    m = len(p)
    cell = torch.floor(p / radius).to(torch.int64)
    cell -= cell.min(dim=0).values
    # linear cell ids with every id-space dim >= 3: the 27 neighbour offsets
    # (ox*D1 + oy)*D2 + oz with digits in {-1,0,1} are then pairwise
    # DISTINCT, so no true pair is emitted twice.  Wrap-around candidates
    # at the id-space edges are false neighbours only - the exact Chebyshev
    # filter removes them.
    dims = torch.clamp_min(cell.max(dim=0).values + 1, 3).tolist()
    cid = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    order = torch.argsort(cid, stable=True)
    cid_s = cid[order]

    runs, total = [], 0
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                tgt = cid_s + ((ox * dims[1] + oy) * dims[2] + oz)
                lo = torch.searchsorted(cid_s, tgt)
                cnt = torch.searchsorted(cid_s, tgt, right=True) - lo
                total += int(cnt.sum())
                if total > max_candidates:
                    raise MemoryError(
                        f"neighbor search: >{max_candidates} candidate pairs "
                        f"(radius {radius}, m={m}) - cloud too dense for this "
                        f"radius")
                runs.append((lo, cnt))

    ks_all, ls_all = [], []
    rows = torch.arange(m, device=dev)
    for lo, cnt in runs:
        ends = torch.cumsum(cnt, 0)
        start = 0
        while start < m:
            # the sorted rows start..stop-1 hold at most `chunk` candidates
            base = int(ends[start - 1]) if start else 0
            stop = max(int(torch.searchsorted(ends, base + chunk, right=True)), start + 1)
            c = cnt[start:stop]
            n = int(c.sum())
            ks = torch.repeat_interleave(rows[start:stop], c, output_size=n)
            first = torch.cumsum(c, 0) - c
            ls = (torch.repeat_interleave(lo[start:stop] - first, c, output_size=n)
                  + torch.arange(n, device=dev))
            d = p[order[ks]] - p[order[ls]]
            keep = (torch.abs(d) < radius).all(dim=1)
            ks_all.append(order[ks[keep]])
            ls_all.append(order[ls[keep]])
            start = stop
    ks = torch.cat(ks_all).to(torch.int32).cpu().numpy()
    ls = torch.cat(ls_all).to(torch.int32).cpu().numpy()
    return ks, ls


def pack_ellpack(ks: np.ndarray, ls: np.ndarray, vals: np.ndarray, m: int,
                 drop_below: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """Pack COO (ks, ls, vals) rows into padded ELLPACK.

    Returns (idx [m, nmax] int32, val [m, nmax] float32); padding entries
    point at row 0 with value 0 (harmless in a gather-matvec).  Entries
    with |val| <= drop_below are dropped (exact zeros from points at the
    support boundary never affect the matvec).
    """
    keep = np.abs(vals) > drop_below
    ks, ls, vals = ks[keep], ls[keep], vals[keep]
    order = np.argsort(ks, kind="stable")
    ks, ls, vals = ks[order], ls[order], vals[order]
    counts = np.bincount(ks, minlength=m)
    nmax = max(1, int(counts.max()) if len(counts) else 1)
    idx = np.zeros((m, nmax), np.int32)
    val = np.zeros((m, nmax), np.float32)
    row_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(ks)) - row_start[ks]
    idx[ks, slot] = ls
    val[ks, slot] = vals
    return idx, val
