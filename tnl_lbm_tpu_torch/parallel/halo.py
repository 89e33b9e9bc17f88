"""The collective halo pad of the plain sharded step (counterpart of
``tnl_lbm_tpu/parallel/halo.py``; reference DistributedNDArraySynchronizer,
lbm_block.hpp:410-473, lbm.hpp:195-280).

One block per shard; every spatial axis gets a 1-wide halo from the
neighbour shards' face slabs (slice copies: peer copies across cards,
plain copies on one device), the axes one after the other so that edges
and corners route through the earlier axes' halos.  Non-periodic domain
faces replicate the edge layer, as the one-device step's ``pad_halo``
does (the reference's index clamping, kernels.h:50-55).
"""

from __future__ import annotations

import numpy as np

from tnl_lbm_tpu_torch.parallel.sharded import ShardPlan, _fill_halos, padded_buffers


def make_halo_pad(plan: ShardPlan, periodic, lat=None):
    """``pad(blocks, comps="all") -> padded blocks``: each shard's [Q, *S_local]
    block with a 1-wide halo on every spatial axis, a collective over all
    shards' blocks (JAX ``make_halo_pad``).

    With ``lat`` given, ``comps`` picks the components a face takes from its
    neighbour (the reference's ``df_sync_directions``, defs.h:307-340):
    "own" (pull streaming) the low halo of axis a for c_a = +1 and the high
    one for c_a = -1, 9 of 27 per face; "opp" (the A-A odd read) the other
    way round; "all" everything.  The components a face does not take hold
    the block's edge layer; no pull reads them."""
    periodic = tuple(periodic)
    axes = tuple(range(len(periodic)))
    c = None if lat is None else np.asarray(lat.c)

    def pad(blocks, comps: str = "all"):
        select = None
        if c is not None and comps in ("own", "opp"):
            sign = 1 if comps == "own" else -1

            def select(a, side):
                want = sign if side < 0 else -sign
                return [q for q in range(len(c)) if int(c[q][a]) == want]

        bufs = padded_buffers(blocks, 1, axes)
        return _fill_halos(plan, blocks, bufs, 1, axes, periodic, comps=select)

    return pad
