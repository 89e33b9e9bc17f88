"""The sharded lattice in one process (counterpart of ``tnl_lbm_tpu/parallel/sharded.py``).

The JAX package decomposes the lattice over a ``jax.sharding.Mesh``: the
spatial axes of the [Q, X, Y, Z] state shard over the mesh axes, and each
step runs under ``shard_map`` with ``lax.ppermute`` halo exchange (the
reference's multi-block ``LBM`` and its MPI synchronizers, lbm.h:7-105,
lattice_decomposition.h).  The port keeps that design in one process:

- a :class:`Mesh` is a grid of torch devices with one name per axis, in
  which a device may appear more than once: the tests run N shards on N x
  ``cpu`` and ``chip_smoke.py`` on N x ``cuda:0``, as the JAX tests run on
  virtual CPU devices, so that an N-shard run is held against the one-shard
  run on one device;
- a :class:`ShardPlan` maps each lattice axis to a mesh axis or to none;
- a :class:`ShardedField` holds one block per shard, each on its shard's
  device (the counterpart of a ``NamedSharding``'d array);
- the halo exchange is a set of slice copies between the blocks: peer
  copies across cards, plain copies on one device.

The steps:

- :func:`make_sharded_step`, the plain step per shard (``sim/step.py``'s
  two stages, each after the halo pad of ``parallel/halo.py`` over every
  shard's block): the CPU path and the oracle of the kernels' sharded
  steps;
- :func:`make_sharded_fused_step`, the A-B step (B4) on each shard's block
  with a 1-wide x/y halo;
- :func:`make_sharded_fused_step_aa`, the A-A steps: the even step (B2) on
  each shard's block as it is (same-site), the odd step (B3) on the block
  with a 2-wide x/y halo and its map with a 1-wide ring;
- :func:`_make_uneven_sharded_step`, pad-and-crop for a lattice the mesh
  does not divide (A-B only, as in the JAX package).

What is not ported yet raises naming its ROADMAP item: the sharded pair,
z-sharded meshes on the kernels, the 2D, ADE, coupled, hooked and IBM steps
(A13b); several processes (A13c).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses

import numpy as np
import torch

from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.step import make_step

#: the ROADMAP item of the sharded steps that are not ported yet
A13B = "ROADMAP A13b"

AXIS_NAMES = ("x", "y", "z")


class Mesh:
    """A grid of torch devices with one name per axis (counterpart of
    ``jax.sharding.Mesh``).  ``devices`` is an array (or nested list) of
    devices or device strings with one dimension per name; a device may
    appear more than once."""

    def __init__(self, devices, axis_names):
        arr = np.array(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


@dataclasses.dataclass(frozen=True, eq=False)
class ShardPlan:
    """How the lattice maps onto the device mesh: ``spatial_axes`` holds,
    per lattice axis, the mesh axis it shards over or None.  Every mesh axis
    shards exactly one lattice axis (nothing is replicated)."""

    mesh: Mesh
    spatial_axes: tuple

    def __post_init__(self):
        object.__setattr__(self, "spatial_axes", tuple(self.spatial_axes))
        used = [n for n in self.spatial_axes if n is not None]
        if len(set(used)) != len(used) or set(used) != set(self.mesh.axis_names):
            raise ValueError(f"every mesh axis {self.mesh.axis_names} must shard exactly one "
                             f"lattice axis, got spatial_axes={self.spatial_axes}")

    @property
    def counts(self) -> tuple:
        """Shards along each lattice axis."""
        return tuple(1 if n is None else self.mesh.shape[n] for n in self.spatial_axes)

    @property
    def n_shards(self) -> int:
        return int(np.prod(self.counts))

    def check(self, domain: Domain):
        for size, n in zip(domain.shape, self.counts):
            if size % n:
                raise ValueError(f"lattice axis of size {size} not divisible by {n} shards")

    def divisible(self, domain: Domain) -> bool:
        return all(size % n == 0 for size, n in zip(domain.shape, self.counts))

    def padded_shape(self, domain: Domain) -> tuple:
        """Each axis rounded up to a multiple of its shard count (JAX
        ``padded_shape``: the uneven decomposition pads, then crops)."""
        return tuple(-(-size // n) * n for size, n in zip(domain.shape, self.counts))

    def local_shape(self, domain: Domain) -> tuple:
        return tuple(p // n for p, n in zip(self.padded_shape(domain), self.counts))

    def block_index(self, k: int) -> tuple:
        """Shard k's block coordinates, one per lattice axis (shards are
        numbered in C order over ``counts``)."""
        return tuple(int(i) for i in np.unravel_index(k, self.counts))

    def shard_at(self, index) -> int:
        return int(np.ravel_multi_index(tuple(index), self.counts))

    def neighbour(self, k: int, axis: int, step: int) -> int:
        """The shard ``step`` blocks away from shard k along lattice
        ``axis``, around the ring."""
        idx = list(self.block_index(k))
        idx[axis] = (idx[axis] + step) % self.counts[axis]
        return self.shard_at(idx)

    def device(self, k: int) -> torch.device:
        idx = self.block_index(k)
        pos = tuple(idx[self.spatial_axes.index(name)] for name in self.mesh.axis_names)
        return self.mesh.devices[pos]

    @property
    def devices(self) -> list:
        return [self.device(k) for k in range(self.n_shards)]

    def shard_field(self, arr, like_f: bool, padded_shape=None) -> ShardedField:
        """A global [Q or D, *S] (``like_f``) or [*S] array or tensor as one
        block per shard on its device.  An axis the mesh does not divide is
        padded to ``padded_shape`` (by default ``padded_shape(S)``) by edge
        replication first; the uneven step rebuilds those ghost layers
        before every step."""
        t = arr if torch.is_tensor(arr) else torch.as_tensor(np.ascontiguousarray(arr))
        lead = 1 if like_f else 0
        shape = tuple(t.shape[lead:])
        if padded_shape is None:
            padded_shape = tuple(-(-s // n) * n for s, n in zip(shape, self.counts))
        padded = tuple(padded_shape)
        for a, (s, p) in enumerate(zip(shape, padded)):
            if p > s:
                d = lead + a
                t = torch.cat([t, t.narrow(d, s - 1, 1).expand(
                    *t.shape[:d], p - s, *t.shape[d + 1:])], dim=d)
        local = tuple(p // n for p, n in zip(padded, self.counts))
        blocks = []
        for k in range(self.n_shards):
            sl = tuple(slice(i * L, (i + 1) * L) for i, L in zip(self.block_index(k), local))
            part = t[(slice(None),) * lead + sl]
            blocks.append(torch.empty(part.shape, dtype=part.dtype,
                                      device=self.device(k)).copy_(part))
        return ShardedField(self, blocks, tuple(arr.shape), padded)


class ShardedField:
    """One block per shard of ``plan``, each on its shard's device, in the
    plan's shard order.  ``shape`` is the global shape, its leading
    non-spatial axes included ([Q, X, Y, Z], [D, X, Y, Z] or [X, Y, Z]);
    the blocks tile ``padded``, the spatial extent the step runs on (the
    spatial shape itself unless the mesh does not divide it)."""

    def __init__(self, plan: ShardPlan, blocks: list, shape: tuple, padded: tuple | None = None):
        self.plan = plan
        self.blocks = list(blocks)
        self.shape = tuple(shape)
        D = len(plan.spatial_axes)
        self.lead = len(self.shape) - D
        self.padded = tuple(self.shape[self.lead:]) if padded is None else tuple(padded)

    @property
    def dtype(self):
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (by default the first shard's),
        cropped to ``shape``."""
        device = self.device if device is None else torch.device(device)
        lead_shape = self.shape[: self.lead]
        out = torch.empty(lead_shape + self.padded, dtype=self.dtype, device=device)
        local = tuple(p // n for p, n in zip(self.padded, self.plan.counts))
        for k, b in enumerate(self.blocks):
            sl = tuple(slice(i * L, (i + 1) * L)
                       for i, L in zip(self.plan.block_index(k), local))
            out[(slice(None),) * self.lead + sl].copy_(b)
        if self.padded != self.shape[self.lead:]:
            out = out[(slice(None),) * self.lead
                      + tuple(slice(0, s) for s in self.shape[self.lead:])].contiguous()
        return out

    def map(self, fn) -> ShardedField:
        """``fn`` applied to every block, a field of the same layout."""
        return ShardedField(self.plan, [fn(b) for b in self.blocks], self.shape, self.padded)

    def empty_like(self) -> ShardedField:
        return self.map(torch.empty_like)

    def zero_(self) -> ShardedField:
        for b in self.blocks:
            b.zero_()
        return self


def default_devices() -> list:
    """Every card of the machine, as the JAX apps take ``jax.devices()``;
    none raises (there is no fallback to the CPU)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("a sharded run over the machine's cards needs a CUDA device")
    return [torch.device(f"cuda:{i}") for i in range(n)]


def app_devices(device) -> list:
    """The devices an app's ``--sharded`` plans over: every card for a CUDA
    ``device`` (a machine without one raises), else ``device`` alone."""
    device = torch.device(device)
    return default_devices() if device.type == "cuda" else [device]


def default_plan(domain: Domain, devices=None) -> ShardPlan:
    """1D x-split over ``devices`` (by default every card)."""
    devices = list(devices if devices is not None else default_devices())
    axes = ("x",) + (None,) * (domain.lat.D - 1)
    return ShardPlan(mesh=Mesh(devices, ("x",)), spatial_axes=axes)


def _divisors(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


def choose_plan(domain: Domain, devices=None, axis_weights=None,
                allow_z: bool = False) -> ShardPlan:
    """The mesh factorization with the least weighted halo-interface area
    (JAX ``choose_plan``, the reference's ``decomposeBlockOptimal``,
    lattice_decomposition.h:67-110): cost = the sum over sharded axes of
    interfaces x global plane area x weight, weights (1, 8, 64) for x, y, z
    by default, plus 10 per ghost site of an uneven decomposition; ties go
    x-major, then y.  z is not cut unless ``allow_z``.  Divisible
    factorizations first, else the uneven ones.  ``devices`` defaults to
    every card."""
    devices = list(devices if devices is not None else default_devices())
    n = len(devices)
    D = domain.lat.D
    shape = domain.shape
    if axis_weights is None:
        axis_weights = (1.0, 8.0, 64.0)[:D]

    def search(require_divisible: bool):
        best = None
        for nx in _divisors(n):
            for ny in _divisors(n // nx):
                nz = n // nx // ny
                counts = (nx, ny, nz)[:D]
                if D == 2 and nz != 1:
                    continue
                if not allow_z and D == 3 and nz > 1:
                    continue
                if require_divisible and any(shape[a] % counts[a] for a in range(D)):
                    continue
                if any(counts[a] > shape[a] for a in range(D)):
                    continue
                padded = tuple(-(-shape[a] // counts[a]) * counts[a] for a in range(D))
                cost = 0.0
                for a in range(D):
                    if counts[a] == 1:
                        continue
                    interfaces = counts[a] if domain.periodic[a] else counts[a] - 1
                    area = 1.0
                    for b in range(D):
                        if b != a:
                            area *= padded[b]
                    cost += axis_weights[a] * interfaces * area
                cost += 10.0 * (int(np.prod(padded)) - int(np.prod(shape)))
                key = (cost, -nx, -ny)
                if best is None or key < best[0]:
                    best = (key, counts)
        return best

    best = search(True) or search(False)
    if best is None:
        raise ValueError(f"no factorization of {n} devices fits lattice {shape}")
    counts = best[1]
    names = AXIS_NAMES[:D]
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return ShardPlan(mesh=Mesh(grid.reshape(counts), names), spatial_axes=names)


# ------------------------------------------------------------------ the halo

def _halo_copies(plan: ShardPlan, blocks, bufs, w: int, axes, periodic, lead: int = 1,
                 comps=None) -> list:
    """The (destination, source) views whose copies, in order, fill each
    shard's buffer ``bufs[k]``: ``blocks[k]`` in its interior and w-wide
    halos on the lattice ``axes`` (the buffers are w wider on each side of
    those axes).  The sweeps run axis by axis, each after every shard's
    previous one, and copy whole slabs of the neighbour's buffer, so the
    later axes carry the earlier ones' halos: corners route through (JAX
    ``_halo_exchange``'s sequential sweeps).  A halo layer is the neighbour
    shard's edge layers (around the ring on a periodic axis); on a
    non-periodic domain face it replicates the block's edge layer; an axis
    of one shard wraps or replicates locally.  ``comps`` (a function of the
    axis and side, -1 low or +1 high, giving component indices) limits what
    comes from a neighbour to those components, the others taking the edge
    layer (``parallel/halo.py``'s direction subsets).  A copy between two
    devices is a peer copy."""
    axes = tuple(axes)
    copies = []
    for f, buf in zip(blocks, bufs):
        inner = buf
        for a in axes:
            inner = inner.narrow(lead + a, w, f.shape[lead + a])
        copies.append((inner, f))
    for a in axes:
        d = lead + a
        n = plan.counts[a]
        per = bool(periodic[a])
        for k, buf in enumerate(bufs):
            L = blocks[k].shape[d]
            b = plan.block_index(k)[a]
            for side, halo in ((-1, buf.narrow(d, 0, w)), (1, buf.narrow(d, w + L, w))):
                edge = buf.narrow(d, w if side < 0 else w + L - 1, 1).expand_as(halo)
                if not per and b == (0 if side < 0 else n - 1):
                    copies.append((halo, edge))
                    continue
                src = bufs[plan.neighbour(k, a, side)].narrow(d, L if side < 0 else w, w)
                if comps is None or n == 1:
                    copies.append((halo, src))
                    continue
                copies.append((halo, edge))
                copies += [(halo[q], src[q]) for q in comps(a, side)]
    return copies


def _fill_halos(plan: ShardPlan, blocks, bufs, w: int, axes, periodic, lead: int = 1,
                comps=None) -> list:
    """Fill each shard's buffer with its block and its halos
    (``_halo_copies``); returns ``bufs``."""
    for dst, src in _halo_copies(plan, blocks, bufs, w, axes, periodic, lead, comps):
        dst.copy_(src)
    return bufs


def padded_buffers(blocks, w: int, axes, lead: int = 1) -> list:
    """A new buffer per block, w wider on each side of the lattice ``axes``."""
    out = []
    for f in blocks:
        shape = list(f.shape)
        for a in axes:
            shape[lead + a] += 2 * w
        out.append(torch.empty(shape, dtype=f.dtype, device=f.device))
    return out


def _halo_exchange(plan: ShardPlan, blocks, adim: int, axis: int, per: bool, w: int) -> list:
    """Each shard's block with a w-wide halo on array dim ``adim`` (lattice
    ``axis``): the neighbour shards' edge slabs, the periodic ring's wrap, or
    edge replication on a non-periodic domain face (JAX ``_halo_exchange``)."""
    lead = adim - axis
    bufs = padded_buffers(blocks, w, (axis,), lead)
    periodic = [False] * len(plan.counts)
    periodic[axis] = per
    return _fill_halos(plan, blocks, bufs, w, (axis,), periodic, lead)


def _global_input(arr, lat, shape, dtype):
    """A [D] vector as it is; a [D, ...] field broadcast to [D, *shape]."""
    if arr is None or (arr.dim() if torch.is_tensor(arr) else np.ndim(arr)) <= 1:
        return arr
    t = arr if torch.is_tensor(arr) else torch.as_tensor(np.asarray(arr))
    return t.to(dtype).reshape((lat.D,) + (1,) * (len(shape) + 1 - t.dim())
                               + tuple(t.shape[1:])).expand((lat.D,) + tuple(shape))


def make_sharded_step(cfg: LBMConfig, domain: Domain, plan: ShardPlan):
    """``step(f, nu, u_in=None, force=None, parity=0) -> (f, rho, u)`` on
    ShardedFields of ``plan``: the plain step (``sim/step.py``) on every
    shard's block, one shard after the other, its halos from the halo pad
    of ``parallel/halo.py`` over every shard's block (JAX
    ``make_sharded_step``): the pad of f before the collision, and on the
    A-A odd step the pad of the post-collision field before the push.
    ``u_in`` and ``force`` are [D] vectors or fields broadcastable to
    [D, *S].  A lattice the mesh does not divide runs through
    ``_make_uneven_sharded_step`` (A-B).  The step's ``padded_shape`` is
    the extent its fields tile."""
    from tnl_lbm_tpu_torch.parallel.halo import make_halo_pad

    if not plan.divisible(domain):
        return _make_uneven_sharded_step(cfg, domain, plan)
    plan.check(domain)
    if cfg.forcing_hook is not None:
        raise NotImplementedError(f"a sharded step with a forcing hook is not ported yet ({A13B})")
    codes = domain.codes_present()
    local_shape = plan.local_shape(domain)
    # direction-subset exchange unless a pull reads other components' halos
    # (Bouzidi; the outflow pulls from x-1 on a one-plane block)
    subset_ok = domain.bouzidi is None and (
        not ({GEO.OUTFLOW_RIGHT, GEO.OUTFLOW_RIGHT_INTERP} & codes) or local_shape[0] >= 2)
    pad = make_halo_pad(plan, domain.periodic, lat=cfg.lat if subset_ok else None)
    local_step = make_step(cfg, domain, local_shape=local_shape)
    maps = plan.shard_field(domain.map.astype(np.int64), like_f=False)
    thetas = (plan.shard_field(np.asarray(domain.bouzidi), like_f=True)
              if domain.bouzidi is not None else None)
    dtype = cfg.compute_dtype
    aa = cfg.streaming == "AA"

    def step(f: ShardedField, nu, u_in=None, force=None, parity: int = 0):
        u_in = _global_input(u_in, cfg.lat, domain.shape, dtype)
        force = _global_input(force, cfg.lat, domain.shape, dtype)
        u_sh = plan.shard_field(u_in, like_f=True) if _is_field(u_in) else None
        f_sh = plan.shard_field(force, like_f=True) if _is_field(force) else None
        n = plan.n_shards
        fpads = pad(f.blocks, local_step.pull_comps) if not aa or parity else [None] * n
        mids = [local_step.collide(
                    f.blocks[k], nu, u_in=u_in if u_sh is None else u_sh.blocks[k],
                    force=force if f_sh is None else f_sh.blocks[k], parity=parity,
                    map_arr=maps.blocks[k],
                    bouzidi_arr=None if thetas is None else thetas.blocks[k].to(dtype),
                    fpad=fpads[k])
                for k in range(n)]
        posts = pad([m[0] for m in mids], "own") if aa and parity else [None] * n
        fs = [local_step.stream_out(f.blocks[k], m[0], m[3], parity, posts[k])
              for k, m in enumerate(mids)]
        D = cfg.lat.D
        return (ShardedField(plan, fs, f.shape, f.padded),
                ShardedField(plan, [m[1] for m in mids], domain.shape),
                ShardedField(plan, [m[2] for m in mids], (D,) + domain.shape))

    step.padded_shape = domain.shape
    return step


def _is_field(arr) -> bool:
    return arr is not None and (arr.dim() if torch.is_tensor(arr) else np.ndim(arr)) > 1


def _make_uneven_sharded_step(cfg: LBMConfig, domain: Domain, plan: ShardPlan,
                              inner_builder=None):
    """The sharded step on a lattice the mesh does not divide (JAX
    ``_make_uneven_sharded_step``, the reference's uneven ``splitRange``,
    lattice_decomposition.h:16-55): the fields tile the lattice padded to
    the next mesh multiple, and before every step the ghost layers are
    rebuilt from the true state - on a non-periodic axis the true last
    layer, on a periodic one the wrap fill with the true last layer in the
    last ghost layer (which the ring delivers to shard 0) - then the inner
    step runs on the padded lattice; the ghost sites' outputs are junk that
    ``ShardedField.gather`` crops and the next rebuild overwrites.  Exact
    for pull (A-B) streaming; an A-A push would read post-collision ghost
    values no rebuild can reach, so A-A raises.  A pad of one layer on a
    periodic axis pads one mesh multiple more, so that the wrap layer and
    the ring's carrier are distinct layers."""
    if cfg.streaming != "AB":
        raise NotImplementedError(
            "uneven (non-divisible) decomposition requires A-B streaming; use streaming='AB' "
            "or a mesh-divisible lattice")
    if cfg.forcing_hook is not None:
        raise NotImplementedError(f"an uneven sharded step with a forcing hook is not ported "
                                  f"yet ({A13B})")
    inner_builder = inner_builder or make_sharded_step
    S = domain.shape
    Sp = list(plan.padded_shape(domain))
    for a, n in enumerate(plan.counts):
        if n > 1 and domain.periodic[a] and Sp[a] - S[a] == 1:
            Sp[a] += n
    Sp = tuple(Sp)
    pads = [(0, p - s) for s, p in zip(S, Sp)]
    units_p = dataclasses.replace(domain.units, global_size=Sp)
    map_p = np.pad(domain.map, pads, mode="edge")
    bz_p = (np.pad(domain.bouzidi, [(0, 0)] + pads, mode="edge")
            if domain.bouzidi is not None else None)
    dom_p = dataclasses.replace(domain, units=units_p, map=map_p, bouzidi=bz_p)
    inner = inner_builder(cfg, dom_p, plan)
    D = cfg.lat.D

    def rebuild(f: ShardedField) -> None:
        """The ghost layers of ``f`` from its true layers, in place."""
        local = tuple(p // n for p, n in zip(Sp, plan.counts))
        for a in range(D):
            p = Sp[a] - S[a]
            d = f.lead + a
            for j in range(p):
                src = j if domain.periodic[a] and j < p - 1 else S[a] - 1
                dst = S[a] + j
                for k in range(plan.n_shards):
                    if plan.block_index(k)[a] != dst // local[a]:
                        continue
                    idx = list(plan.block_index(k))
                    idx[a] = src // local[a]
                    f.blocks[k].narrow(d, dst % local[a], 1).copy_(
                        f.blocks[plan.shard_at(idx)].narrow(d, src % local[a], 1))

    def pad_input(arr):
        """A [D, ...] field broadcast to S and padded as the state is."""
        if not _is_field(arr):
            return arr
        field = plan.shard_field(_global_input(arr, cfg.lat, S, cfg.compute_dtype).contiguous(),
                                 like_f=True, padded_shape=Sp)
        rebuild(field)
        return _padded_global(field)

    def step(f: ShardedField, nu, u_in=None, force=None, parity: int = 0, **kw):
        rebuild(f)
        out = inner(f, nu, u_in=pad_input(u_in), force=pad_input(force), parity=parity, **kw)
        return tuple(_true(x, f.lead if i == 0 else (0 if i == 1 else 1), S)
                     for i, x in enumerate(out))

    step.padded_shape = Sp
    step.kernels = [inner]
    step.reset_counts = getattr(inner, "reset_counts", lambda: None)
    return step


def _padded_global(field: ShardedField) -> torch.Tensor:
    """A field's blocks assembled over its padded extent, ghosts included."""
    whole = ShardedField(field.plan, field.blocks, field.shape[: field.lead] + field.padded)
    return whole.gather()


def _true(x: ShardedField, lead: int, S: tuple) -> ShardedField:
    """``x`` labelled with the true spatial shape ``S`` (its blocks tile the
    padded extent)."""
    if x.shape[lead:] == tuple(S):
        return x
    return ShardedField(x.plan, x.blocks, x.shape[:lead] + tuple(S), x.padded)


# ------------------------------------------------------ the kernels' steps

def _xy_only(plan: ShardPlan, what: str) -> None:
    """The kernels' sharded steps take x/y meshes; a z cut raises."""
    if len(plan.counts) == 3 and plan.counts[2] > 1:
        raise NotImplementedError(f"{what} on a z-sharded mesh is not ported yet ({A13B}); "
                                  f"choose_plan cuts x and y only")


def _on(device: torch.device):
    """The context that makes ``device`` current for a kernel launch (a
    launch goes to the current card's stream)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _shard_maps(plan: ShardPlan, domain: Domain) -> ShardedField:
    return plan.shard_field(np.ascontiguousarray(domain.map, np.uint8), like_f=False)


class _ShardedKernelStep:
    """What the kernels' sharded steps share: the local wrapper, each
    shard's map, the halo buffers (made once per state dtype) and the launch
    counts (``kernels``: the local wrapper's, which every shard's launch adds
    to)."""

    def __init__(self, plan: ShardPlan, domain: Domain, local_step, width: int):
        self.plan, self.domain, self.local_step, self.width = plan, domain, local_step, width
        self.kernels = [local_step]
        self.maps = _shard_maps(plan, domain)
        self.padded_shape = domain.shape
        self._bufs = {}
        #: the exchange's copies per state (by its blocks' addresses): a run
        #: ping-pongs two states, so their views are made once each
        self._copies = collections.OrderedDict()

    def reset_counts(self) -> None:
        self.local_step.reset_counts()

    def exchange(self, f: ShardedField) -> list:
        """Each shard's block with its ``width``-wide x/y halo, in buffers
        kept across steps (the halo exchange: one copy of every block and
        its halo slabs)."""
        bufs = self._bufs.get(f.dtype)
        if bufs is None:
            bufs = self._bufs[f.dtype] = padded_buffers(f.blocks, self.width, (0, 1))
        key = tuple(b.data_ptr() for b in f.blocks)
        copies = self._copies.get(key)
        if copies is None:
            copies = _halo_copies(self.plan, f.blocks, bufs, self.width, (0, 1),
                                  self.domain.periodic)
            self._copies[key] = copies
            while len(self._copies) > 2:
                self._copies.popitem(last=False)
        for dst, src in copies:
            dst.copy_(src)
        return bufs

    def _launch(self, k: int, *args, **kwargs):
        """The local step on shard k's block, with shard k's card current."""
        with _on(self.plan.device(k)):
            return self.local_step(*args, **kwargs)

    def _outputs(self, f: ShardedField, out, macro_out):
        n = self.plan.n_shards
        outs = out.blocks if out is not None else [None] * n
        macros = ([(macro_out[0].blocks[k], macro_out[1].blocks[k]) for k in range(n)]
                  if macro_out is not None else [None] * n)
        return outs, macros

    def _macros(self, results, macro_out):
        """(rho, u) of a step: ``macro_out``, or the launches' new blocks."""
        if macro_out is not None:
            return macro_out
        S = self.domain.shape
        return (ShardedField(self.plan, [r[1] for r in results], S),
                ShardedField(self.plan, [r[2] for r in results], (3,) + S))

    def _state(self, f, results, out):
        """The new state: ``out``, or the launches' new blocks."""
        if out is not None:
            return out
        return ShardedField(self.plan, [r[0] for r in results], f.shape, f.padded)


class ShardedFusedStepAB(_ShardedKernelStep):
    """``step(f, nu, u_in=None, force=None, parity=0, out=None, macro_out=None)
    -> (f_new, rho, u)`` on ShardedFields: per step the 1-wide x/y halo
    exchange, then the A-B step (B4) on each shard's haloed block
    (``make_fused_step`` with ``prepadded=True``), its output into ``out``
    and ``macro_out`` where given (ShardedFields like f and rho/u)."""

    def __call__(self, f, nu, u_in=None, force=None, parity: int = 0, out=None, macro_out=None):
        del parity
        halo = self.exchange(f)
        outs, macros = self._outputs(f, out, macro_out)
        results = [self._launch(k, halo[k], nu, u_in=u_in, force=force, out=outs[k],
                                macro_out=macros[k], map_arr_in=self.maps.blocks[k])
                   for k in range(self.plan.n_shards)]
        return (self._state(f, results, out),) + tuple(self._macros(results, macro_out))


def make_sharded_fused_step(cfg: LBMConfig, domain: Domain, plan: ShardPlan,
                            with_macro: bool = True, force_field: bool = False,
                            macro_only: bool = False) -> ShardedFusedStepAB:
    """The sharded A-B step through B4 on haloed blocks (JAX
    ``make_sharded_fused_step``; its TPU knobs ``tile`` and
    ``tiles_per_program`` have no counterpart): x/y meshes; a z cut, and the
    force_field and macro_only variants of the hooked steps, raise naming
    A13b."""
    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step

    plan.check(domain)
    _xy_only(plan, "the sharded A-B step (B4)")
    if force_field or macro_only:
        raise NotImplementedError(f"the sharded force_field / macro_only A-B steps (the hooked "
                                  f"routes) are not ported yet ({A13B})")
    local_step = make_fused_step(cfg, domain, plan.device(0), with_macro=with_macro,
                                 prepadded=True, local_shape=plan.local_shape(domain))
    return ShardedFusedStepAB(plan, domain, local_step, 1)


class ShardedFusedStepAA(_ShardedKernelStep):
    """``step(f, nu, u_in=None, force=None, parity=0, out=None, macro_out=None)
    -> (f, rho, u)`` on ShardedFields: parity 0 the even step (B2) on every
    shard's block in place (same-site: no exchange); parity 1 the 2-wide x/y
    halo exchange, then the odd step (B3) on each shard's haloed block with
    its map ring and boundary flags, into ``out`` where given."""

    def __init__(self, plan, domain, local_step):
        super().__init__(plan, domain, local_step, 2)
        # each shard's map with its 1-wide x/y ring (neighbours' codes, or the
        # edge replicated on a domain face), and which of its faces are
        # non-periodic faces of the domain (JAX bflags)
        m = self.maps.map(lambda b: b[None])
        ring = _fill_halos(plan, m.blocks, padded_buffers(m.blocks, 1, (0, 1)), 1, (0, 1),
                           domain.periodic)
        self.rings = [r[0].contiguous() for r in ring]
        self.bflags = [_bflags(plan, k) for k in range(plan.n_shards)]

    def __call__(self, f, nu, u_in=None, force=None, parity: int = 0, out=None, macro_out=None):
        outs, macros = self._outputs(f, out, macro_out)
        n = self.plan.n_shards
        if parity == 0:
            results = [self._launch(k, f.blocks[k], nu, u_in=u_in, force=force, parity=0,
                                    macro_out=macros[k], map_arr_in=self.maps.blocks[k])
                       for k in range(n)]
            return (f,) + tuple(self._macros(results, macro_out))
        halo = self.exchange(f)
        results = [self._launch(k, halo[k], nu, u_in=u_in, force=force, parity=1, out=outs[k],
                                macro_out=macros[k], map_ring_in=self.rings[k],
                                bflags=self.bflags[k])
                   for k in range(n)]
        return (self._state(f, results, out),) + tuple(self._macros(results, macro_out))


def _bflags(plan: ShardPlan, k: int) -> tuple:
    """Shard k's six face flags (x low, x high, y low, y high, z low, z
    high): 1 where its block holds the domain's face on that side (every
    face of an axis of one shard), else 0 (JAX ``_bflag``)."""
    idx = plan.block_index(k)
    flags = []
    for a in range(3):
        n = plan.counts[a]
        flags += [float(n == 1 or idx[a] == 0), float(n == 1 or idx[a] == n - 1)]
    return tuple(flags)


def make_sharded_fused_step_aa(cfg: LBMConfig, domain: Domain, plan: ShardPlan,
                               with_macro: bool = True, force_field: bool = False,
                               macro_only: bool = False) -> ShardedFusedStepAA:
    """The sharded A-A step through B2 on each shard's block and B3 on its
    haloed block (JAX ``make_sharded_fused_step_aa``): x/y meshes.  A z cut,
    the force ring (``force_field``) and the u* pass (``macro_only``) raise
    naming A13b."""
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa

    plan.check(domain)
    _xy_only(plan, "the sharded A-A step (B2, B3)")
    if force_field or macro_only:
        raise NotImplementedError(f"the sharded A-A force ring (force_field) and u* pass "
                                  f"(macro_only) are not ported yet ({A13B})")
    if not with_macro:
        raise NotImplementedError("with_macro=False is not ported yet (ROADMAP A7)")
    local_step = make_fused_step_aa(cfg, domain, plan.device(0), prepadded=True,
                                    local_shape=plan.local_shape(domain))
    return ShardedFusedStepAA(plan, domain, local_step)
