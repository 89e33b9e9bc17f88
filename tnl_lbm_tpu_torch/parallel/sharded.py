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
  shard's block), with a forcing hook evaluated on the gathered lattice or,
  for a ``shard_local`` hook (IBM's ``sharded_hook``), on the shards'
  blocks: the CPU path and the oracle of the kernels' sharded steps;
- :func:`make_sharded_fused_step`, the A-B step (B4) on each shard's block
  with a 1-wide x/y halo, and its force_field and macro_only modes (the
  hooked pipeline, ``kernels/hooked.py make_sharded_hooked_fused_step``);
- :func:`make_sharded_fused_step_aa`, the A-A steps: the even step (B2) on
  each shard's block as it is (same-site), the odd step (B3) on the block
  with a 2-wide x/y halo and its map with a 1-wide ring; in force_field
  mode the odd step's force ring comes from the neighbour shards;
- :func:`make_sharded_nn_force`, the NN force (B9) on each shard's block of
  u* with a 2-wide x/y halo, and :func:`make_sharded_fused_nn_step`, the
  one-kernel NN step (B10) on each shard's block with the halo its stencil
  chain reads (3, 2 or 4 wide: A-B, even, odd);
- :func:`make_sharded_fused_pair2_aa`, the A-A pair (B1, or B1b on the
  other A-A maps) on persistent haloed blocks: each shard's state lives in
  a block with a 2-wide x/y halo (:func:`to_padded_aa_sharded`,
  :func:`from_padded_aa_sharded`), and a pair refreshes only the halo slabs;
- :func:`make_sharded_fused_step_2d`, the D2Q9 step (B5) on each shard's
  block with a 1-wide x/y ring;
- :func:`make_sharded_ade_step`, the plain D3Q7 ADE step per shard (the
  CPU path and the oracle), and :func:`make_sharded_fused_ade_step`, the
  ADE step (B6) on each shard's block with a 2-wide x and a 1-wide y halo:
  the two halves, with the NSE steps, of ``CoupledSimulation(plan=...)``;
- :func:`_make_uneven_sharded_step`, pad-and-crop for a lattice the mesh
  does not divide (A-B only, as in the JAX package).

What is not ported yet raises naming its ROADMAP item: z-sharded meshes on
the kernels and the pair's family collisions (A13b); several processes
(A13c).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses

import numpy as np
import torch

from tnl_lbm_tpu_torch.ops import moments as mom
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.step import as_vector, make_step

#: the ROADMAP item of the sharded steps that are not ported yet
A13B = "ROADMAP A13b"

AXIS_NAMES = ("x", "y", "z")


def _block_of(plan, k: int, local) -> tuple:
    """Shard k's slices of the lattice axes (blocks of ``local``)."""
    return tuple(slice(i * L, (i + 1) * L) for i, L in zip(plan.block_index(k), local))


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
            part = t[(slice(None),) * lead + _block_of(self, k, local)]
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
            out[(slice(None),) * self.lead + _block_of(self.plan, k, local)].copy_(b)
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

def _widths(w, axes) -> dict:
    """Lattice axis -> halo width: ``w`` for every one of ``axes``, or one
    width per axis of ``axes``."""
    return {a: (w if isinstance(w, int) else w[i]) for i, a in enumerate(axes)}


def _halo_copies(plan: ShardPlan, blocks, bufs, w, axes, periodic, lead: int = 1,
                 comps=None, interior: bool = True) -> list:
    """The (destination, source) views whose copies, in order, fill each
    shard's buffer ``bufs[k]``: ``blocks[k]`` in its interior and w-wide
    halos on the lattice ``axes`` (the buffers are w wider on each side of
    those axes; ``w`` one width, or one per axis of ``axes``).  The sweeps
    run axis by axis, each after every shard's previous one, and copy whole
    slabs of the neighbour's buffer, so the later axes carry the earlier
    ones' halos: corners route through (JAX
    ``_halo_exchange``'s sequential sweeps).  A halo layer is the neighbour
    shard's edge layers (around the ring on a periodic axis); on a
    non-periodic domain face it replicates the block's edge layer; an axis
    of one shard wraps or replicates locally.  ``comps`` (a function of the
    axis and side, -1 low or +1 high, giving component indices) limits what
    comes from a neighbour to those components, the others taking the edge
    layer (``parallel/halo.py``'s direction subsets).  A copy between two
    devices is a peer copy.  ``interior=False`` leaves the interiors out:
    the blocks already sit in their buffers (the sharded pair's layout)."""
    axes = tuple(axes)
    ws = _widths(w, axes)
    copies = []
    for f, buf in zip(blocks, bufs) if interior else ():
        inner = buf
        for a in axes:
            inner = inner.narrow(lead + a, ws[a], f.shape[lead + a])
        copies.append((inner, f))
    for a in axes:
        w = ws[a]
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


def _fill_halos(plan: ShardPlan, blocks, bufs, w, axes, periodic, lead: int = 1,
                comps=None) -> list:
    """Fill each shard's buffer with its block and its halos
    (``_halo_copies``); returns ``bufs``."""
    for dst, src in _halo_copies(plan, blocks, bufs, w, axes, periodic, lead, comps):
        dst.copy_(src)
    return bufs


def padded_buffers(blocks, w, axes, lead: int = 1) -> list:
    """A new buffer per block, w wider on each side of the lattice ``axes``
    (``w`` one width, or one per axis of ``axes``)."""
    ws = _widths(w, tuple(axes))
    out = []
    for f in blocks:
        shape = list(f.shape)
        for a in axes:
            shape[lead + a] += 2 * ws[a]
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
    """``step(f, nu, u_in=None, force=None, parity=0, hook_consts=None) ->
    (f, rho, u)`` on ShardedFields of ``plan``: the plain step
    (``sim/step.py``) on every shard's block, one shard after the other,
    its halos from the halo pad of ``parallel/halo.py`` over every shard's
    block (JAX ``make_sharded_step``): the pad of f before the collision,
    and on the A-A odd step the pad of the post-collision field before the
    push.  ``u_in`` and ``force`` are [D] vectors or fields broadcastable to
    [D, *S].  A lattice the mesh does not divide runs through
    ``_make_uneven_sharded_step`` (A-B).  The step's ``padded_shape`` is
    the extent its fields tile.

    A forcing hook (JAX ``make_sharded_step`` :360-400) is evaluated on the
    u* moments and its force added to the body force, as the plain step
    does: a hook without ``shard_local`` on the whole lattice, gathered on
    the plan's first device (JAX: GSPMD over the global arrays), its force
    sharded back; a ``shard_local`` hook (IBM's ``sharded_hook``) on the
    shards' blocks: it takes the u* moments and the fluid mask as
    ShardedFields of the plan and returns the force as one (or as its
    blocks), summing what crosses the shards itself."""
    from tnl_lbm_tpu_torch.parallel.halo import make_halo_pad

    if not plan.divisible(domain):
        return _make_uneven_sharded_step(cfg, domain, plan)
    plan.check(domain)
    if cfg.forcing_hook is not None:
        return _make_sharded_hooked_step(cfg, domain, plan)
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

    def step(f: ShardedField, nu, u_in=None, force=None, parity: int = 0, fpads=None):
        u_in = _global_input(u_in, cfg.lat, domain.shape, dtype)
        u_sh = plan.shard_field(u_in, like_f=True) if _is_field(u_in) else None
        if isinstance(force, ShardedField):
            f_sh = force
        else:
            force = _global_input(force, cfg.lat, domain.shape, dtype)
            f_sh = plan.shard_field(force, like_f=True) if _is_field(force) else None
        n = plan.n_shards
        if fpads is None:
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
    step.pad, step.local_step, step.maps = pad, local_step, maps
    return step


def _make_sharded_hooked_step(cfg: LBMConfig, domain: Domain, plan: ShardPlan):
    """The plain sharded step with a forcing hook (``make_sharded_step``):
    the u* pass, the hook and the plain sharded step without it, the hook's
    force plus the body force as its per-site force."""
    hook = cfg.forcing_hook
    lat, dtype = cfg.lat, cfg.compute_dtype
    has_consts = getattr(hook, "consts", None) is not None
    cfg_nohook = dataclasses.replace(cfg, forcing_hook=None)
    inner = make_sharded_step(cfg_nohook, domain, plan)
    aa = cfg.streaming == "AA"
    if getattr(hook, "shard_local", False):
        fluid = plan.shard_field((domain.map == int(GEO.FLUID)), like_f=False)

        def local_step(f, nu, u_in=None, force=None, parity: int = 0, hook_consts=None):
            """The hook on the shards' blocks: each block's u* from the pad of f
            (the JAX local step's hook input), the hook on them all."""
            ls, n = inner.local_step, plan.n_shards
            fpads = inner.pad(f.blocks, ls.pull_comps) if not aa or parity else [None] * n
            fb = _global_input(force, lat, domain.shape, dtype)
            fbs = plan.shard_field(fb, like_f=True).blocks if _is_field(fb) else [fb] * n
            parts = [ls.ustar(f.blocks[k], force=fbs[k], parity=parity, map_arr=inner.maps.blocks[k],
                              fpad=fpads[k]) for k in range(n)]
            rho0 = ShardedField(plan, [q[0] for q in parts], domain.shape)
            u0 = ShardedField(plan, [q[1] for q in parts], (lat.D,) + domain.shape)
            kw = {"consts": hook_consts} if has_consts else {}
            extra = _blocks_of(hook(lat, rho0, u0, nu, fluid, **kw))
            total = [e.to(dtype) if fbs[k] is None
                     else as_vector(lat, fbs[k], dtype, e.device) + e.to(dtype)
                     for k, e in enumerate(extra)]
            return inner(f, nu, u_in=u_in, force=ShardedField(plan, total, (lat.D,) + domain.shape),
                         parity=parity, fpads=fpads)

        local_step.padded_shape = domain.shape
        return local_step

    ustar = make_step(cfg_nohook, domain).ustar

    def hooked_step(f, nu, u_in=None, force=None, parity: int = 0, hook_consts=None):
        """The hook on the gathered lattice (JAX's GSPMD evaluation)."""
        dev = plan.device(0)
        field = _is_field(force)
        fvec = None if field else force
        rho0, u0, fl = ustar(_padded_global(f, dev), force=fvec, parity=parity)
        if field:
            fb = torch.as_tensor(force, dtype=dtype, device=dev)
            u0 = u0 + fb / (2 * torch.clamp_min(rho0, 1e-12))
        kw = {"consts": hook_consts} if has_consts else {}
        extra = hook(lat, rho0, u0, nu, fl, **kw).to(dtype)
        if force is not None:
            fb = torch.as_tensor(np.asarray(force) if not torch.is_tensor(force) else force,
                                 dtype=dtype, device=dev)
            if fb.dim() == 1:
                fb = fb.reshape((lat.D,) + (1,) * lat.D)
            extra = extra + fb
        return inner(f, nu, u_in=u_in, force=extra, parity=parity)

    hooked_step.padded_shape = domain.shape
    return hooked_step


def _blocks_of(out) -> list:
    """A shard-local hook's output as blocks: a ShardedField's, or the list."""
    return out.blocks if isinstance(out, ShardedField) else list(out)


def make_sharded_ade_step(cfg: LBMConfig, domain: Domain, plan: ShardPlan):
    """``step(g, u, nu, phi_in=None, transfer_dirs=None, transfer_coeff=0.0,
    parity=0) -> (g_new, phi)`` on ShardedFields of the D3Q7 lattice (JAX
    ``make_sharded_ade_step``, the ADE half of the reference's multi-GPU
    coupled run): the plain ADE step (``sim/step_ade.py``) on every shard's
    block, one shard after the other, in two stages, each after the halo pad
    of ``parallel/halo.py`` over every shard's block with D3Q7's direction
    subsets - g before the pull (and the pre-streaming phi for the transfer
    links), and on the A-A odd step the post-collision field before the
    push.  ``u`` is the NSE step's sharded velocity; ``nu`` a scalar or a
    per-site field (a ShardedField, or a global [X, Y, Z] tensor);
    ``transfer_dirs`` the [Q-1, X, Y, Z] flags, sharded or global.  As in
    the JAX step, OUTFLOW_PE with a sharded y or z axis raises (its pull
    pads its own 2-wide x halo from the block), and so does a local x width
    under 3 there.  The CPU path and the oracle of the sharded ADE kernel;
    on the card with the kernels it is never the path."""
    from tnl_lbm_tpu_torch.parallel.halo import make_halo_pad
    from tnl_lbm_tpu_torch.sim.step_ade import ADEGEO, make_ade_step

    plan.check(domain)
    codes = domain.codes_present()
    if ADEGEO.OUTFLOW_PE in codes:
        if any(plan.counts[a] > 1 for a in (1, 2)):
            raise NotImplementedError("OUTFLOW_PE with a sharded y/z axis is not supported")
        if plan.local_shape(domain)[0] < 3:
            raise NotImplementedError("OUTFLOW_PE needs local x width >= 3")
    pad = make_halo_pad(plan, domain.periodic, lat=cfg.lat)
    local_step = make_ade_step(cfg, domain, local_shape=plan.local_shape(domain))
    maps = plan.shard_field(domain.map.astype(np.int64), like_f=False)
    has_transfer = bool(codes & {ADEGEO.TRANSFER_FS, ADEGEO.TRANSFER_SF, ADEGEO.TRANSFER_SW})
    aa = cfg.streaming == "AA"
    kept = {}  # like_f -> (a global per-site input, its blocks)

    def blocks(arr, like_f: bool) -> list:
        """A per-site input's blocks: a ShardedField's, or a global tensor's,
        split at its first call and kept."""
        if isinstance(arr, ShardedField):
            return arr.blocks
        got = kept.get(like_f)
        if got is None or got[0] is not arr:
            got = kept[like_f] = (arr, plan.shard_field(arr, like_f=like_f).blocks)
        return got[1]

    def step(g: ShardedField, u: ShardedField, nu, phi_in=None, transfer_dirs=None,
             transfer_coeff=0.0, parity: int = 0):
        n = plan.n_shards
        nus = (blocks(nu, False) if isinstance(nu, ShardedField) or _is_site_field(nu)
               else [nu] * n)
        tdirs = (blocks(transfer_dirs, True) if has_transfer and transfer_dirs is not None
                 else [None] * n)
        pull = not aa or parity
        gpads = pad(g.blocks, local_step.pull_comps) if pull else [None] * n
        phipads = ([p[0] for p in pad([mom.density(cfg.lat, b)[None] for b in g.blocks], "all")]
                   if has_transfer and transfer_dirs is not None and pull else [None] * n)
        mids = [local_step.collide(g.blocks[k], u.blocks[k], nus[k], phi_in, tdirs[k],
                                   transfer_coeff, parity, map_arr=maps.blocks[k],
                                   gpad=gpads[k], phipad=phipads[k])
                for k in range(n)]
        posts = pad([m[0] for m in mids], "own") if aa and parity else [None] * n
        outs = [local_step.stream_out(g.blocks[k], *mids[k], parity=parity, post_pad=posts[k])
                for k in range(n)]
        return (ShardedField(plan, [o[0] for o in outs], g.shape, g.padded),
                ShardedField(plan, [o[1] for o in outs], domain.shape))

    return step


def _is_site_field(arr) -> bool:
    """A per-site scalar field (a tensor or array of one or more dims)."""
    return arr is not None and (arr.dim() if torch.is_tensor(arr) else np.ndim(arr)) > 0


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
    inner_builder = inner_builder or make_sharded_step
    S = domain.shape
    Sp = list(plan.padded_shape(domain))
    for a, n in enumerate(plan.counts):
        if n > 1 and domain.periodic[a] and Sp[a] - S[a] == 1:
            Sp[a] += n
    Sp = tuple(Sp)
    pads = [(0, p - s) for s, p in zip(S, Sp)]
    hook = cfg.forcing_hook
    if hook is not None and not getattr(hook, "shard_local", False):
        # on the padded lattice the hook's stencils would read the ghost
        # layers' u* and rho where the unpadded step's edge pads stand (JAX
        # :269-290): the hook runs on the true extent, its force padded out
        # by edge replication (the ghost sites' outputs are cropped)
        crop = tuple(slice(0, s) for s in S)

        def uneven_hook(lat, rho0, u0, nu, fluid, **kw):
            out = hook(lat, rho0[crop], u0[(slice(None),) + crop], nu, fluid[crop], **kw)
            return _edge_pad(out, [p for _, p in pads])

        for attr in ("consts", "reads_host"):
            if getattr(hook, attr, None) is not None:
                setattr(uneven_hook, attr, getattr(hook, attr))
        cfg = dataclasses.replace(cfg, forcing_hook=uneven_hook)
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


def _padded_global(field: ShardedField, device=None) -> torch.Tensor:
    """A field's blocks assembled over its padded extent, ghosts included,
    on ``device`` (by default the first shard's)."""
    whole = ShardedField(field.plan, field.blocks, field.shape[: field.lead] + field.padded)
    return whole.gather(device)


def _edge_pad(t: torch.Tensor, highs) -> torch.Tensor:
    """[C, *S] padded by ``highs[a]`` layers at the high end of each spatial
    axis a, each a copy of the last layer."""
    lead = t.dim() - len(highs)
    for a, n in enumerate(highs):
        if n:
            d = lead + a
            t = torch.cat([t, t.narrow(d, t.shape[d] - 1, 1).expand(
                *t.shape[:d], n, *t.shape[d + 1:])], dim=d)
    return t


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

    def exchange(self, f: ShardedField, width=None, periodic=None) -> list:
        """Each shard's block with its ``width``-wide x/y halo (by default the
        step's; one width, or (x, y)) under ``periodic`` (by default the
        domain's), in buffers kept across steps (the halo exchange: one copy
        of every block and its halo slabs).  The copies of the last two sets
        of blocks (a run ping-pongs two states) are kept for each width and
        periodicity."""
        width = self.width if width is None else width
        periodic = tuple(self.domain.periodic if periodic is None else periodic)
        lead = len(f.shape) - len(self.domain.shape)
        bkey = (f.dtype, tuple(f.blocks[0].shape[:lead]), width, periodic)
        bufs = self._bufs.get(bkey)
        if bufs is None:
            bufs = self._bufs[bkey] = padded_buffers(f.blocks, width, (0, 1), lead)
        key = (bkey, tuple(b.data_ptr() for b in f.blocks))
        copies = self._copies.get(key)
        if copies is None:
            copies = _halo_copies(self.plan, f.blocks, bufs, width, (0, 1), periodic, lead)
            self._copies[key] = copies
            if len([k for k in self._copies if k[0] == bkey]) > 2:
                del self._copies[next(k for k in self._copies if k[0] == bkey)]
        for dst, src in copies:
            dst.copy_(src)
        return bufs

    def map_halo(self, width: int, periodic=None) -> list:
        """Each shard's map with a ``width``-wide x/y halo of the neighbours'
        codes (edge-replicated on a closed domain face), made once."""
        periodic = tuple(self.domain.periodic if periodic is None else periodic)
        key = ("map", width, periodic)
        if key not in self._bufs:
            m = self.maps.map(lambda b: b[None])
            pads = _fill_halos(self.plan, m.blocks, padded_buffers(m.blocks, width, (0, 1)),
                               width, (0, 1), periodic)
            self._bufs[key] = [q[0].contiguous() for q in pads]
        return self._bufs[key]

    def field_blocks(self, field) -> list:
        """A per-site [3, *S] input's blocks: a ShardedField's, or a global
        tensor's, split per call."""
        if isinstance(field, ShardedField):
            return field.blocks
        return self.plan.shard_field(field, like_f=True).blocks

    def _launch(self, k: int, *args, **kwargs):
        """The local step on shard k's block, with shard k's card current."""
        with _on(self.plan.device(k)):
            return self.local_step(*args, **kwargs)

    def _macro_only(self, results, macro_out):
        """(rho0, u0) of a u* pass: ``macro_out``, or the launches' blocks."""
        if macro_out is not None:
            return macro_out
        S = self.domain.shape
        return (ShardedField(self.plan, [r[0] for r in results], S),
                ShardedField(self.plan, [r[1] for r in results], (len(S),) + S))

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
                ShardedField(self.plan, [r[2] for r in results], (len(S),) + S))

    def _state(self, f, results, out):
        """The new state: ``out``, or the launches' new blocks."""
        if out is not None:
            return out
        return ShardedField(self.plan, [r[0] for r in results], f.shape, f.padded)


class ShardedFusedStepAB(_ShardedKernelStep):
    """``step(f, nu, u_in=None, force=None, parity=0, out=None, macro_out=None,
    force_add=None) -> (f_new, rho, u)`` on ShardedFields: per step the
    1-wide x/y halo exchange, then the A-B step (B4) on each shard's haloed
    block (``make_fused_step`` with ``prepadded=True``), its output into
    ``out`` and ``macro_out`` where given (ShardedFields like f and rho/u).
    In the force_field mode ``force`` is the per-site [3, X, Y, Z] force (a
    ShardedField of the plan, or a global tensor split per call) and
    ``force_add`` the [3] body force added at every site; the macro_only
    mode is the u* pass, ``-> (rho0, u0)``.  ``halo``: f's haloed blocks
    when the caller has exchanged them already (the hooked pipeline's two
    passes over one state)."""

    def __call__(self, f, nu, u_in=None, force=None, parity: int = 0, out=None, macro_out=None,
                 force_add=None, halo=None):
        del parity
        ls, n = self.local_step, self.plan.n_shards
        halo = self.exchange(f) if halo is None else halo
        outs, macros = self._outputs(f, out, macro_out)
        forces = self.field_blocks(force) if ls.force_field else [force] * n
        kw = {"force_add": force_add} if ls.force_field else {}
        results = [self._launch(k, halo[k], nu, u_in=u_in, force=forces[k], out=outs[k],
                                macro_out=macros[k], map_arr_in=self.maps.blocks[k], **kw)
                   for k in range(n)]
        if ls.macro_only:
            return self._macro_only(results, macro_out)
        return (self._state(f, results, out),) + tuple(self._macros(results, macro_out))


def make_sharded_fused_step(cfg: LBMConfig, domain: Domain, plan: ShardPlan,
                            with_macro: bool = True, force_field: bool = False,
                            macro_only: bool = False) -> ShardedFusedStepAB:
    """The sharded A-B step through B4 on haloed blocks (JAX
    ``make_sharded_fused_step``; its TPU knobs ``tile`` and
    ``tiles_per_program`` have no counterpart): x/y meshes, a z cut raises
    naming A13b; the force_field and macro_only modes are the hooked
    pipeline's (JAX :847-951)."""
    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step

    plan.check(domain)
    _xy_only(plan, "the sharded A-B step (B4)")
    local_step = make_fused_step(cfg, domain, plan.device(0), with_macro=with_macro,
                                 prepadded=True, local_shape=plan.local_shape(domain),
                                 force_field=force_field, macro_only=macro_only)
    return ShardedFusedStepAB(plan, domain, local_step, 1)


class ShardedFusedStepAA(_ShardedKernelStep):
    """``step(f, nu, u_in=None, force=None, parity=0, out=None, macro_out=None,
    force_add=None) -> (f, rho, u)`` on ShardedFields: parity 0 the even
    step (B2) on every shard's block in place (same-site: no exchange);
    parity 1 the 2-wide x/y halo exchange, then the odd step (B3) on each
    shard's haloed block with its map ring and boundary flags, into ``out``
    where given.  In the force_field mode ``force`` is the per-site [3, X,
    Y, Z] force (a ShardedField or a global tensor) and ``force_add`` the
    [3] body force; the odd step takes the force of each block and its
    1-wide ring from the neighbour shards (JAX :1055-1077: a ring site's
    collision feeds a push into the block, so it takes the neighbour's
    force, not the edge's).  The macro_only mode is the u* pass, ``->
    (rho0, u0)``.  ``halo``: the odd step's haloed blocks of f when the
    caller has exchanged them already."""

    def __init__(self, plan, domain, local_step):
        super().__init__(plan, domain, local_step, 2)
        # each shard's map with its 1-wide x/y ring (neighbours' codes, or the
        # edge replicated on a domain face), and which of its faces are
        # non-periodic faces of the domain (JAX bflags)
        self.rings = self.map_halo(1)
        self.bflags = [_bflags(plan, k) for k in range(plan.n_shards)]

    def force_ring(self, force) -> list:
        """Each shard's force with its 1-wide x/y ring of the neighbours' force
        (the domain's periodicity; edge-replicated on a closed face, where no
        ring site collides)."""
        field = force if isinstance(force, ShardedField) else self.plan.shard_field(
            force, like_f=True)
        return self.exchange(field, width=1)

    def __call__(self, f, nu, u_in=None, force=None, parity: int = 0, out=None, macro_out=None,
                 force_add=None, halo=None):
        ls, n = self.local_step, self.plan.n_shards
        outs, macros = self._outputs(f, out, macro_out)
        kw = {"force_add": force_add} if ls.force_field else {}
        if parity == 0:
            forces = self.field_blocks(force) if ls.force_field else [force] * n
            results = [self._launch(k, f.blocks[k], nu, u_in=u_in, force=forces[k], parity=0,
                                    macro_out=macros[k], map_arr_in=self.maps.blocks[k], **kw)
                       for k in range(n)]
            if ls.macro_only:
                return self._macro_only(results, macro_out)
            return (f,) + tuple(self._macros(results, macro_out))
        if ls.force_field:
            kw["force_ring_in"] = self.force_ring(force)
            force = None
        halo = self.exchange(f) if halo is None else halo
        results = [self._launch(k, halo[k], nu, u_in=u_in, force=force, parity=1, out=outs[k],
                                macro_out=macros[k], map_ring_in=self.rings[k],
                                bflags=self.bflags[k],
                                **{a: (v[k] if a == "force_ring_in" else v) for a, v in kw.items()})
                   for k in range(n)]
        if ls.macro_only:
            return self._macro_only(results, macro_out)
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
    haloed block (JAX ``make_sharded_fused_step_aa``): x/y meshes, a z cut
    raises naming A13b; the force_field mode (with the force ring) and the
    u* pass (macro_only) are the hooked pipeline's."""
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa

    plan.check(domain)
    _xy_only(plan, "the sharded A-A step (B2, B3)")
    if not with_macro:
        raise NotImplementedError("with_macro=False is not ported yet (ROADMAP A7)")
    local_step = make_fused_step_aa(cfg, domain, plan.device(0), prepadded=True,
                                    local_shape=plan.local_shape(domain),
                                    force_field=force_field, macro_only=macro_only)
    return ShardedFusedStepAA(plan, domain, local_step)


# --------------------------------------------------- the NN kernels' steps

class ShardedNNForce(_ShardedKernelStep):
    """``force(rho0, u0, nu) -> F`` on ShardedFields: the NN force of a
    Carreau-Yasuda or Casson model (B9 halo, ``make_nn_force_kernel`` with
    ``prepadded``) on each shard's block of the u* moments, from u0 with a
    2-wide x/y halo and the map with the same halo, both exchanged under the
    hook's periodicity (its own, which may differ from the domain's); the
    block's faces on an axis the hook does not wrap clamp.  The sharded
    hooked pipeline's NN hook: JAX evaluates the hook in XLA on the global
    arrays, which GSPMD partitions."""

    def __init__(self, plan, domain, local_force):
        super().__init__(plan, domain, local_force, 2)
        per = local_force.periodic
        self.nn_periodic = tuple(per) if per is not None else (False,) * 3
        self.map_pads = self.map_halo(2, self.nn_periodic)
        self.bflags = [_bflags(plan, k) for k in range(plan.n_shards)]

    def __call__(self, rho0: ShardedField, u0: ShardedField, nu) -> ShardedField:
        upads = self.exchange(u0, periodic=self.nn_periodic)
        blocks = [self._launch(k, rho0.blocks[k], upads[k], nu, map_pad_in=self.map_pads[k],
                               bflags=self.bflags[k]) for k in range(self.plan.n_shards)]
        return ShardedField(self.plan, blocks, u0.shape)


def make_sharded_nn_force(model, domain: Domain, plan: ShardPlan, periodic=None) -> ShardedNNForce:
    """The NN force of ``model`` with the stencil periodicity ``periodic``
    on the shards' blocks (B9 halo): x/y plans, a z cut raises naming
    A13b."""
    from tnl_lbm_tpu_torch.kernels.fused_nn import make_nn_force_kernel

    plan.check(domain)
    _xy_only(plan, "the sharded NN force (B9)")
    local = make_nn_force_kernel(model, domain, plan.device(0), periodic=periodic,
                                 prepadded=True, local_shape=plan.local_shape(domain))
    return ShardedNNForce(plan, domain, local)


class ShardedFusedNNStep(_ShardedKernelStep):
    """``step(f, nu, u_in=None, force=None, parity=0, out=None, macro_out=None)
    -> (f_new, rho, u)`` on ShardedFields: the one-kernel NN step (B10 halo,
    ``make_fused_nn_step`` with ``prepadded``) on each shard's block, fed by
    one halo exchange of f per step, as wide as the mode's stencil chain
    reads (3 A-B, 2 even, 4 odd: ``fused_nn_step.HALO_WIDTHS``), with the
    map's halo of that width (made once) and the face flags that gate the
    in-kernel edge fixes on the closed faces.  Out of place in every mode,
    as the unsharded step; a homogeneous [3] body force only (JAX
    ``make_sharded_fused_nn_step``)."""

    def __init__(self, plan, domain, local_step):
        super().__init__(plan, domain, local_step, None)
        self.bflags = [_bflags(plan, k) for k in range(plan.n_shards)]

    def __call__(self, f, nu, u_in=None, force=None, parity: int = 0, out=None, macro_out=None):
        ls = self.local_step
        w = ls.halo_width(parity)
        halo = self.exchange(f, width=w)
        mpads = self.map_halo(w)
        outs, macros = self._outputs(f, out, macro_out)
        results = [self._launch(k, halo[k], nu, u_in=u_in, force=force, parity=parity,
                                out=outs[k], macro_out=macros[k], map_pad_in=mpads[k],
                                bflags=self.bflags[k])
                   for k in range(self.plan.n_shards)]
        return (self._state(f, results, out),) + tuple(self._macros(results, macro_out))


def make_sharded_fused_nn_step(cfg: LBMConfig, domain: Domain, plan: ShardPlan, model,
                               nn_periodic, with_macro: bool = True) -> ShardedFusedNNStep:
    """The sharded one-kernel NN step (JAX ``make_sharded_fused_nn_step``;
    its TPU knobs ``tile`` and ``tiles_per_program`` have no counterpart):
    x/y plans that divide the lattice, a z cut raises naming A13b."""
    from tnl_lbm_tpu_torch.kernels.fused_nn_step import make_fused_nn_step

    plan.check(domain)
    _xy_only(plan, "the sharded one-kernel NN step (B10)")
    local = make_fused_nn_step(cfg, domain, model, nn_periodic, plan.device(0),
                               with_macro=with_macro, prepadded=True,
                               local_shape=plan.local_shape(domain))
    return ShardedFusedNNStep(plan, domain, local)


# ---------------------------------------------- the 2D and ADE kernels' steps

class ShardedFusedStep2D(_ShardedKernelStep):
    """``step(f, nu, u_in=None, force=None, parity=0, out=None, macro_out=None,
    force_add=None) -> (f_new, rho, u)`` on ShardedFields of the D2Q9
    lattice: per step the 1-wide x/y halo exchange, then the D2Q9 step (B5)
    on each shard's haloed block (``make_fused_step_2d`` with
    ``local_shape``), with the block's map and Bouzidi thetas (sharded once)
    and its view of a per-site inflow profile.  ``force`` is a [2] vector,
    or in the force_field variant the per-site [2, X, Y] force (a
    ShardedField of the plan, or a global tensor split per call) with the
    [2] vector ``force_add``.  ``halo``: the exchange of f already made
    (the sharded hooked step's u* pass reads it too)."""

    def __init__(self, plan, domain, local_step):
        super().__init__(plan, domain, local_step, 1)
        self.thetas = (plan.shard_field(np.ascontiguousarray(domain.bouzidi, np.float32),
                                        like_f=True) if local_step.has_thetas else None)
        #: (a profile's identity, the profile, each shard's view or copy of it):
        #: holding the profile keeps its address from being reused by another
        self._profiles = (None, None, None)

    def _profile_blocks(self, u_in) -> list:
        """Each shard's view of a per-site inflow profile (a [2, ...] tensor or
        host array broadcasting to [2, X, Y]); a [2] vector or None as it is."""
        n = self.plan.n_shards
        if u_in is None or not _is_field(u_in):
            return [u_in] * n
        t = u_in if torch.is_tensor(u_in) else torch.as_tensor(np.asarray(u_in))
        t = t.to(torch.float32)
        t = t.reshape((2,) + (1,) * (3 - t.dim()) + tuple(t.shape[1:])).expand(
            (2,) + tuple(self.domain.shape))
        key = (t.device, t.data_ptr(), t._version, t.stride())
        if self._profiles[0] != key:  # a view on the shard's device, else a copy kept
            views = [t[(slice(None),) + _block_of(self.plan, k, self.local_step.shape)]
                     for k in range(n)]
            self._profiles = (key, t, [v if v.device == self.plan.device(k) else
                                       v.to(self.plan.device(k)) for k, v in enumerate(views)])
        return self._profiles[2]

    def __call__(self, f, nu, u_in=None, force=None, parity: int = 0, out=None, macro_out=None,
                 force_add=None, halo=None):
        del parity
        halo = self.exchange(f) if halo is None else halo
        outs, macros = self._outputs(f, out, macro_out)
        profs = self._profile_blocks(u_in)
        forces = (self.field_blocks(force) if self.local_step.force_field
                  else [force] * self.plan.n_shards)
        results = [self._launch(k, halo[k], nu, u_in=profs[k], force=forces[k], out=outs[k],
                                macro_out=macros[k], force_add=force_add,
                                map_arr_in=self.maps.blocks[k],
                                bouzidi_arr_in=None if self.thetas is None
                                else self.thetas.blocks[k])
                   for k in range(self.plan.n_shards)]
        return (self._state(f, results, out),) + tuple(self._macros(results, macro_out))


def make_sharded_fused_step_2d(cfg: LBMConfig, domain: Domain, plan: ShardPlan,
                               force_field: bool = False) -> ShardedFusedStep2D:
    """The sharded D2Q9 step through B5 on haloed blocks (JAX
    ``make_sharded_fused_step_2d``): an x/y plan that divides the lattice
    (``_make_uneven_sharded_step`` wraps it for one that does not).  The
    D2Q9 pull, Bouzidi's read one link off the wall and OUTFLOW_RIGHT's x-1
    pull are one deep and read f alone, so one exchanged f ring serves, and
    the kernel computes the block's sites only (the JAX kernel computes the
    ring's too and crops them).  A config B5 refuses raises (ROADMAP §C)."""
    from tnl_lbm_tpu_torch.kernels.fused_2d import make_fused_step_2d

    if domain.lat.D != 2:
        raise ValueError("the sharded D2Q9 step is the 2D lattice's")
    plan.check(domain)
    local_step = make_fused_step_2d(cfg, domain, plan.device(0), force_field=force_field,
                                    local_shape=plan.local_shape(domain))
    return ShardedFusedStep2D(plan, domain, local_step)


class ShardedFusedStepADE(_ShardedKernelStep):
    """``step(g, u, nu, phi_in=0.0, out=None) -> (g_new, phi)`` on
    ShardedFields of the D3Q7 lattice: per step the halo exchange, 2 wide
    on x (OUTFLOW_PE pulls x-2) and 1 wide on y, then the ADE step (B6) on
    each shard's haloed block (``make_fused_ade_step`` with ``prepadded``)
    with the block's map and packed transfer flags (from the global map,
    sharded once) and its part of ``u`` (the NSE step's sharded velocity).
    ``nu`` is a scalar, or a per-site field: a ShardedField of the plan, or
    a global [X, Y, Z] tensor, sharded at its first call and kept."""

    def __init__(self, plan, domain, local_step):
        from tnl_lbm_tpu_torch.kernels.fused_ade import pack_transfer_flags

        super().__init__(plan, domain, local_step, (2, 1))
        self.tflags = (plan.shard_field(pack_transfer_flags(domain.lat, domain.map)
                                        .astype(np.uint8), like_f=False)
                       if local_step.has_transfer else None)
        self._nu = None  # (a global nu field, its blocks)

    def _nu_blocks(self, nu) -> list:
        if isinstance(nu, ShardedField):
            return nu.blocks
        if not torch.is_tensor(nu) or nu.dim() == 0:
            return [nu] * self.plan.n_shards
        if self._nu is None or self._nu[0] is not nu:
            self._nu = (nu, self.plan.shard_field(nu, like_f=False).blocks)
        return self._nu[1]

    def __call__(self, g, u, nu, phi_in=0.0, out=None):
        halo = self.exchange(g)
        n = self.plan.n_shards
        outs = out.blocks if out is not None else [None] * n
        nus = self._nu_blocks(nu)
        results = [self._launch(k, halo[k], u.blocks[k], nus[k], phi_in=phi_in, out=outs[k],
                                map_arr_in=self.maps.blocks[k],
                                tflags_in=None if self.tflags is None else self.tflags.blocks[k])
                   for k in range(n)]
        S = self.domain.shape
        g_new = out if out is not None else ShardedField(self.plan, [r[0] for r in results],
                                                         g.shape, g.padded)
        return g_new, ShardedField(self.plan, [r[1] for r in results], S)


def make_sharded_fused_ade_step(cfg: LBMConfig, domain: Domain, plan: ShardPlan,
                                variable_diffusion: bool = False,
                                transfer_coeff: float = 0.0) -> ShardedFusedStepADE:
    """The sharded ADE step through B6 on haloed blocks (JAX
    ``make_sharded_fused_ade_step``; its TPU knobs ``tile`` and
    ``tiles_per_program`` have no counterpart): an x/y plan that divides the
    lattice, A-B streaming; a z cut raises (naming A13b), and so does a
    local x width under 2 (the 2-wide x halo comes from one neighbour)."""
    from tnl_lbm_tpu_torch.kernels.fused_ade import make_fused_ade_step

    plan.check(domain)
    _xy_only(plan, "the sharded ADE step (B6)")
    local = plan.local_shape(domain)
    if plan.counts[0] > 1 and local[0] < 2:
        raise NotImplementedError(f"the sharded ADE step needs a local x width of 2 or more, "
                                  f"got {local[0]}")
    local_step = make_fused_ade_step(cfg, domain, plan.device(0),
                                     variable_diffusion=variable_diffusion,
                                     transfer_coeff=transfer_coeff, prepadded=True,
                                     local_shape=local)
    return ShardedFusedStepADE(plan, domain, local_step)


# ------------------------------------------------------------ the sharded pair

def _pad_layout(plan: ShardPlan, domain: Domain) -> tuple:
    """(the shape of one shard's haloed block [Q, Xl+4, Yl+4, Z], the global
    shape of their concatenation [Q, nx (Xl+4), ny (Yl+4), Z])."""
    Xl, Yl, Z = plan.local_shape(domain)
    nx, ny = plan.counts[:2]
    Q = domain.lat.Q
    return (Q, Xl + 4, Yl + 4, Z), (Q, nx * (Xl + 4), ny * (Yl + 4), Z)


def _pair_plan(plan: ShardPlan, domain: Domain, what: str) -> None:
    """The sharded pair takes divisible x/y plans of the 3D lattice (JAX
    ``_pair_dispatch_capable``: ``plan.divisible``)."""
    if domain.lat.D != 3:
        raise NotImplementedError(f"{what} is the 3D A-A pair's")
    _xy_only(plan, what)
    if not plan.divisible(domain):
        raise NotImplementedError(f"{what} on a lattice the mesh does not divide is not ported "
                                  f"({A13B}; the JAX pair needs plan.divisible too)")


def to_padded_aa_sharded(f: ShardedField, plan: ShardPlan, domain: Domain, store_dtype=None,
                         out: ShardedField | None = None) -> ShardedField:
    """Plain sharded [Q, X, Y, Z] -> per-shard haloed blocks [Q, Xl+4,
    Yl+4, Z] in the store dtype (``store_dtype``: narrowed as ``to_storage``
    does; None keeps f's), their halos the blocks' edge layers until the
    pair refreshes them (JAX ``to_padded_aa_sharded``; its y pad of 8 and
    its lane pad are the TPU's and not ported).  ``out``: blocks of that
    layout to write into."""
    _pair_plan(plan, domain, "the sharded pair's layout")
    block, whole = _pad_layout(plan, domain)
    dtype = f.dtype if store_dtype is None else store_dtype
    if out is None:
        out = ShardedField(plan, [torch.empty(block, dtype=dtype, device=plan.device(k))
                                  for k in range(plan.n_shards)], whole)
    for b, p in zip(f.blocks, out.blocks):
        p[:, 2:-2, 2:-2].copy_(b)  # narrowed by the copy (round to nearest even)
        p[:, :2] = p[:, 2:3]
        p[:, -2:] = p[:, -3:-2]
        p[:, :, :2] = p[:, :, 2:3]
        p[:, :, -2:] = p[:, :, -3:-2]
    return out


def from_padded_aa_sharded(fpad: ShardedField, plan: ShardPlan, domain: Domain, dtype=None,
                           out: ShardedField | None = None) -> ShardedField:
    """The inverse of ``to_padded_aa_sharded``: each block's interior,
    widened to ``dtype`` where given (JAX ``from_padded_aa_sharded``), into
    ``out`` (a plain sharded state) where given."""
    if out is None:
        out = ShardedField(plan, [torch.empty(b[:, 2:-2, 2:-2].shape,
                                              dtype=dtype or b.dtype, device=b.device)
                                  for b in fpad.blocks], (domain.lat.Q,) + domain.shape)
    for p, b in zip(fpad.blocks, out.blocks):
        b.copy_(p[:, 2:-2, 2:-2])
    return out


class ShardedFusedPairAA(_ShardedKernelStep):
    """``pair(fpad, nu, u_in=None, force=None, out=None, macro_out=None) ->
    (fpad_new, rho, u)`` on ShardedFields of haloed blocks
    (``to_padded_aa_sharded``): two A-A steps per call.  Each call refreshes
    the 2-wide x/y halo slabs of ``fpad``'s blocks in place (x first, then
    y, the y slabs spanning the filled x halos, so corners route; a single
    shard's periodic axis wraps its own edges, a non-periodic domain face
    replicates the edge layer), then launches the pair's haloed mode on each
    shard's block with its card current, into ``out`` (a second set of
    haloed blocks) where given: the blocks' interiors, never their halos.
    The maps with their 2-wide halos are made once (``pad_maps``), as are
    each buffer set's slab copies.  A 16-bit state moves 16-bit slabs."""

    def __init__(self, plan, domain, local_pair):
        super().__init__(plan, domain, local_pair, 2)
        #: each shard's map with the neighbours' codes in its 2-wide halo
        self.pad_maps = self.map_halo(2)
        self.bflags = [_bflags(plan, k) for k in range(plan.n_shards)]
        self.store_dtype = getattr(local_pair, "store_dtype", local_pair.cfg.compute_dtype)

    def exchange(self, fpad: ShardedField) -> list:
        """Refresh the halo slabs of ``fpad``'s blocks in place; returns them."""
        key = tuple(b.data_ptr() for b in fpad.blocks)
        copies = self._copies.get(key)
        if copies is None:
            inner = [b[:, 2:-2, 2:-2] for b in fpad.blocks]
            copies = _halo_copies(self.plan, inner, fpad.blocks, 2, (0, 1), self.domain.periodic,
                                  interior=False)
            self._copies[key] = copies
            while len(self._copies) > 2:
                self._copies.popitem(last=False)
        for dst, src in copies:
            dst.copy_(src)
        return fpad.blocks

    def __call__(self, fpad, nu, u_in=None, force=None, out=None, macro_out=None):
        self.exchange(fpad)
        outs, macros = self._outputs(fpad, out, macro_out)
        results = [self._launch(k, fpad.blocks[k], nu, u_in=u_in, force=force, out=outs[k],
                                macro_out=macros[k], map_pad_in=self.pad_maps[k],
                                bflags=self.bflags[k])
                   for k in range(self.plan.n_shards)]
        return (self._state(fpad, results, out),) + tuple(self._macros(results, macro_out))

    def pad(self, f: ShardedField, out: ShardedField | None = None) -> ShardedField:
        """``f`` in this pair's layout and store dtype (``to_padded_aa_sharded``)."""
        store = None if self.store_dtype == f.dtype else self.store_dtype
        return to_padded_aa_sharded(f, self.plan, self.domain, store, out)

    def unpad(self, fpad: ShardedField, out: ShardedField | None = None) -> ShardedField:
        """The plain sharded state of ``fpad``, widened to the compute dtype."""
        return from_padded_aa_sharded(fpad, self.plan, self.domain,
                                      self.local_step.cfg.compute_dtype, out)


def make_sharded_fused_pair2_aa(cfg: LBMConfig, domain: Domain, plan: ShardPlan,
                                with_macro: bool = True, store_dtype=None) -> ShardedFusedPairAA:
    """The sharded A-A pair (JAX ``make_sharded_fused_pair2_aa``): two steps
    per call on persistent haloed blocks, the halos exchanged once per two
    steps.  The local kernel is the one pair dispatch runs
    (``fused_aa.make_dispatch_pair``): B1 in its store dtype on a map of
    FLUID/WALL/NOTHING under CUM_WELL, else B1b's cumulant instances, each
    in its haloed mode.  x/y meshes that divide the lattice; a z cut, an
    uneven plan and B1b's family collisions raise naming A13b.  The JAX
    function's TPU knobs (``tile``, ``tiles_per_program``) have no
    counterpart."""
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_dispatch_pair

    _pair_plan(plan, domain, "the sharded A-A pair (B1, B1b)")
    local = make_dispatch_pair(cfg, domain, plan.device(0), store_dtype=store_dtype,
                               with_macro=with_macro, prepadded=True,
                               local_shape=plan.local_shape(domain))
    return ShardedFusedPairAA(plan, domain, local)
