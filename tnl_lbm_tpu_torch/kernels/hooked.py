"""Forcing-hook configs (non-Newtonian, IBM) on the kernel path.

Counterpart of ``tnl_lbm_tpu/kernels/hooked.py`` ``make_hooked_fused_step``.
The reference folds per-site forcing into its production kernel through
macro force channels: a pre-kernel computes u* (kernels.h:178-218), the hook
(the non-Newtonian stress kernels, the IBM force solve) fills the channels,
and the main kernel consumes them (kernels.h:92).  A hooked step here takes
one of two routes, as the JAX package picks them (from the hook and the
map, never the collision: every kernel of both routes has an instance of
each D3Q27 collision of ``kernels/fused.py step_instance``):

- **single kernel** (B10, ``kernels/fused_nn_step.py``): a hook made by
  ``make_nn_forcing_hook`` on a D3Q27 domain that ``fused_nn_step.supports``
  takes, with a homogeneous (or no) body force - the whole step is one
  launch per parity;
- **pipeline**, three phases per step otherwise:

  1. the u* pass: the ``macro_only`` variant of the pattern's step kernel
     (B4, or B2/B3 by parity); on D2Q9 the plain ``make_step(...).ustar``,
     as in the JAX package;
  2. the hook: the NN force kernel (B9, ``kernels/fused_nn.py``) for a
     ``make_nn_forcing_hook`` hook on D3Q27, else the hook itself as
     plain tensor ops (IBM-style hooks, 2D), which the JAX package runs in
     XLA;
  3. the ``force_field`` variant of the step kernel (B4, B2/B3 or B5) with
     the hook's output as the per-site force and the body force added at
     every site in the kernel (``force_add``), so no pass sums the two.

The TPU pipeline's shared halo pad (``share_pad``, ``prepadded``,
``_pad_once``) has no counterpart: the port's kernels clamp and wrap in
the kernel.

Under a plan (``make_sharded_hooked_fused_step``, JAX ``hooked.py:245-404``,
the reference's multi-GPU hooked kernels, state.hpp:995-1015) the same
routes run on the shards' haloed blocks: the single kernel as B10 halo
(``parallel/sharded.py make_sharded_fused_nn_step``) on a plan that leaves z
uncut; the pipeline as B4 halo's or B2's and B3 halo's macro_only pass, the
hook - B9 halo on each block (``make_sharded_nn_force``) for an NN hook,
where JAX runs the hook in XLA on the global arrays; a ``shard_local`` hook
(IBM's ``sharded_hook``) on the shards' blocks; any other hook on the
lattice gathered on the plan's first device - then the force_field pass
(B3 halo with the force ring on the odd step); in 2D the plain u* pass on
each shard's block from B5 halo's exchange of f (JAX's 2D route runs the
plain u* pass too), the hook as in 3D, then B5 halo's force_field mode on
that exchange.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tnl_lbm_tpu_torch.kernels import fused_nn_step
from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
from tnl_lbm_tpu_torch.kernels.fused_2d import make_fused_step_2d
from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa
from tnl_lbm_tpu_torch.kernels.fused_nn import make_nn_force_kernel
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.step import make_step

def _is_field(force) -> bool:
    """A per-site body force ([D, *S]) rather than a [D] vector."""
    if force is None:
        return False
    return (force.ndim if torch.is_tensor(force) else np.ndim(force)) > 1


class HookedStep:
    """``step(f, nu, u_in=None, force=None, parity=0, out=None, hook_consts=None,
    macro_out=None) -> (f_new, rho, u)``: one hooked step, matching
    ``sim.step.make_step(cfg, domain)`` (the plain hooked step,
    :meth:`plain`) to float tolerance.

    ``force`` is the body force, a [D] host vector or a [D, *S] field on
    f's device; the hook's output is added to it.  ``out`` (a second state
    buffer) is where a step that writes out of place puts the state: the
    A-B and 2D steps, the single-kernel route and the A-A pipeline's odd
    parity (its even parity updates f in place); rho and u of the step go
    into ``macro_out`` (a pair of buffers) when given.  ``route`` names the route built;
    ``kernels`` lists the kernel wrappers of the routes, whose counts
    ``reset_counts`` zeroes and ``plain_calls`` sums.
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, device, single_kernel: bool = True):
        hook = cfg.forcing_hook
        if hook is None:
            raise ValueError("a config without a forcing hook takes make_fused_step / "
                             "make_fused_step_aa / make_fused_step_2d")
        self.cfg, self.domain, self.hook = cfg, domain, hook
        self.lat = cfg.lat
        self.device = torch.device(device)
        self.has_consts = getattr(hook, "consts", None) is not None
        cfg_nohook = dataclasses.replace(cfg, forcing_hook=None)
        nn_model = getattr(hook, "nn_model", None)
        nn_periodic = getattr(hook, "nn_periodic", None)
        D = self.lat.D
        # each route's wrapper checks its instance of cfg's collision
        # (kernels/fused.py step_instance) and raises naming its kernel
        self.nn_single = None
        if (single_kernel and D == 3 and nn_model is not None
                and fused_nn_step.supports(cfg, domain, nn_periodic)):
            self.nn_single = fused_nn_step.make_fused_nn_step(cfg, domain, nn_model,
                                                              nn_periodic, self.device)
        self.macro = self.ustar_plain = None
        if D == 2:
            self.base = make_fused_step_2d(cfg_nohook, domain, self.device, force_field=True)
            self.ustar_plain = make_step(cfg_nohook, domain).ustar
        elif cfg.streaming == "AA":
            self.base = make_fused_step_aa(cfg_nohook, domain, self.device, force_field=True)
            self.macro = make_fused_step_aa(cfg_nohook, domain, self.device, macro_only=True)
        else:
            self.base = make_fused_step(cfg_nohook, domain, self.device, force_field=True)
            self.macro = make_fused_step(cfg_nohook, domain, self.device, macro_only=True)
        self.nn_force = None
        if nn_model is not None and D == 3:
            self.nn_force = make_nn_force_kernel(nn_model, domain, self.device,
                                                 periodic=nn_periodic)
        self.fluid = torch.as_tensor(np.asarray(domain.map) == int(GEO.FLUID), device=self.device)
        self.route = "single_kernel" if self.nn_single is not None else "pipeline"
        self.kernels = [k for k in (self.nn_single, self.macro, self.nn_force, self.base)
                        if k is not None]
        self._plain_step = None

    def reset_counts(self) -> None:
        for k in self.kernels:
            k.reset_counts()

    @property
    def plain_calls(self) -> int:
        return sum(k.plain_calls for k in self.kernels)

    def _single(self, force) -> bool:
        return self.nn_single is not None and not _is_field(force)

    def __call__(self, f, nu, u_in=None, force=None, parity: int = 0, out=None,
                 hook_consts=None, macro_out=None):
        if self._single(force):
            return self.nn_single(f, nu, u_in=u_in, force=force, parity=parity, out=out,
                                  macro_out=macro_out)
        extra = self._extra(f, nu, force, parity, hook_consts)
        return self._main(f, nu, u_in, force, parity, extra, out, macro_out)

    def _ustar(self, f, force, parity):
        """Phase 1: (rho0, u0, fluid)."""
        if self.macro is None:
            return self.ustar_plain(f, force=force, parity=parity)
        if _is_field(force):
            # a body-force field: the u* kernel takes vectors, so fold the
            # half-force correction in afterwards (JAX hooked.py:140-144)
            rho0, u0 = self.macro(f, 0.0, parity=parity)
            fb = torch.as_tensor(force, dtype=u0.dtype, device=u0.device)
            u0 = u0 + fb / (2 * torch.clamp_min(rho0, 1e-12))
        else:
            rho0, u0 = self.macro(f, 0.0, force=force, parity=parity)
        return rho0, u0, self.fluid

    def _hook(self, rho0, u0, nu, fluid, hook_consts):
        """Phase 2: the hook's per-site force."""
        if self.nn_force is not None:
            return self.nn_force(rho0, u0, nu)
        kw = {"consts": hook_consts} if self.has_consts else {}
        return self.hook(self.lat, rho0, u0, nu, fluid, **kw).to(self.cfg.compute_dtype)

    def _extra(self, f, nu, force, parity, hook_consts):
        rho0, u0, fluid = self._ustar(f, force, parity)
        extra = self._hook(rho0, u0, nu, fluid, hook_consts)
        if _is_field(force):
            extra = torch.as_tensor(force, dtype=extra.dtype, device=extra.device) + extra
        return extra.contiguous()

    def _main(self, f, nu, u_in, force, parity, extra, out, macro_out=None):
        """Phase 3: the force_field kernel, the body force added at every site."""
        force_add = None if (force is None or _is_field(force)) else force
        return self.base(f, nu, u_in=u_in, force=extra, force_add=force_add, parity=parity,
                         out=out, macro_out=macro_out)

    def plain(self, f, nu, u_in=None, force=None, parity: int = 0, hook_consts=None):
        """The plain hooked step (``sim/step.py``) on f's device: the oracle
        both routes are held against; f untouched."""
        if self._plain_step is None:
            self._plain_step = make_step(self.cfg, self.domain)
        return self._plain_step(f, nu, u_in=u_in, force=force, parity=parity,
                                hook_consts=hook_consts)

    def phase_times(self, f, nu, force=None, parity: int = 0, repeats: int = 3) -> dict:
        """Per-phase times of the hooked step on the state ``f``, in ms, the
        least of ``repeats`` (after one warm-up call each): "single_kernel"
        on the single-kernel route, else "ustar", "hook" and "main_kernel".
        CUDA events on a card, the host clock on the CPU.  Each phase runs
        on its own; f is left as it is (the in-place A-A even update runs
        on a copy).  The launches count as any other."""

        def best(fn):
            fn()
            times = []
            for _ in range(repeats):
                if f.device.type == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    fn()
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                else:
                    t0 = time.perf_counter()
                    fn()
                    times.append((time.perf_counter() - t0) * 1e3)
            return min(times)

        if self._single(force):
            return {"single_kernel": best(lambda: self.nn_single(f, nu, force=force,
                                                                 parity=parity))}
        consts = getattr(self.hook, "consts", None)
        out = {"ustar": best(lambda: self._ustar(f, force, parity))}
        rho0, u0, fluid = self._ustar(f, force, parity)
        out["hook"] = best(lambda: self._hook(rho0, u0, nu, fluid, consts))
        extra = self._extra(f, nu, force, parity, consts)
        work = f.clone() if self.cfg.streaming == "AA" and parity == 0 else f
        out["main_kernel"] = best(lambda: self._main(work, nu, None, force, parity, extra, None))
        return out


class ShardedHookedStep:
    """``step(f, nu, u_in=None, force=None, parity=0, out=None, hook_consts=None,
    macro_out=None) -> (f_new, rho, u)`` on ShardedFields of ``plan``: one
    hooked step through the sharded routes (module docstring), matching the
    plain sharded hooked step (``parallel/sharded.py make_sharded_step``) to
    float tolerance and, per route, the unsharded :class:`HookedStep` on the
    same state bit for bit where the hook's sums do not cross the shards.
    ``force`` is the body force, a [D] host vector or a [D, *S] field (a
    ShardedField of the plan, or a global tensor); ``out`` and
    ``macro_out`` as :class:`HookedStep`'s, ShardedFields.  ``route``,
    ``kernels``, ``reset_counts`` and ``plain_calls`` as
    :class:`HookedStep`'s; ``padded_shape`` is the extent the fields tile."""

    def __init__(self, cfg: LBMConfig, domain: Domain, plan, single_kernel: bool = True):
        from tnl_lbm_tpu_torch.parallel import sharded as sh

        hook = cfg.forcing_hook
        if hook is None:
            raise ValueError("a config without a forcing hook takes the sharded kernel steps")
        self.cfg, self.domain, self.plan, self.hook = cfg, domain, plan, hook
        self.lat = cfg.lat
        self.has_consts = getattr(hook, "consts", None) is not None
        self.shard_local = bool(getattr(hook, "shard_local", False))
        cfg_nohook = dataclasses.replace(cfg, forcing_hook=None)
        nn_model = getattr(hook, "nn_model", None)
        nn_periodic = getattr(hook, "nn_periodic", None)
        D = self.lat.D
        self.nn_single = None
        if (single_kernel and D == 3 and nn_model is not None and plan.counts[2] == 1
                and fused_nn_step.supports(cfg, domain, nn_periodic)):
            self.nn_single = sh.make_sharded_fused_nn_step(cfg, domain, plan, nn_model,
                                                           nn_periodic)
        self.macro = self.ustar_plain = self.maps = None
        if D == 2:
            self.base = sh.make_sharded_fused_step_2d(cfg_nohook, domain, plan, force_field=True)
            self.ustar_plain = make_step(cfg_nohook, domain,
                                         local_shape=plan.local_shape(domain)).ustar
            self.maps = plan.shard_field(np.asarray(domain.map).astype(np.int64), like_f=False)
        else:
            builder = (sh.make_sharded_fused_step_aa if cfg.streaming == "AA"
                       else sh.make_sharded_fused_step)
            self.base = builder(cfg_nohook, domain, plan, force_field=True)
            self.macro = builder(cfg_nohook, domain, plan, macro_only=True)
        self.nn_force = None
        if nn_model is not None and D == 3:
            self.nn_force = sh.make_sharded_nn_force(nn_model, domain, plan, nn_periodic)
        self.fluid = plan.shard_field(np.asarray(domain.map) == int(GEO.FLUID), like_f=False)
        self.route = "single_kernel" if self.nn_single is not None else "pipeline"
        self.kernels = [k.local_step for k in (self.nn_single, self.macro, self.nn_force,
                                               self.base) if k is not None]
        self.padded_shape = domain.shape
        self._ustar_out = None  # the u* pass's ShardedFields, kept across steps

    def reset_counts(self) -> None:
        for k in self.kernels:
            k.reset_counts()

    @property
    def plain_calls(self) -> int:
        return sum(k.plain_calls for k in self.kernels)

    def _single(self, force) -> bool:
        return self.nn_single is not None and not _is_field(force)

    def __call__(self, f, nu, u_in=None, force=None, parity: int = 0, out=None,
                 hook_consts=None, macro_out=None):
        if self._single(force):
            return self.nn_single(f, nu, u_in=u_in, force=force, parity=parity, out=out,
                                  macro_out=macro_out)
        fields = self._force_blocks(force)
        # the u* pass and the force_field pass read one haloed state: one exchange
        halo = (self.base.exchange(f) if self.cfg.streaming == "AB" or parity == 1 else None)
        extra = self._extra(f, nu, force, fields, parity, hook_consts, halo)
        force_add = None if (force is None or fields is not None) else force
        return self.base(f, nu, u_in=u_in, force=extra, force_add=force_add, parity=parity,
                         out=out, macro_out=macro_out, halo=halo)

    def _force_blocks(self, force):
        """A body-force field's blocks (None for a vector or no force)."""
        from tnl_lbm_tpu_torch.parallel.sharded import ShardedField

        if not _is_field(force):
            return None
        if isinstance(force, ShardedField):
            return force.blocks
        t = torch.as_tensor(force, dtype=self.cfg.compute_dtype)
        t = t.reshape((self.lat.D,) + (1,) * (self.lat.D + 1 - t.dim()) + tuple(t.shape[1:]))
        return self.plan.shard_field(t.expand((self.lat.D,) + tuple(self.domain.shape))
                                     .contiguous(), like_f=True).blocks

    def _ustar(self, f, force, fields, parity, halo=None):
        """Phase 1: (rho0, u0) as ShardedFields."""
        from tnl_lbm_tpu_torch.parallel.sharded import ShardedField

        plan, S = self.plan, self.domain.shape
        if self.macro is None:  # 2D: the plain u* pass on each haloed block
            th, dt = self.base.thetas, self.cfg.compute_dtype
            parts = [self.ustar_plain(b, force=force if fields is None else fields[k],
                                      parity=parity, map_arr=self.maps.blocks[k],
                                      bouzidi_arr=None if th is None else th.blocks[k].to(dt),
                                      fpad=halo[k])
                     for k, b in enumerate(f.blocks)]
            return (ShardedField(plan, [q[0] for q in parts], S),
                    ShardedField(plan, [q[1] for q in parts], (self.lat.D,) + S))
        if self._ustar_out is None:
            self._ustar_out = (ShardedField(plan, [torch.empty(b.shape[1:], dtype=b.dtype,
                                                               device=b.device)
                                                   for b in f.blocks], S),
                               ShardedField(plan, [torch.empty((3,) + tuple(b.shape[1:]),
                                                               dtype=b.dtype, device=b.device)
                                                   for b in f.blocks], (3,) + S))
        if fields is not None:
            # a body-force field: the u* kernel takes vectors, so fold the
            # half-force correction in afterwards (JAX hooked.py:386-389)
            rho0, u0 = self.macro(f, 0.0, parity=parity, macro_out=self._ustar_out, halo=halo)
            for r, u, fb in zip(rho0.blocks, u0.blocks, fields):
                u.copy_(u + fb.to(u) / (2 * torch.clamp_min(r, 1e-12)))
            return rho0, u0
        return self.macro(f, 0.0, force=force, parity=parity, macro_out=self._ustar_out,
                          halo=halo)

    def _hook(self, rho0, u0, nu, hook_consts):
        """Phase 2: the hook's per-site force, a ShardedField or a global
        tensor (a hook evaluated on the gathered lattice)."""
        from tnl_lbm_tpu_torch.parallel.sharded import ShardedField, _blocks_of, _padded_global

        if self.nn_force is not None:
            return self.nn_force(rho0, u0, nu)
        kw = {"consts": hook_consts} if self.has_consts else {}
        dt = self.cfg.compute_dtype
        if self.shard_local:
            out = _blocks_of(self.hook(self.lat, rho0, u0, nu, self.fluid, **kw))
            return ShardedField(self.plan, [b.to(dt).contiguous() for b in out], u0.shape)
        dev = self.plan.device(0)
        rho0, u0 = _padded_global(rho0, dev), _padded_global(u0, dev)
        return self.hook(self.lat, rho0, u0, nu, _padded_global(self.fluid, dev), **kw).to(dt)

    def _extra(self, f, nu, force, fields, parity, hook_consts, halo=None):
        from tnl_lbm_tpu_torch.parallel.sharded import ShardedField

        rho0, u0 = self._ustar(f, force, fields, parity, halo)
        extra = self._hook(rho0, u0, nu, hook_consts)
        if fields is None:
            return extra
        blocks = (extra.blocks if isinstance(extra, ShardedField)
                  else self.plan.shard_field(extra, like_f=True).blocks)
        return ShardedField(self.plan, [(fb.to(e) + e).contiguous()
                                        for fb, e in zip(fields, blocks)], u0.shape)


def make_sharded_hooked_fused_step(cfg: LBMConfig, domain: Domain, plan,
                                   single_kernel: bool = True) -> ShardedHookedStep:
    """The kernel-path step of a hooked config under a plan (JAX
    ``make_sharded_hooked_fused_step``, which reads ``single_kernel`` the
    same way: False keeps the pipeline): see :class:`ShardedHookedStep`.
    x/y plans that divide the lattice (``_make_uneven_sharded_step`` wraps
    it for one that does not, A-B); a z cut raises naming ROADMAP A13b."""
    return ShardedHookedStep(cfg, domain, plan, single_kernel=single_kernel)


def make_hooked_fused_step(cfg: LBMConfig, domain: Domain, device,
                           single_kernel: bool = True) -> HookedStep:
    """The kernel-path step of a config with ``forcing_hook`` set: see
    :class:`HookedStep`.  ``single_kernel=False`` keeps the pipeline, so
    that a test can pin a route (the JAX function's option of the same
    name).  The JAX ``pallas_hook=False`` (the NN hook in XLA while its
    kernel exists) and its TPU tiling knobs have no counterpart here: an NN
    hook on D3Q27 always runs B9 on the pipeline."""
    return HookedStep(cfg, domain, device, single_kernel=single_kernel)
