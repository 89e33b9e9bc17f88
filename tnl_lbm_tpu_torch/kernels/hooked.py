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
the kernel.  The sharded hooked step (``make_sharded_hooked_fused_step``)
is ROADMAP A13b.
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


def make_hooked_fused_step(cfg: LBMConfig, domain: Domain, device,
                           single_kernel: bool = True) -> HookedStep:
    """The kernel-path step of a config with ``forcing_hook`` set: see
    :class:`HookedStep`.  ``single_kernel=False`` keeps the pipeline, so
    that a test can pin a route (the JAX function's option of the same
    name).  The JAX ``pallas_hook=False`` (the NN hook in XLA while its
    kernel exists) and its TPU tiling knobs have no counterpart here: an NN
    hook on D3Q27 always runs B9 on the pipeline."""
    return HookedStep(cfg, domain, device, single_kernel=single_kernel)
