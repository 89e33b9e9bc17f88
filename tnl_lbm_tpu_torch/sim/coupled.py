"""Coupled NSE + ADE dual-lattice simulation driver (counterpart of
``tnl_lbm_tpu/sim/coupled.py``; reference ``State_NSE_ADE``,
state_NSE_ADE.h:3-468).

Two lattices advance in lock-step: the flow (D3Q27, inherited from
``Simulation``) first, then the scalar (D3Q7) advected by the fresh
velocity (reference kernels.h:153-161 copies the NSE velocity into the ADE
update).  Each lattice has its own viscosity/diffusivity; the ADE
diffusion coefficient may be a per-site field.

``sim_init`` picks the coupled path by the JAX package's rules
(``coupled_kernel``):

- ``"one-kernel-AB"``: ``use_fused`` with A-B streaming on both lattices of
  one grid - every step is one launch of the coupled kernel (B7,
  ``kernels/fused_coupled.py``);
- ``"one-kernel-AA"``: ``use_fused`` with A-A streaming on both lattices -
  every step is one launch of the A-A coupled pair's kernel of its parity
  (B8): the even parity updates f and g in place, the odd one writes the
  second buffers;
- ``"plain"`` (the JAX package's ``"xla"``): without ``use_fused``, the
  plain steps ``sim/step.py`` and ``sim/step_ade.py``;
- ``"two-kernel"``: ``use_fused`` with a forcing hook (the non-Newtonian
  force) under A-B - the hooked A-B step (``kernels/hooked.py``: the
  one-kernel NN step or its pipeline) then the ADE step (B6) on the
  velocity it wrote (JAX ``sim/coupled.py:153-180``).

Under a ``plan`` (JAX ``sim/coupled.py:75-152``, the reference's
multi-GPU ``State_NSE_ADE``) both lattices shard over the one plan, and f,
g, rho, u and phi are ShardedFields; the NSE half is
``Simulation._sharded_step`` and its sharded velocity advects the sharded
ADE step:

- ``"sharded-fused"``: ``use_fused`` where the sharded ADE kernel takes the
  config (A-B on both lattices, z unsharded, a plan that divides the ADE
  lattice of the NSE lattice's shape) - every step B4 on haloed blocks,
  then B6 on haloed blocks (``make_sharded_fused_ade_step``);
- ``"sharded"``: without ``use_fused``, the plain sharded steps
  (``make_sharded_step``, ``make_sharded_ade_step``), the CPU path.

The JAX package also falls back to "two-kernel" for the A-A pair with
transfer codes and for a hook under A-A, where its ADE half runs unfused
(B6 is A-B only), and under a plan to its plain sharded ADE step where its
sharded ADE kernel's gate fails.  The port refuses these, since a plain
step on the card is no path (ROADMAP §C).  ``_advance`` runs B4 then B6 too
when ``_coupled_step`` is dropped after ``sim_init`` on the A-B path: that
is how B7 is held against the two launches.

The kernel paths ping-pong two preallocated f buffers and two g buffers.
A checkpoint saves g beside f (``checkpoint_arrays_extra``; under a plan in
the JAX sharded layout), and a resumed run takes g from it and phi as its
density (JAX ``sim/coupled.py:55-67``).  ``self.phi`` reads a sharded
phi's blocks gathered on ``device`` (the VTK output).  The coupled loop
advances one step per dispatch, as the JAX one does: it has no chunked
dispatch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tnl_lbm_tpu_torch.kernels.fused_ade import make_fused_ade_step
from tnl_lbm_tpu_torch.kernels.fused_coupled import (
    make_fused_coupled_step,
    make_fused_coupled_step_aa,
)
from tnl_lbm_tpu_torch.ops import moments as mom
from tnl_lbm_tpu_torch.parallel.sharded import ShardedField
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.state import Simulation, synchronize
from tnl_lbm_tpu_torch.sim.step_ade import make_ade_step, transfer_direction_flags


class CoupledSimulation(Simulation):
    """NSE lattice (inherited) + ADE lattice advanced in lock-step."""

    def __init__(self, cfg: LBMConfig, domain: Domain, ade_cfg: LBMConfig, ade_domain: Domain,
                 ade_diffusion=1e-3, transfer_coeff: float = 0.0,
                 phi_inflow: float | None = None, plan=None, **kw):
        super().__init__(cfg, domain, plan=plan, **kw)
        self.ade_cfg = ade_cfg
        self.ade_domain = ade_domain
        self.ade_diffusion = ade_diffusion
        self.transfer_coeff = transfer_coeff
        self.phi_inflow = phi_inflow
        self.g = None     # ADE DFs
        self.phi = None   # ADE macro
        self._transfer_dirs = None
        self._nu_ade = None
        self._ade_step = None
        self._coupled_step = None
        #: the second g buffer of the kernel paths' ping-pong
        self._g_spare = None
        #: which coupled path sim_init selected: "one-kernel-AB", "one-kernel-AA",
        #: "two-kernel", "plain" (the JAX package's "xla"), and under a plan
        #: "sharded-fused" or "sharded"
        self.coupled_kernel = None

    @property
    def phi(self):
        """The ADE concentration [*S]; under a plan the shards' blocks
        gathered on ``device``."""
        if not isinstance(self._phi, ShardedField):
            return self._phi
        if self._phi_gathered is None:
            self._phi_gathered = self._phi.gather(self.device)
        return self._phi_gathered

    @phi.setter
    def phi(self, value):
        self._phi, self._phi_gathered = value, None

    def initial_phi(self):
        """Initial scalar field (override in apps)."""
        return torch.ones(self.ade_domain.shape, dtype=self.ade_cfg.compute_dtype,
                          device=self.device)

    def checkpoint_arrays_extra(self):
        # the ADE lattice must survive a checkpoint/resume cycle too
        # (the reference saves every DF buffer, state.hpp:677-727)
        return {"g": self.g} if self.g is not None else {}

    def _pair_dispatch_capable(self) -> bool:
        """Never: the coupled loop advances both lattices one step at a time."""
        return False

    def sim_init(self):
        if self.use_fused and self.cfg.streaming != self.ade_cfg.streaming:
            raise NotImplementedError(
                f"use_fused needs one streaming pattern on both lattices (the coupled kernels "
                f"advance both in one launch); got NSE {self.cfg.streaming}, ADE "
                f"{self.ade_cfg.streaming}")
        if self.plan is not None:
            self._check_sharded()
        super().sim_init()
        lat, dt = self.ade_cfg.lat, self.ade_cfg.compute_dtype
        restored = self._restored_arrays
        if restored is not None and "g" in restored:
            self.g = torch.as_tensor(np.ascontiguousarray(restored["g"])).to(
                device=self.device, dtype=dt).contiguous()
            self.phi = mom.density(lat, self.g).contiguous()
        else:
            phi0 = torch.as_tensor(self.initial_phi(), dtype=dt, device=self.device).contiguous()
            u0 = torch.zeros((3,) + tuple(self.ade_domain.shape), dtype=dt, device=self.device)
            self.g = self.ade_cfg.eq(lat, phi0, u0).to(dt).contiguous()
            self.phi = phi0
        variable = not np.isscalar(self.ade_diffusion)
        self._nu_ade = (torch.as_tensor(np.asarray(self.ade_diffusion), dtype=dt,
                                        device=self.device).contiguous()
                        if variable else float(self.ade_diffusion))
        if self.plan is not None:
            self._sharded_init(variable)
            return
        if not self.use_fused:
            # the plain step's per-direction flags (a bool field [6, X, Y, Z]);
            # the kernels take their packed byte per site instead
            self._transfer_dirs = torch.as_tensor(
                transfer_direction_flags(lat, self.ade_domain.map), device=self.device)
            self._ade_step = make_ade_step(self.ade_cfg, self.ade_domain)
            self.coupled_kernel = "plain"
            return
        if self.cfg.forcing_hook is not None:
            # the hooked NSE step (built by Simulation._build_step), then B6
            if self.cfg.streaming == "AA":
                raise NotImplementedError(
                    "a forcing hook under A-A has no kernel path: the JAX driver runs its "
                    "ADE half plain there (B6 is A-B only)")
            self._ade_step = make_fused_ade_step(
                self.ade_cfg, self.ade_domain, self.device, variable_diffusion=variable,
                transfer_coeff=float(self.transfer_coeff))
            self.coupled_kernel = "two-kernel"
            self._g_spare = torch.empty_like(self.g)
            return
        # both halves in one kernel: the NSE velocity never round-trips
        # through memory (reference kernels.h:102-176)
        if self.cfg.streaming == "AA":
            # the A-A pair refuses transfer codes (naming the A-B path) where
            # the JAX package falls back to two kernels with its ADE half unfused
            self._coupled_step = make_fused_coupled_step_aa(
                self.cfg, self.domain, self.ade_cfg, self.ade_domain, self.device,
                variable_diffusion=variable)
            self.coupled_kernel = "one-kernel-AA"
        else:
            kw = dict(variable_diffusion=variable, transfer_coeff=float(self.transfer_coeff))
            self._ade_step = make_fused_ade_step(self.ade_cfg, self.ade_domain, self.device,
                                                 **kw)
            self._coupled_step = make_fused_coupled_step(self.cfg, self.domain, self.ade_cfg,
                                                         self.ade_domain, self.device, **kw)
            self.coupled_kernel = "one-kernel-AB"
        self._g_spare = torch.empty_like(self.g)

    def _check_sharded(self) -> None:
        """Refuse, before anything is built, the sharded configs the port has
        no path for: with ``use_fused`` the sharded ADE kernel's gate (A-B
        on both lattices, z unsharded, a plan that divides the ADE lattice
        of the NSE lattice's shape), where the JAX driver degrades its ADE
        half to the plain sharded step (ROADMAP §C)."""
        if self.ade_domain.shape != self.domain.shape:
            raise ValueError(f"the sharded coupled lattices share one plan: the ADE lattice "
                             f"{self.ade_domain.shape} must have the NSE lattice's shape "
                             f"{self.domain.shape}")
        if not self.use_fused:
            return
        why = []
        if self.ade_cfg.streaming != "AB" or self.cfg.streaming != "AB":
            why.append("A-A streaming (B6 halo is A-B only)")
        if self.plan.counts[2] > 1:
            why.append("a z-sharded plan")
        if not self.plan.divisible(self.ade_domain):
            why.append(f"a plan {self.plan.counts} that does not divide {self.ade_domain.shape}")
        if why:
            raise NotImplementedError(
                f"the sharded coupled run with use_fused has no kernel path for {'; '.join(why)}: "
                f"the JAX driver runs its plain sharded ADE step there, the port raises "
                f"(ROADMAP §C; without use_fused the plain sharded steps run)")

    def _sharded_init(self, variable: bool) -> None:
        """g, phi, the nu field and the transfer flags as the plan's
        ShardedFields, and the sharded ADE step (JAX ``sim/coupled.py:75-152``)."""
        from tnl_lbm_tpu_torch.parallel import sharded as sh

        plan, lat = self.plan, self.ade_cfg.lat
        self.g = plan.shard_field(self.g, like_f=True)
        self.phi = ShardedField(plan, [mom.density(lat, b).contiguous() for b in self.g.blocks],
                                self.ade_domain.shape)
        if variable:
            self._nu_ade = plan.shard_field(self._nu_ade, like_f=False)
        if self.use_fused:
            self._ade_step = sh.make_sharded_fused_ade_step(
                self.ade_cfg, self.ade_domain, plan, variable_diffusion=variable,
                transfer_coeff=float(self.transfer_coeff))
            self._g_spare = self.g.empty_like()
            self.coupled_kernel = "sharded-fused"
            return
        self._transfer_dirs = plan.shard_field(
            transfer_direction_flags(lat, self.ade_domain.map), like_f=True)
        self._ade_step = sh.make_sharded_ade_step(self.ade_cfg, self.ade_domain, plan)
        self.coupled_kernel = "sharded"

    def _advance(self, n_steps: int):
        """One coupled step per iteration: NSE, then ADE advected by its u."""
        nu = self.domain.units.lbm_viscosity()
        nu_ade = self._nu_ade
        phi_in = 0.0 if self.phi_inflow is None else float(self.phi_inflow)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            u_in = self.update_inflow(self.phys_time())
            force = self.body_force(self.phys_time())
            parity = (self.iterations % 2) if self.cfg.streaming == "AA" else 0
            self.compute_before_step()
            if self._coupled_step is not None:
                f, g, self.rho, self.u, self.phi = self._coupled_step(
                    self.f, self.g, nu, nu_ade, u_in=u_in, force=force, phi_in=phi_in,
                    parity=parity, out_f=self._spare, out_g=self._g_spare)
                if f is not self.f:  # out of place: the old state is the next spare
                    self._spare, self.f = self.f, f
                    self._g_spare, self.g = self.g, g
            elif self.use_fused:
                # the two-kernel path: B4 (or the hooked A-B step), then B6 on the u it
                # stored; under a plan both on haloed blocks
                f, self.rho, self.u = self._step(self.f, nu, u_in=u_in, force=force,
                                                 out=self._spare, **self._hook_kwargs())
                self._spare, self.f = self.f, f
                g, self.phi = self._ade_step(self.g, self._u, nu_ade, phi_in=phi_in,
                                             out=self._g_spare)
                self._g_spare, self.g = self.g, g
            else:
                self.f, self.rho, self.u = self._step(self.f, nu, u_in=u_in, force=force,
                                                      parity=parity)
                self.g, self.phi = self._ade_step(
                    self.g, self._u, nu_ade, phi_in=phi_in, transfer_dirs=self._transfer_dirs,
                    transfer_coeff=self.transfer_coeff, parity=parity)
            self.iterations += 1
            self.compute_after_step()
        for dev in {self.device, *(self.plan.devices if self.plan is not None else ())}:
            synchronize(dev)
        self._compute_time += time.perf_counter() - t0

    def output_data(self, cut: tuple | None = None):
        scalars, vectors = super().output_data(cut)
        scalars["phi"] = self.phi[tuple(cut) if cut is not None else ()]
        return scalars, vectors
