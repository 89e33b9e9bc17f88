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
  plain steps ``sim/step.py`` and ``sim/step_ade.py``.

The JAX package's third path, ``"two-kernel"`` (the A-B step, B4, then the
ADE step, B6), is its fallback where the coupled kernel is not built: a
forcing hook, or the A-A pair with transfer codes, where its ADE half runs
unfused.  The port refuses those configs (a forcing hook names ROADMAP
A11; the A-A pair's refusal names its reason), since a plain step on the
card is no path, so ``sim_init`` never picks it.  ``_advance`` still runs
B4 then B6 when ``_coupled_step`` is dropped after ``sim_init`` on the A-B
path: that is how B7 is held against the two launches.

The kernel paths ping-pong two preallocated f buffers and two g buffers.
Mixed patterns with ``use_fused``, a sharded plan (ROADMAP A13) and
checkpoints (ROADMAP A6) raise.
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
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.state import Simulation, synchronize
from tnl_lbm_tpu_torch.sim.step_ade import make_ade_step, transfer_direction_flags


class CoupledSimulation(Simulation):
    """NSE lattice (inherited) + ADE lattice advanced in lock-step."""

    def __init__(self, cfg: LBMConfig, domain: Domain, ade_cfg: LBMConfig, ade_domain: Domain,
                 ade_diffusion=1e-3, transfer_coeff: float = 0.0,
                 phi_inflow: float | None = None, plan=None, **kw):
        if plan is not None:
            raise NotImplementedError("the sharded coupled lattices are not ported yet "
                                      "(ROADMAP A13)")
        super().__init__(cfg, domain, **kw)
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
        #: which coupled path sim_init selected: "one-kernel-AB", "one-kernel-AA"
        #: or "plain" (the JAX package's "xla")
        self.coupled_kernel = None

    def initial_phi(self):
        """Initial scalar field (override in apps)."""
        return torch.ones(self.ade_domain.shape, dtype=self.ade_cfg.compute_dtype,
                          device=self.device)

    def checkpoint_arrays_extra(self):
        raise NotImplementedError("checkpoints are not ported yet (ROADMAP A6); the coupled "
                                  "run would save g beside f")

    def _pair_dispatch_capable(self) -> bool:
        """Never: the coupled loop advances both lattices one step at a time."""
        return False

    def sim_init(self):
        if self.use_fused and self.cfg.streaming != self.ade_cfg.streaming:
            raise NotImplementedError(
                f"use_fused needs one streaming pattern on both lattices (the coupled kernels "
                f"advance both in one launch); got NSE {self.cfg.streaming}, ADE "
                f"{self.ade_cfg.streaming}")
        super().sim_init()
        lat, dt = self.ade_cfg.lat, self.ade_cfg.compute_dtype
        phi0 = torch.as_tensor(self.initial_phi(), dtype=dt, device=self.device).contiguous()
        u0 = torch.zeros((3,) + tuple(self.ade_domain.shape), dtype=dt, device=self.device)
        self.g = self.ade_cfg.eq(lat, phi0, u0).to(dt).contiguous()
        self.phi = phi0
        variable = not np.isscalar(self.ade_diffusion)
        self._nu_ade = (torch.as_tensor(np.asarray(self.ade_diffusion), dtype=dt,
                                        device=self.device).contiguous()
                        if variable else float(self.ade_diffusion))
        if not self.use_fused:
            # the plain step's per-direction flags (a bool field [6, X, Y, Z]);
            # the kernels take their packed byte per site instead
            self._transfer_dirs = torch.as_tensor(
                transfer_direction_flags(lat, self.ade_domain.map), device=self.device)
            self._ade_step = make_ade_step(self.ade_cfg, self.ade_domain)
            self.coupled_kernel = "plain"
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
            self._spare = torch.empty_like(self.f)
        else:
            kw = dict(variable_diffusion=variable, transfer_coeff=float(self.transfer_coeff))
            self._ade_step = make_fused_ade_step(self.ade_cfg, self.ade_domain, self.device,
                                                 **kw)
            self._coupled_step = make_fused_coupled_step(self.cfg, self.domain, self.ade_cfg,
                                                         self.ade_domain, self.device, **kw)
            self.coupled_kernel = "one-kernel-AB"
        self._g_spare = torch.empty_like(self.g)

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
                # the two-kernel path: B4, then B6 on the u it stored
                f, self.rho, self.u = self._step(self.f, nu, u_in=u_in, force=force,
                                                 out=self._spare)
                self._spare, self.f = self.f, f
                g, self.phi = self._ade_step(self.g, self.u, nu_ade, phi_in=phi_in,
                                             out=self._g_spare)
                self._g_spare, self.g = self.g, g
            else:
                self.f, self.rho, self.u = self._step(self.f, nu, u_in=u_in, force=force,
                                                      parity=parity)
                self.g, self.phi = self._ade_step(
                    self.g, self.u, nu_ade, phi_in=phi_in, transfer_dirs=self._transfer_dirs,
                    transfer_coeff=self.transfer_coeff, parity=parity)
            self.iterations += 1
            self.compute_after_step()
        synchronize(self.device)
        self._compute_time += time.perf_counter() - t0

    def output_data(self, cut: tuple | None = None):
        scalars, vectors = super().output_data(cut)
        scalars["phi"] = self.phi[tuple(cut) if cut is not None else ()]
        return scalars, vectors
