"""The one-kernel coupled NSE+ADE A-B step (B7) and its plain version.

Counterpart of ``tnl_lbm_tpu/kernels/fused_coupled.py``.  The reference
advances both lattices in one kernel per site, copying the NSE velocity
straight into the ADE update (kernels.h:102-176), so the velocity never
round-trips through memory.  ``csrc/coupled_ab.cu`` does the same per
site: the D3Q27 A-B update of the A-B step (B4, ``lbm_site.cuh ab_site``)
writes f, rho and u, and its velocity, still in registers, advects the
D3Q7 update (``ade_site.cuh``).  Per step this saves the u read of a
separate ADE launch: 12 of ~306 bytes per site.

The plain version is the A-B step's plain half followed by the ADE step's
plain half (``kernels/fused.py``, ``kernels/fused_ade.py``).
:class:`FusedCoupledAB` launches the kernel on CUDA tensors and runs the
plain version on CPU tensors; it never runs the plain version in the
kernel's place.
"""

from __future__ import annotations

import ctypes

import torch

from tnl_lbm_tpu_torch.kernels.build import load_library
from tnl_lbm_tpu_torch.kernels.fused import (
    _AB_VARIANTS,
    CudaKernel,
    FusedStepAB,
    _eq_kind,
    _force3,
    _periodic_bits,
    _u_in3,
)
from tnl_lbm_tpu_torch.kernels.fused_ade import FusedStepADE, check_out, check_state, host_scalar
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig


class FusedCoupledAB:
    """``step(f, g, nu, nu_ade, u_in=None, force=None, phi_in=0.0, parity=0,
    out_f=None, out_g=None) -> (f_new, g_new, rho, u, phi)``.

    One A-B step of both lattices, out of place (``out_f``/``out_g``: second
    buffers for the double buffer).  ``nse`` and ``ade`` are the A-B and ADE
    step wrappers whose checks, operands and plain halves this step shares;
    they are never launched from here.  ``kernel`` counts the launches,
    ``plain_calls`` the CPU-path calls.
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, ade_cfg: LBMConfig, ade_domain: Domain,
                 device, variable_diffusion: bool = False, transfer_coeff: float = 0.0):
        if tuple(domain.shape) != tuple(ade_domain.shape):
            raise ValueError("the coupled lattices must share the grid")
        if cfg.streaming != "AB" or ade_cfg.streaming != "AB":
            raise NotImplementedError("the one-kernel coupled step is A-B; the A-A coupled pair "
                                      "is ROADMAP B8")
        self.nse = FusedStepAB(cfg, domain, device)
        self.ade = FusedStepADE(ade_cfg, ade_domain, device,
                                variable_diffusion=variable_diffusion,
                                transfer_coeff=transfer_coeff)
        self.device = self.nse.device
        self.shape = tuple(domain.shape)
        self.kernel = CudaKernel("coupled_ab", "tnl_lbm_tpu_torch/csrc/coupled_ab.cu",
                                 "tnl_lbm_tpu/kernels/fused_coupled.py:179")
        self.plain_calls = 0
        if self.device.type == "cuda":
            self._nse_variant = _AB_VARIANTS[(cfg.well, _eq_kind(cfg))]

    def reset_counts(self) -> None:
        self.kernel.launches = self.plain_calls = 0

    def __call__(self, f, g, nu, nu_ade, u_in=None, force=None, phi_in=0.0, parity: int = 0,
                 out_f=None, out_g=None):
        del parity  # A-B
        uvec, fvec = _u_in3(u_in), _force3(force)
        phi_in = host_scalar(phi_in, "phi_in")
        check_out(out_f, f)
        check_out(out_g, g)
        if f.device.type == "cuda":
            return self._launch(f, g, float(nu), nu_ade, fvec, uvec, phi_in, out_f, out_g)
        self.plain_calls += 1
        f_new, g_new, rho, u, phi = self._plain(f, g, nu, nu_ade, fvec, uvec, phi_in)
        if out_f is not None:
            f_new = out_f.copy_(f_new)
        if out_g is not None:
            g_new = out_g.copy_(g_new)
        return f_new, g_new, rho, u, phi

    def plain(self, f, g, nu, nu_ade, u_in=None, force=None, phi_in=0.0):
        """The step's plain PyTorch version on f's device, f and g untouched;
        counts no call."""
        return self._plain(f, g, nu, nu_ade, _force3(force), _u_in3(u_in),
                           host_scalar(phi_in, "phi_in"))

    def _plain(self, f, g, nu, nu_ade, fvec, uvec, phi_in):
        f_new, rho, u = self.nse._plain(f, nu, fvec, uvec)
        g_new, phi = self.ade._plain(g, u, self.ade._nu(nu_ade), phi_in)
        return f_new, g_new, rho, u, phi

    def _launch(self, f, g, nu, nu_ade, fvec, uvec, phi_in, out_f, out_g):
        check_state(f, self.nse.lat.Q, self.shape, self.nse.map, "f")
        check_state(g, self.ade.lat.Q, self.shape, self.nse.map, "g")
        nu_ptr, omega_ade, tf_ptr = self.ade.kernel_args(nu_ade)
        lib = load_library()
        X, Y, Z = self.shape
        f_new = torch.empty_like(f) if out_f is None else out_f
        g_new = torch.empty_like(g) if out_g is None else out_g
        rho = torch.empty((X, Y, Z), dtype=f.dtype, device=f.device)
        u = torch.empty((3, X, Y, Z), dtype=f.dtype, device=f.device)
        phi = torch.empty((X, Y, Z), dtype=f.dtype, device=f.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
        rc = lib.tnl_lbm_coupled_ab(
            f.data_ptr(), f_new.data_ptr(), self.nse.map.data_ptr(), rho.data_ptr(), u.data_ptr(),
            g.data_ptr(), g_new.data_ptr(), self.ade.map.data_ptr(), nu_ptr, tf_ptr,
            phi.data_ptr(), X, Y, Z, _periodic_bits(self.nse.periodic),
            _periodic_bits(self.ade.periodic), self._nse_variant, self.ade.variant, nu, *fvec,
            *uvec, int(self.nse.cfg.high_precision_rho), omega_ade, phi_in,
            self.ade.transfer_coeff, stream)
        if rc != 0:
            raise RuntimeError(f"{self.kernel.name} launch failed: CUDA error {rc}")
        self.kernel.launches += 1
        return f_new, g_new, rho, u, phi


def make_fused_coupled_step(cfg: LBMConfig, domain: Domain, ade_cfg: LBMConfig,
                            ade_domain: Domain, device, variable_diffusion: bool = False,
                            transfer_coeff: float = 0.0) -> FusedCoupledAB:
    """The coupled A-B step on ``device``: see :class:`FusedCoupledAB`.  The
    JAX function's TPU knobs (``tile``, ``tiles_per_program``) have no
    counterpart here."""
    return FusedCoupledAB(cfg, domain, ade_cfg, ade_domain, device,
                          variable_diffusion=variable_diffusion, transfer_coeff=transfer_coeff)


def make_fused_coupled_step_aa(cfg: LBMConfig, domain: Domain, ade_cfg: LBMConfig,
                               ade_domain: Domain, device, **kw):
    """The A-A coupled pair (B8) is not ported yet: its NSE half needs the
    A-A kernels' INFLOW/OUTFLOW_EQ rules (ROADMAP B8, A8)."""
    raise NotImplementedError("the A-A coupled pair is not ported yet (ROADMAP B8)")
