"""The one-kernel coupled NSE+ADE steps, A-B (B7) and the A-A pair (B8),
and their plain versions.

Counterpart of ``tnl_lbm_tpu/kernels/fused_coupled.py``.  The reference
advances both lattices in one kernel per site, copying the NSE velocity
straight into the ADE update (kernels.h:102-176), so the velocity never
round-trips through memory.  ``csrc/coupled_ab.cu`` does the same per
site: the D3Q27 A-B update of the A-B step (B4, ``lbm_site.cuh ab_site``)
writes f, rho and u, and its velocity, still in registers, advects the
D3Q7 update (``ade_site.cuh``).  Per step this saves the u read of a
separate ADE launch: 12 of ~306 bytes per site.  ``csrc/coupled_aa.cu``
(B8) is the same on the A-A memory pattern, one kernel per parity: the
even and odd site updates of the A-A steps (B2, B3) and the matching D3Q7
parities.

The plain versions are the NSE step's plain half followed by the ADE
step's plain half (``kernels/fused.py``, ``kernels/fused_aa.py``,
``kernels/fused_ade.py``).  :class:`FusedCoupledAB` and
:class:`FusedCoupledAA` launch their kernels on CUDA tensors and run the
plain versions on CPU tensors; they never run a plain version in a
kernel's place.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from tnl_lbm_tpu_torch.kernels.build import load_library
from tnl_lbm_tpu_torch.kernels.fused import (
    CudaKernel,
    FusedStepAB,
    _force3,
    _periodic_bits,
    _u_in3,
    cum_variant,
    refuse_f64,
)
from tnl_lbm_tpu_torch.kernels.fused_aa import FusedStepAA
from tnl_lbm_tpu_torch.kernels.fused_ade import (
    FusedStepADE,
    _ade_tile_body,
    check_out,
    check_state,
    host_scalar,
)
from tnl_lbm_tpu_torch.ops import streaming as stream
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.step_ade import ADEGEO, TRANSFER_CODES


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
            raise ValueError("the one-kernel coupled step is A-B; the A-A coupled pair is "
                             "make_fused_coupled_step_aa")
        self._nse_variant = cum_variant(cfg, "the coupled A-B step (B7)")
        if torch.device(device).type == "cuda":  # its NSE half's float64 step is B4's alone
            refuse_f64(cfg, "the coupled A-B step (B7)")
        self.nse = FusedStepAB(cfg, domain, device)
        self.ade = FusedStepADE(ade_cfg, ade_domain, device,
                                variable_diffusion=variable_diffusion,
                                transfer_coeff=transfer_coeff)
        self.device = self.nse.device
        self.shape = tuple(domain.shape)
        self.kernel = CudaKernel("coupled_ab", "tnl_lbm_tpu_torch/csrc/coupled_ab.cu",
                                 "tnl_lbm_tpu/kernels/fused_coupled.py:179")
        self.plain_calls = 0

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


def ade_aa_plain(ade: FusedStepADE, g, u, nu, phi_in, parity):
    """One A-A parity of the D3Q7 lattice in plain PyTorch: (g_new, phi), g
    untouched.  Even: the site's own DFs for every pull rule, written to
    the opposite slots (``out_perm``); odd: ``g[aopp q]`` pulled from
    x - c_q, updated with the NOTHING restore deferred, pushed as
    ``pull(pad_halo(g_post))`` and the NOTHING sites restored.  ``ade``
    supplies the lattice, codes, map and periodic axes."""
    lat, Q = ade.lat, ade.lat.Q
    aopp = np.asarray(lat.opp)
    m = ade.map.to(g.device)
    body = (lat, ade.codes, ade.sym_codes, ade.do_coll_codes, ade.cfg.collision,
            ade.use_local_eq)
    if parity == 0:
        return _ade_tile_body(*body, lambda q, offs: g[q], m, u, nu, phi_in, None, 0.0, Q,
                              out_perm=aopp)
    S = tuple(g.shape[1:])
    gpad = stream.pad_halo(g, ade.periodic)

    def shifted(q, offs):
        return stream._shift_slices(gpad[int(aopp[q])], offs, S)

    g_post, phi = _ade_tile_body(*body, shifted, m, u, nu, phi_in, None, 0.0, Q,
                                 defer_nothing=True)
    pushed = stream.pull(lat, stream.pad_halo(g_post, ade.periodic), S)
    if ADEGEO.NOTHING in ade.codes:
        pushed = torch.where(m == int(ADEGEO.NOTHING), g, pushed)
    return pushed, phi


class FusedCoupledAA:
    """``step(f, g, nu, nu_ade, u_in=None, force=None, phi_in=0.0, parity=0,
    out_f=None, out_g=None) -> (f_new, g_new, rho, u, phi)``.

    One A-A parity of both lattices in one launch.  ``parity`` 0 updates f
    and g in place (the returned f_new and g_new are f and g; ``out_f`` and
    ``out_g`` are not used); ``parity`` 1 writes new tensors, or into
    ``out_f``/``out_g`` (second buffers, for the odd step's ping-pong).
    ``nse`` and ``ade`` are the A-A step and ADE step wrappers whose checks,
    operands and plain halves this step shares; they are never launched
    from here.  ``even`` and ``odd`` count the launches of the two kernels,
    ``plain_calls`` the CPU-path calls.

    Refused, as the JAX kernel refuses them (``fused_coupled.py:273-278``):
    conjugate TRANSFER_* codes (the even step would need the neighbours'
    phi), OUTFLOW_PE (its pull reaches x-2) and, on the NSE map,
    OUTFLOW_RIGHT_INTERP; the A-B coupled kernel (B7) takes all three.
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, ade_cfg: LBMConfig, ade_domain: Domain,
                 device, variable_diffusion: bool = False):
        if tuple(domain.shape) != tuple(ade_domain.shape):
            raise ValueError("the coupled lattices must share the grid")
        if cfg.streaming != "AA" or ade_cfg.streaming != "AA":
            raise ValueError("the A-A coupled pair needs streaming='AA' on both lattices")
        acodes = ade_domain.codes_present()
        if acodes & TRANSFER_CODES:
            raise NotImplementedError(
                "conjugate transfer BCs need the neighbours' phi on the A-A even step, which "
                "reads only its own site; the A-B coupled kernel (make_fused_coupled_step) "
                "takes them")
        if ADEGEO.OUTFLOW_PE in acodes:
            raise NotImplementedError("OUTFLOW_PE requires the A-B pattern (its pull reaches "
                                      "x-2); the A-B coupled kernel (make_fused_coupled_step) "
                                      "takes it")
        if GEO.OUTFLOW_RIGHT_INTERP in domain.codes_present():
            raise NotImplementedError("OUTFLOW_RIGHT_INTERP requires the A-B pattern; the A-B "
                                      "coupled kernel (make_fused_coupled_step) takes it")
        cum_variant(cfg, "the A-A coupled pair (B8)")
        if torch.device(device).type == "cuda":  # its NSE half's float64 steps are B2/B3's alone
            refuse_f64(cfg, "the A-A coupled pair (B8)")
        self.nse = FusedStepAA(cfg, domain, device, lean=False)
        # the ADE wrapper is A-B; only its checks, operands and tables are used
        self.ade = FusedStepADE(dataclasses.replace(ade_cfg, streaming="AB"), ade_domain, device,
                                variable_diffusion=variable_diffusion)
        self.device = self.nse.device
        self.shape = tuple(domain.shape)
        self.even = CudaKernel("coupled_aa_even", "tnl_lbm_tpu_torch/csrc/coupled_aa.cu",
                               "tnl_lbm_tpu/kernels/fused_coupled.py:336")
        self.odd = CudaKernel("coupled_aa_odd", "tnl_lbm_tpu_torch/csrc/coupled_aa.cu",
                              "tnl_lbm_tpu/kernels/fused_coupled.py:489")
        self.plain_calls = 0

    def reset_counts(self) -> None:
        self.even.launches = self.odd.launches = self.plain_calls = 0

    def __call__(self, f, g, nu, nu_ade, u_in=None, force=None, phi_in=0.0, parity: int = 0,
                 out_f=None, out_g=None):
        uvec, fvec = _u_in3(u_in), _force3(force)
        phi_in = host_scalar(phi_in, "phi_in")
        if parity == 0:
            out_f = out_g = None
        check_out(out_f, f)
        check_out(out_g, g)
        if f.device.type == "cuda":
            return self._launch(f, g, float(nu), nu_ade, fvec, uvec, phi_in, parity, out_f,
                                out_g)
        self.plain_calls += 1
        f_new, g_new, rho, u, phi = self._plain(f, g, nu, nu_ade, fvec, uvec, phi_in, parity)
        if parity == 0:  # in place, as the even kernel
            out_f, out_g = f, g
        if out_f is not None:
            f_new = out_f.copy_(f_new)
        if out_g is not None:
            g_new = out_g.copy_(g_new)
        return f_new, g_new, rho, u, phi

    def plain(self, f, g, nu, nu_ade, u_in=None, force=None, phi_in=0.0, parity: int = 0):
        """One parity's plain PyTorch version on f's device, f and g
        untouched; counts no call."""
        return self._plain(f, g, nu, nu_ade, _force3(force), _u_in3(u_in),
                           host_scalar(phi_in, "phi_in"), parity)

    def _plain(self, f, g, nu, nu_ade, fvec, uvec, phi_in, parity):
        f_new, rho, u = self.nse._plain(f, nu, fvec, uvec, parity)
        g_new, phi = ade_aa_plain(self.ade, g, u, self.ade._nu(nu_ade), phi_in, parity)
        return f_new, g_new, rho, u, phi

    def _launch(self, f, g, nu, nu_ade, fvec, uvec, phi_in, parity, out_f, out_g):
        check_state(f, self.nse.lat.Q, self.shape, self.nse.map, "f")
        check_state(g, self.ade.lat.Q, self.shape, self.nse.map, "g")
        nu_ptr, omega_ade, _ = self.ade.kernel_args(nu_ade)
        lib = load_library()
        X, Y, Z = self.shape
        if parity == 0:
            f_new, g_new, kernel = f, g, self.even
        else:
            f_new = torch.empty_like(f) if out_f is None else out_f
            g_new = torch.empty_like(g) if out_g is None else out_g
            kernel = self.odd
        rho = torch.empty((X, Y, Z), dtype=f.dtype, device=f.device)
        u = torch.empty((3, X, Y, Z), dtype=f.dtype, device=f.device)
        phi = torch.empty((X, Y, Z), dtype=f.dtype, device=f.device)
        stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
        rc = lib.tnl_lbm_coupled_aa(
            f.data_ptr(), f_new.data_ptr(), self.nse.map.data_ptr(), rho.data_ptr(),
            u.data_ptr(), g.data_ptr(), g_new.data_ptr(), self.ade.map.data_ptr(), nu_ptr,
            phi.data_ptr(), X, Y, Z, int(parity), _periodic_bits(self.nse.periodic),
            _periodic_bits(self.ade.periodic), int(GEO.NOTHING in self.nse.codes),
            int(ADEGEO.NOTHING in self.ade.codes), self.nse.variant, self.ade.variant, nu,
            *fvec, *uvec, int(self.nse.cfg.high_precision_rho), omega_ade, phi_in, stream_ptr)
        if rc != 0:
            raise RuntimeError(f"{kernel.name} launch failed: CUDA error {rc}")
        kernel.launches += 1
        return f_new, g_new, rho, u, phi


def make_fused_coupled_step_aa(cfg: LBMConfig, domain: Domain, ade_cfg: LBMConfig,
                               ade_domain: Domain, device,
                               variable_diffusion: bool = False) -> FusedCoupledAA:
    """The A-A coupled pair on ``device``: see :class:`FusedCoupledAA`.  The
    JAX function's TPU knobs (``tile_even``, ``tile_odd``,
    ``tiles_per_program``) shape its VMEM windows and have no counterpart
    here."""
    return FusedCoupledAA(cfg, domain, ade_cfg, ade_domain, device,
                          variable_diffusion=variable_diffusion)
