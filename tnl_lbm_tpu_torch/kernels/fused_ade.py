"""The D3Q7 advection-diffusion step (B6) and its per-site logic in plain PyTorch.

Counterpart of ``tnl_lbm_tpu/kernels/fused_ade.py``: the ADE half of the
reference's coupled kernel (reference kernels.h:154-176 with d3q7/bc.h) as
one pass per site - pull streaming, the ADE boundary rules (walls,
anti-bounce-back body walls, inflow, Peclet-extrapolation outflow,
symmetry, conjugate TRANSFER_FS/SF/SW, inert ghosts) and the collision.
The advecting velocity ``u`` is an input (the NSE step's macro output).
``nu`` may be a scalar or a per-site [X, Y, Z] field (reference ADE_Data,
lbm_data.h:133-165); the per-direction transfer flags are packed at build
time into one bit-field per site (bit q-1: link q crosses the interface).

``_ade_tile_body`` is the per-site logic on whole arrays, with
``shifted(q, (ox, oy, oz))`` reading component q at the given site offsets;
its CUDA form is ``ade_site_update`` in ``csrc/ade_site.cuh``, shared by the
ADE kernel (``csrc/ade_step.cu``) and the coupled kernels
(``csrc/coupled_ab.cu``, ``csrc/coupled_aa.cu``, ``kernels/fused_coupled.py``).

:class:`FusedStepADE` launches ``csrc/ade_step.cu`` on CUDA tensors and
runs its plain version on CPU tensors; it never runs the plain version in
the kernel's place.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tnl_lbm_tpu_torch.kernels.build import load_library
from tnl_lbm_tpu_torch.kernels.fused import _MAX_GRID_YZ, CudaKernel, _periodic_bits
from tnl_lbm_tpu_torch.ops import collision_ade as cade
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.step_ade import (
    _COLLIDING,
    _SYM,
    ADEGEO,
    TRANSFER_CODES,
    pad_edge_or_wrap,
    transfer_direction_flags,
)

#: ADEGEO codes the ADE kernel handles: the whole table
SUPPORTED_ADE_CODES = set(ADEGEO)

#: collision id of the CUDA instances (csrc/ade_site.cuh ADE_SRT ... ADE_CLBM_RS)
ADE_VARIANTS = {cade.collide_srt_ade: 0, cade.collide_mrt_ade: 1,
                cade.collide_clbm_ade: 2, cade.collide_clbm_rs_ade: 3}


def supports_ade(domain: Domain) -> bool:
    return domain.codes_present() <= SUPPORTED_ADE_CODES


def _eq_local_ade(lat, phi, u):
    """Second-order equilibrium with Python-scalar coefficients
    (eq_quadratic for ics2 = 4); the CUDA ``ade_eq``."""
    ics2 = float(lat.i_cs2)
    uu = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
    rows = []
    for q in range(lat.Q):
        cx, cy, cz = (int(v) for v in lat.c[q])
        cu = cx * u[0] + cy * u[1] + cz * u[2]
        w = float(lat.w[q])
        rows.append(w * phi * (1 + ics2 * cu + 0.5 * ics2 * ics2 * cu * cu - 0.5 * ics2 * uu))
    return torch.stack(rows)


def pack_transfer_flags(lat, map_arr) -> np.ndarray:
    """The Q-1 per-direction conjugate-transfer interface flags packed into
    one int32 bit-field per site (bit q-1 = direction q crosses the
    interface); the kernels take it narrowed to one byte per site."""
    flags = transfer_direction_flags(lat, np.asarray(map_arr))  # [Q-1, *shape]
    packed = np.zeros(np.asarray(map_arr).shape, np.int32)
    for q in range(1, lat.Q):
        packed |= flags[q - 1].astype(np.int32) << (q - 1)
    return packed


def pad_ade(g: torch.Tensor, periodic) -> torch.Tensor:
    """The ADE halo: 2 wide along x (the OUTFLOW_PE pull reads x-2), 1 wide
    along y and z; wrapped on periodic axes, edge-replicated otherwise
    (JAX ``_pad_ade`` and ``_zshift``).  Origin (2, 1, 1)."""
    return pad_edge_or_wrap(g, periodic, (2, 1, 1))


def ade_shifted(gpad: torch.Tensor, shape):
    """``shifted(q, (ox, oy, oz))`` over a ``pad_ade`` array."""
    X, Y, Z = shape

    def shifted(q, offs):
        ox, oy, oz = offs
        return gpad[q, 2 + ox : 2 + ox + X, 1 + oy : 1 + oy + Y, 1 + oz : 1 + oz + Z]

    return shifted


def _ade_tile_body(lat, codes, sym_codes, do_coll_codes, collide, use_local_eq, shifted, m, u,
                   nu, phi_in, tf, tcoef, Q, out_perm=None, defer_nothing=False):
    """Stream + BC + collide for the ADE lattice on whole arrays; shared by
    the ADE step and the coupled steps (kernels/fused_coupled.py).

    ``shifted(q, (ox, oy, oz))`` reads the pre-streaming g; ``tf`` is the
    packed transfer-flag field (or None).  ``out_perm`` permutes the output
    components before the NOTHING restore (an A-A even step writes
    opposite-direction, d3q7/streaming_AA.h); ``defer_nothing=True`` skips
    the NOTHING restore (an A-A odd step applies it at the destination
    site after the push); the A-A coupled pair uses both
    (``kernels/fused_coupled.py ade_aa_plain``).  Returns (f_post, phi).
    """
    opp = np.asarray(lat.opp)
    masks = {c: (m == int(c)) for c in codes}

    f_in = torch.stack([shifted(q, tuple(-int(v) for v in lat.c[q])) for q in range(Q)])
    if ADEGEO.OUTFLOW_RIGHT in codes:
        rows = [shifted(q, (-1, -int(lat.c[q][1]), -int(lat.c[q][2]))) for q in range(Q)]
        f_in = torch.where(masks[ADEGEO.OUTFLOW_RIGHT], torch.stack(rows), f_in)
    if ADEGEO.OUTFLOW_PE in codes:
        rows = [shifted(q, (-int(lat.c[q][0]) - 1, -int(lat.c[q][1]), -int(lat.c[q][2])))
                for q in range(Q)]
        f_in = torch.where(masks[ADEGEO.OUTFLOW_PE], torch.stack(rows), f_in)

    center = torch.stack([shifted(q, (0, 0, 0)) for q in range(Q)])
    for wall_code in (ADEGEO.WALL, ADEGEO.WALL_BODY):
        if wall_code in codes:
            swapped = torch.stack([f_in[int(opp[q])] for q in range(Q)])
            f_in = torch.where(masks[wall_code], swapped, f_in)
    if ADEGEO.WALL_BODY in codes:
        phi_prev = center[0]
        for q in range(1, Q):
            phi_prev = phi_prev + center[q]
        rows = [-f_in[q] + 2 * float(lat.w[q]) * phi_prev for q in range(Q)]
        f_in = torch.where(masks[ADEGEO.WALL_BODY], torch.stack(rows), f_in)

    for c in sym_codes:
        axis, sign = _SYM[c]
        mirror = np.asarray(lat.mirror(axis))
        f_in = torch.stack([
            torch.where(masks[c], f_in[int(mirror[q])], f_in[q])
            if int(lat.c[q][axis]) == sign else f_in[q]
            for q in range(Q)])

    if tf is not None:
        # conjugate transfer (reference d3q7/bc.h:142-189): the pre-streaming
        # phi at the site and at x - c_q
        def phi_at(offs):
            acc = shifted(0, offs)
            for q in range(1, Q):
                acc = acc + shifted(q, offs)
            return acc

        phi_tot = phi_at((0, 0, 0))
        rows = [f_in[0]]
        for q in range(1, Q):
            qo = int(opp[q])
            flag = ((tf >> (qo - 1)) & 1) > 0
            nb_phi = phi_at(tuple(-int(v) for v in lat.c[q]))
            reflected = center[qo]
            fs_sf = reflected + tcoef * (nb_phi - phi_tot)
            row = f_in[q]
            for code, repl in ((ADEGEO.TRANSFER_FS, fs_sf), (ADEGEO.TRANSFER_SF, fs_sf),
                               (ADEGEO.TRANSFER_SW, reflected)):
                if code in codes:
                    row = torch.where(masks[code] & flag, repl, row)
            rows.append(row)
        f_in = torch.stack(rows)

    phi = f_in[0]
    for q in range(1, Q):
        phi = phi + f_in[q]

    if ADEGEO.INFLOW in codes:
        mm = masks[ADEGEO.INFLOW]
        phi_b = torch.zeros_like(phi) + phi_in
        f_in = torch.where(mm, _eq_local_ade(lat, phi_b, u), f_in)
        phi = torch.where(mm, phi_b, phi)
    if ADEGEO.OUTFLOW_PE in codes:
        f_in = torch.where(masks[ADEGEO.OUTFLOW_PE], _eq_local_ade(lat, phi, u), f_in)

    if use_local_eq:
        omega = 1.0 / (0.5 + float(lat.i_cs2) * nu)
        f_post = f_in + omega * (_eq_local_ade(lat, phi, u) - f_in)
    else:
        f_post = collide(lat, f_in, phi, u, nu)
    do_coll = torch.zeros_like(m, dtype=torch.bool)
    for code in do_coll_codes:
        do_coll = do_coll | (m == code)
    f_post = torch.where(do_coll, f_post, f_in)

    if out_perm is not None:
        f_post = torch.stack([f_post[int(out_perm[q])] for q in range(Q)])
    if ADEGEO.NOTHING in codes:
        if not defer_nothing:
            f_post = torch.where(masks[ADEGEO.NOTHING], center, f_post)
        phi = torch.where(masks[ADEGEO.NOTHING], torch.zeros_like(phi), phi)
    return f_post, phi


def host_scalar(value, what: str) -> float:
    """A scalar input (phi_in) as a Python float; a CUDA tensor is refused
    rather than read back to the host once per step."""
    if torch.is_tensor(value):
        if value.device.type != "cpu" or value.numel() != 1:
            raise ValueError(f"{what} must be a host scalar, not a tensor of shape "
                             f"{tuple(value.shape)} on {value.device}")
        value = value.item()
    return float(value)


class FusedStepADE:
    """``step(g, u, nu, phi_in=0.0, out=None) -> (g_new, phi)``.

    One A-B step of the D3Q7 lattice (pull, the ADE boundary set, one of
    the four collisions) out of place: the result goes to a new tensor or
    into ``out`` (a second buffer, not ``g``).  ``u`` is the advecting
    velocity [3, X, Y, Z]; ``nu`` a scalar or, with
    ``variable_diffusion=True``, an [X, Y, Z] field; ``phi_in`` the inflow
    concentration as a host scalar; ``transfer_coeff`` is fixed at build
    time.  ``kernel`` counts the launches, ``plain_calls`` the CPU-path calls.
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, device, variable_diffusion: bool = False,
                 transfer_coeff: float = 0.0):
        lat = cfg.lat
        if lat.D != 3 or lat.Q != 7:
            raise ValueError("the ADE step is for the D3Q7 lattice")
        if cfg.streaming != "AB":
            raise NotImplementedError("the ADE kernel implements the A-B pattern; A-A ADE "
                                      "steps run in the A-A coupled pair "
                                      "(make_fused_coupled_step_aa)")
        self.codes = domain.codes_present()
        if not self.codes <= SUPPORTED_ADE_CODES:
            raise NotImplementedError(f"unsupported ADE codes {self.codes - SUPPORTED_ADE_CODES}")
        self.cfg, self.lat = cfg, lat
        self.device = torch.device(device)
        self.shape = domain.shape
        self.periodic = domain.periodic
        self.variable_diffusion = variable_diffusion
        self.transfer_coeff = float(transfer_coeff)
        self.sym_codes = sorted(c for c in self.codes if c in _SYM)
        self.do_coll_codes = sorted(int(c) for c in (_COLLIDING & self.codes))
        self.use_local_eq = cfg.collision is cade.collide_srt_ade
        self.kernel = CudaKernel("ade_step", "tnl_lbm_tpu_torch/csrc/ade_step.cu",
                                 "tnl_lbm_tpu/kernels/fused_ade.py:338")
        self.plain_calls = 0
        if self.device.type == "cuda":
            check_ade_kernel_config(cfg, domain)
        self.variant = ADE_VARIANTS.get(cfg.collision)
        self.map = torch.as_tensor(np.ascontiguousarray(domain.map, np.uint8), device=self.device)
        # one byte per site: 6 bits are used
        self.tflags = (torch.as_tensor(pack_transfer_flags(lat, domain.map).astype(np.uint8),
                                       device=self.device)
                       if self.codes & TRANSFER_CODES else None)

    def reset_counts(self) -> None:
        self.kernel.launches = self.plain_calls = 0

    def __call__(self, g, u, nu, phi_in=0.0, out=None):
        phi_in = host_scalar(phi_in, "phi_in")
        check_out(out, g)
        if g.device.type == "cuda":
            return self._launch(g, u, nu, phi_in, out)
        self.plain_calls += 1
        g_new, phi = self._plain(g, u, self._nu(nu), phi_in)
        if out is not None:
            g_new = out.copy_(g_new)
        return g_new, phi

    def plain(self, g, u, nu, phi_in=0.0):
        """The step's plain PyTorch version on g's device: (g_new, phi), g
        untouched.  The CPU path, and the oracle the kernel is held against
        on the card; it counts no call."""
        return self._plain(g, u, self._nu(nu), host_scalar(phi_in, "phi_in"))

    def _nu(self, nu):
        """A scalar as a float; a field only with ``variable_diffusion``."""
        if torch.is_tensor(nu) and nu.ndim > 0:
            if not self.variable_diffusion:
                raise ValueError("a per-site nu field needs variable_diffusion=True")
            if tuple(nu.shape) != tuple(self.shape):
                raise ValueError(f"nu must be a [{', '.join(map(str, self.shape))}] field, "
                                 f"got {tuple(nu.shape)}")
            return nu
        return host_scalar(nu, "nu")

    def _plain(self, g, u, nu, phi_in):
        """The step on ``pad_ade``-pulled whole arrays; g untouched."""
        shifted = ade_shifted(pad_ade(g, self.periodic), self.shape)
        m = self.map.to(g.device)
        tf = None if self.tflags is None else self.tflags.to(g.device, torch.int32)
        return _ade_tile_body(self.lat, self.codes, self.sym_codes, self.do_coll_codes,
                              self.cfg.collision, self.use_local_eq, shifted, m, u, nu, phi_in,
                              tf, self.transfer_coeff, self.lat.Q)

    def kernel_args(self, nu):
        """The ADE operands shared by the ADE and coupled kernels: (nu field
        pointer or 0, omega for a scalar nu, flags pointer or 0)."""
        nu = self._nu(nu)
        if torch.is_tensor(nu):
            check_field(nu, self.map, "nu")
            nu_ptr, omega = nu.data_ptr(), 0.0
        else:
            nu_ptr, omega = 0, 1.0 / (0.5 + float(self.lat.i_cs2) * nu)
        return nu_ptr, omega, 0 if self.tflags is None else self.tflags.data_ptr()

    def _launch(self, g, u, nu, phi_in, out):
        check_state(g, self.lat.Q, self.shape, self.map, "g")
        check_field(u, self.map, "u", (3,) + tuple(self.shape))
        nu_ptr, omega, tf_ptr = self.kernel_args(nu)
        lib = load_library()
        X, Y, Z = self.shape
        g_new = torch.empty_like(g) if out is None else out
        phi = torch.empty((X, Y, Z), dtype=g.dtype, device=g.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream(g.device).cuda_stream)
        rc = lib.tnl_lbm_ade_step(g.data_ptr(), g_new.data_ptr(), self.map.data_ptr(),
                                  u.data_ptr(), nu_ptr, tf_ptr, phi.data_ptr(), X, Y, Z,
                                  _periodic_bits(self.periodic), self.variant, omega, phi_in,
                                  self.transfer_coeff, stream)
        if rc != 0:
            raise RuntimeError(f"{self.kernel.name} launch failed: CUDA error {rc}")
        self.kernel.launches += 1
        return g_new, phi


def check_ade_kernel_config(cfg: LBMConfig, domain: Domain) -> None:
    """Refuse, at build time, what the ADE CUDA code does not implement."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but none is available")
    if cfg.collision not in ADE_VARIANTS:
        raise NotImplementedError(f"ADE collision {getattr(cfg.collision, '__name__', '?')} has "
                                  f"no CUDA instance")
    if cfg.compute_dtype != torch.float32:
        raise NotImplementedError("the ADE step (B6) computes in float32 only: its float64 "
                                  "instances are ROADMAP Bf64")
    X, Y, _ = domain.shape
    if X > _MAX_GRID_YZ or Y > _MAX_GRID_YZ:
        raise ValueError(f"X and Y must be <= {_MAX_GRID_YZ} for the kernel grid")


def check_out(out, state) -> None:
    if out is not None and (out is state or out.shape != state.shape or out.dtype != state.dtype
                            or out.device != state.device or not out.is_contiguous()):
        raise ValueError("out must be a second contiguous buffer like the state")


def check_state(t, Q, shape, like, what) -> None:
    """A contiguous float32 [Q, X, Y, Z] tensor on ``like``'s device."""
    if t.device != like.device:
        raise ValueError(f"{what} is on {t.device}, the step was built for {like.device}")
    if t.dtype != torch.float32:
        raise NotImplementedError("the CUDA kernels take float32 state only")
    if tuple(t.shape) != (Q,) + tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous [{Q}, {', '.join(map(str, shape))}] "
                         f"tensor, got {tuple(t.shape)}")


def check_field(t, like, what, shape=None) -> None:
    """A contiguous float32 field on ``like``'s device, of ``like``'s shape
    or ``shape``."""
    shape = tuple(like.shape) if shape is None else tuple(shape)
    if (not torch.is_tensor(t) or t.device != like.device or t.dtype != torch.float32
            or tuple(t.shape) != shape or not t.is_contiguous()):
        got = (t.dtype, tuple(t.shape), t.device) if torch.is_tensor(t) else type(t)
        raise ValueError(f"{what} must be a contiguous float32 {list(shape)} tensor on "
                         f"{like.device}, got {got}")


def make_fused_ade_step(cfg: LBMConfig, domain: Domain, device, variable_diffusion: bool = False,
                        transfer_coeff: float = 0.0, prepadded: bool = False,
                        local_shape=None) -> FusedStepADE:
    """The ADE step for (cfg, domain) on ``device``: see :class:`FusedStepADE`.

    The JAX function's TPU knobs (``tile``, ``tiles_per_program``) shape its
    VMEM windows and have no counterpart here; its sharded knobs
    ``prepadded`` and ``local_shape`` are not ported yet (ROADMAP A13b).
    """
    if prepadded or local_shape is not None:
        raise NotImplementedError("prepadded / local_shape (the sharded ADE step) are not "
                                  "ported yet (ROADMAP A13b)")
    return FusedStepADE(cfg, domain, device, variable_diffusion=variable_diffusion,
                        transfer_coeff=transfer_coeff)
