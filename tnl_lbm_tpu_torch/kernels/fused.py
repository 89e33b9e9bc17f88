"""The A-B step (B4) and the per-site logic of the fused kernels in plain PyTorch.

Counterpart of ``tnl_lbm_tpu/kernels/fused.py``: the layout-independent
half (``_prep``, ``_moments_local``, ``_eq_local``, ``_eq_kind``,
``_pull_transform``, ``_stream_bc_collide``) and ``make_fused_step``, the
A-B step with the full 3D boundary set.  The same logic, per site, is the
CUDA device code in ``csrc/lbm_site.cuh``; the functions here are its plain
versions, run on whole arrays for CPU tensors (here and in
``kernels/fused_aa.py``) and used as the oracle the CUDA kernels are held
against.

``shifted(q, (ox, oy, oz))`` returns DF component q read at the given site
offsets - the only layout-dependent piece, supplied by the caller.

:class:`FusedStepAB` launches ``csrc/ab_step.cu`` on CUDA tensors and runs
its plain version on CPU tensors; it never runs the plain version in the
kernel's place.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from tnl_lbm_tpu_torch.kernels.build import load_library
from tnl_lbm_tpu_torch.ops import boundary as bc
from tnl_lbm_tpu_torch.ops import collision as col
from tnl_lbm_tpu_torch.ops import equilibrium as eqlib
from tnl_lbm_tpu_torch.ops import streaming as stream
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.step import SUPPORTED_CODES, check_supported

#: CUDA grid limit on the y and z block indices, which carry Y and X
_MAX_GRID_YZ = 65535

#: GEO codes the A-B kernel (B4) handles: the full 3D set (JAX fused.py:40-46)
AB_CODES = frozenset(SUPPORTED_CODES)
#: GEO codes the A-A even/odd kernels (B2, B3, and B8's NSE half) handle:
#: the 3D set but OUTFLOW_RIGHT_INTERP, which is A-B only (JAX fused_aa.py:353-358)
AA_CODES = AB_CODES - {GEO.OUTFLOW_RIGHT_INTERP}
#: GEO codes the one-kernel A-A pair (B1) handles so far; the rest is ROADMAP B1
PAIR_CODES = frozenset({GEO.FLUID, GEO.WALL, GEO.NOTHING})

#: ``tnl_lbm_ab_step`` / ``tnl_lbm_aa_even`` / ``tnl_lbm_aa_odd`` variant per
#: (well, equilibrium kind)
_AB_VARIANTS = {(True, "well"): 0, (False, "quad"): 1, (False, "invcum"): 2}
#: the A-A kernels' variant for CUM_WELL on a map of PAIR_CODES: the odd step's lean
#: instance without the boundary switch (the even step runs its CUM_WELL instance)
_AA_LEAN_VARIANT = 3


@dataclasses.dataclass
class CudaKernel:
    """One hand-written kernel: its name, where it lives, which Pallas
    kernel it replaces, and how often its wrapper launched it."""

    name: str
    source: str
    replaces: str
    launches: int = 0


def kernel_codes(streaming: str, pair: bool = False) -> frozenset:
    """The GEO codes the kernels of a streaming pattern handle (``pair``:
    the one-kernel A-A pair's)."""
    if pair:
        return PAIR_CODES
    return AA_CODES if streaming == "AA" else AB_CODES


def supports(domain: Domain, streaming: str = "AB", pair: bool = False) -> bool:
    """True when the kernels of ``streaming`` handle every GEO code present:
    the full set for the A-B kernel, all but OUTFLOW_RIGHT_INTERP for the
    A-A even/odd kernels, FLUID/WALL/NOTHING for the pair.  Scans the host
    map."""
    return domain.codes_present() <= kernel_codes(streaming, pair)


def host_vector3(value, what: str, roadmap: str) -> tuple[float, float, float]:
    """A homogeneous [3] input (u_in, force) as three float32-rounded Python
    floats; None is zero.  A CUDA tensor is refused rather than read back
    to the host once per step; a per-site field raises naming ``roadmap``."""
    if value is None:
        return (0.0, 0.0, 0.0)
    if torch.is_tensor(value):
        if value.device.type != "cpu":
            raise ValueError(f"{what} must be given as host values (floats, numpy or a CPU "
                             f"tensor), not a tensor on {value.device}")
        value = value.detach().numpy()
    arr = np.asarray(value)
    if arr.shape != (3,):
        raise NotImplementedError(f"per-site {what} fields are not ported yet ({roadmap})")
    return tuple(float(v) for v in arr.astype(np.float32))


def _force3(force) -> tuple[float, float, float]:
    return host_vector3(force, "force", "ROADMAP A11: force_field variant")


def _u_in3(u_in) -> tuple[float, float, float]:
    return host_vector3(u_in, "inflow velocity", "ROADMAP A6/A8: inflow profiles")


def _periodic_bits(periodic) -> int:
    return sum(1 << a for a, p in enumerate(periodic) if p)


def _eq_kind(cfg: LBMConfig) -> str:
    """The in-kernel equilibrium of a config (JAX fused.py:144)."""
    if cfg.eq is eqlib.eq_inv_cum:
        return "invcum"
    if cfg.eq is eqlib.eq_well or cfg.well:
        return "well"
    if cfg.eq is eqlib.eq_quadratic:
        return "quad"
    raise NotImplementedError(f"equilibrium {getattr(cfg.eq, '__name__', cfg.eq)} is not "
                              f"ported (eq_entropic: ROADMAP A8)")


def _check_kernel_config(cfg: LBMConfig, domain: Domain, device: torch.device,
                         pair: bool = False) -> None:
    """Refuse, at build time, what the CUDA kernels do not implement: the
    A-B step and the A-A even/odd steps take the three variants of
    ``_AB_VARIANTS``, the pair (``pair``) CUM_WELL only."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    well_cascade = cfg.collision is col.collide_cum_well
    if pair:
        if not well_cascade:
            raise NotImplementedError("the A-A pair kernel implements CUM_WELL only "
                                      "(other collisions: ROADMAP B1)")
    else:
        kind = "A-A" if cfg.streaming == "AA" else "A-B"
        if not (well_cascade or cfg.collision is col.collide_cum):
            raise NotImplementedError(f"the {kind} CUDA kernels implement CUM and CUM_WELL only "
                                      f"(other collisions: ROADMAP A8)")
        if (cfg.well, _eq_kind(cfg)) not in _AB_VARIANTS or well_cascade != cfg.well:
            raise NotImplementedError(
                f"the {kind} CUDA kernels take CUM_WELL with well=True, or CUM with "
                f"eq_quadratic / eq_inv_cum and well=False; got well={cfg.well}, "
                f"equilibrium kind {_eq_kind(cfg)!r}")
    if cfg.compute_dtype != torch.float32:
        raise NotImplementedError("the CUDA kernels compute in float32 only "
                                  "(f64 kernels: ROADMAP A8)")
    X, Y, _ = domain.shape
    if X > _MAX_GRID_YZ or Y > _MAX_GRID_YZ:
        raise ValueError(f"X and Y must be <= {_MAX_GRID_YZ} for the kernel grid")


def _moments_local(lat, f_in, force, well, high_precision=False):
    """rho and u (with the half force) as sequential sums over q - the
    order the CUDA ``moments_local`` adds in.  ``force`` holds 3 scalars."""
    if high_precision:
        s = f_in[0]
        comp = torch.zeros_like(s)
        for q in range(1, lat.Q):
            x = f_in[q]
            t = s + x
            comp = comp + torch.where(torch.abs(s) >= torch.abs(x), (s - t) + x, (x - t) + s)
            s = t
        rho = s + comp
    else:
        rho = f_in[0]
        for q in range(1, lat.Q):
            rho = rho + f_in[q]
    if well:
        rho = rho + 1
    j = []
    for a in range(3):
        acc = None
        for q in range(lat.Q):
            c = int(lat.c[q][a])
            if c == 0:
                continue
            term = f_in[q] if c > 0 else -f_in[q]
            acc = term if acc is None else acc + term
        j.append(acc)
    u = torch.stack([(j[a] + 0.5 * force[a]) / rho for a in range(3)])
    return rho, u


def _eq_local(lat, rho, u, kind):
    """Equilibria with per-q scalar weights: "quad", "well" (the deviation
    w (feq - 1)) or "invcum" (the per-axis product form); the CUDA ``eq_q``."""
    if kind == "invcum":
        return eqlib.eq_inv_cum(lat, rho, u)
    uu = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
    rows = []
    for q in range(lat.Q):
        cx, cy, cz = (int(v) for v in lat.c[q])
        cu = cx * u[0] + cy * u[1] + cz * u[2]
        w = float(lat.w[q])
        feq = rho * (1 + 3 * cu + 4.5 * cu * cu - 1.5 * uu)
        rows.append(w * (feq - 1) if kind == "well" else w * feq)
    return torch.stack(rows)


def _prep(cfg: LBMConfig, domain: Domain, pair: bool = False):
    """Static code analysis shared by the kernels, done once at build time:
    the lattice, the GEO codes present and the codes on which the collision
    runs (``pair``: the one-kernel A-A pair, see ``check_supported``).  The
    pair refuses the codes beyond FLUID/WALL/NOTHING; the A-A pattern
    refuses OUTFLOW_RIGHT_INTERP (``check_supported``)."""
    codes = domain.codes_present()
    check_supported(cfg, domain, pair=pair, codes=codes)
    lat = cfg.lat
    if lat.D != 3:
        raise NotImplementedError("the fused kernels are for the 3D lattices")
    extra = codes - kernel_codes(cfg.streaming, pair)
    if extra:
        names = ", ".join(sorted(c.name for c in extra))
        raise NotImplementedError(
            f"the A-A pair kernel handles FLUID, WALL and NOTHING only; GEO codes {names} "
            f"in the pair are ROADMAP B1 (the A-A even/odd kernels take them)")
    do_coll_codes = sorted(int(c) for c in (bc.collision_mask_codes(3) & codes))
    return lat, codes, do_coll_codes


def aa_variant(cfg: LBMConfig, codes, lean: bool = True) -> int:
    """The A-A even/odd kernels' variant for (cfg, the codes present):
    ``_AA_LEAN_VARIANT`` for CUM_WELL on a map of FLUID/WALL/NOTHING when
    ``lean``, else the A-B step's variant."""
    variant = _AB_VARIANTS[(cfg.well, _eq_kind(cfg))]
    if lean and variant == 0 and codes <= PAIR_CODES:
        return _AA_LEAN_VARIANT
    return variant


def _pull_transform(lat, codes, shifted, masks):
    """Streaming-stage reads + pull-side BC transforms: the pull of the 27
    components, the outflow pull rules, the WALL swap and the symmetry
    mirrors - everything before the moments."""
    Q = lat.Q
    opp = np.asarray(lat.opp)
    f_in = torch.stack([shifted(q, tuple(-int(v) for v in lat.c[q])) for q in range(Q)])
    if GEO.OUTFLOW_RIGHT in codes:
        rows = [shifted(q, (-1, -int(lat.c[q][1]), -int(lat.c[q][2]))) for q in range(Q)]
        f_in = torch.where(masks[GEO.OUTFLOW_RIGHT], torch.stack(rows), f_in)
    if GEO.OUTFLOW_RIGHT_INTERP in codes:
        # Geier speed-of-sound interpolated outflow: the c_x = -1 components
        # blend x-1 and x (streaming_AB.h:209-242)
        cs = stream.SPEED_OF_SOUND
        rows = []
        for q in range(Q):
            cx, cy, cz = (int(v) for v in lat.c[q])
            if cx == -1:
                rows.append(cs * shifted(q, (-1, -cy, -cz)) + (1 - cs) * shifted(q, (0, -cy, -cz)))
            else:
                rows.append(f_in[q])
        f_in = torch.where(masks[GEO.OUTFLOW_RIGHT_INTERP], torch.stack(rows), f_in)
    if GEO.WALL in codes:
        f_swapped = torch.stack([f_in[int(opp[q])] for q in range(Q)])
        f_in = torch.where(masks[GEO.WALL], f_swapped, f_in)
    for c in sorted(codes & bc.sym_table(3).keys()):
        axis, sign = bc.sym_table(3)[c]
        mirror = np.asarray(lat.mirror(axis))
        f_in = torch.stack([
            torch.where(masks[c], f_in[int(mirror[q])], f_in[q])
            if int(lat.c[q][axis]) == sign else f_in[q]
            for q in range(Q)])
    return f_in


def _stream_bc_collide(lat, cfg, codes, do_coll_codes, shifted, m, nu, force,
                       u_in=(0.0, 0.0, 0.0), out_perm=None, defer_nothing=False):
    """Pull-stream + BC mask-selects + collision on whole arrays.

    ``m`` is the int map of the sites computed, ``force`` and ``u_in`` 3
    scalars each.  ``out_perm`` permutes the output components before the
    NOTHING restore (the A-A even step writes opposite-direction,
    streaming_AA.h:16-45); ``defer_nothing=True`` skips the restore - the
    A-A odd step applies it at the destination site, after the push.
    """
    Q = lat.Q
    masks = {c: (m == int(c)) for c in codes}
    f_in = _pull_transform(lat, codes, shifted, masks)
    rho, u = _moments_local(lat, f_in, force, cfg.well, high_precision=cfg.high_precision_rho)

    f_in, rho, u = bc.apply_moment_bcs(lat, codes, masks, f_in, rho, u, u_in,
                                       lambda r, v: _eq_local(lat, r, v, _eq_kind(cfg)), cfg.well)

    one = torch.ones((), dtype=f_in.dtype, device=f_in.device)
    rho_safe = torch.where(rho == 0, one, rho)
    f_post = cfg.collision(lat, f_in, rho_safe, u, nu)
    do_coll = torch.zeros_like(m, dtype=torch.bool)
    for code in do_coll_codes:
        do_coll = do_coll | (m == code)
    f_post = torch.where(do_coll, f_post, f_in)

    if out_perm is not None:
        f_post = torch.stack([f_post[int(out_perm[q])] for q in range(Q)])
    if GEO.NOTHING in codes and not defer_nothing:
        center = torch.stack([shifted(q, (0, 0, 0)) for q in range(Q)])
        f_post = torch.where(masks[GEO.NOTHING], center, f_post)

    rho_out, u_out = rho, u
    for c in (GEO.WALL, GEO.NOTHING):
        if c in codes:
            rho_out = torch.where(masks[c], one, rho_out)
            u_out = torch.where(masks[c], torch.zeros_like(u), u_out)
    return f_post, rho_out, u_out


class FusedStepAB:
    """``step(f, nu, u_in=None, force=None, parity=0, out=None) -> (f_new, rho, u)``.

    One A-B step (pull, the full 3D BC set, CUM_WELL or CUM) out of place:
    the result goes to a new tensor, or into ``out`` (a second state
    buffer, not ``f``), so a caller can ping-pong two buffers.  ``u_in``
    and ``force`` are homogeneous [3] vectors, given as host values;
    ``parity`` is accepted for the common step contract and ignored.
    ``kernel`` counts the launches, ``plain_calls`` the CPU-path calls.
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, device):
        if cfg.streaming != "AB":
            raise ValueError("make_fused_step needs streaming='AB'")
        self.cfg = cfg
        self.device = torch.device(device)
        self.lat, self.codes, self.do_coll_codes = _prep(cfg, domain)
        self.shape = domain.shape
        self.periodic = domain.periodic
        self.kernel = CudaKernel("ab_step", "tnl_lbm_tpu_torch/csrc/ab_step.cu",
                                 "tnl_lbm_tpu/kernels/fused.py:585")
        self.plain_calls = 0
        if self.device.type == "cuda":
            _check_kernel_config(cfg, domain, self.device)
            self._variant = _AB_VARIANTS[(cfg.well, _eq_kind(cfg))]
        self.map = torch.as_tensor(np.ascontiguousarray(domain.map, np.uint8), device=self.device)

    def reset_counts(self) -> None:
        self.kernel.launches = self.plain_calls = 0

    def __call__(self, f, nu, u_in=None, force=None, parity: int = 0, out=None):
        del parity
        uvec, fvec = _u_in3(u_in), _force3(force)
        if out is not None and (out is f or out.shape != f.shape or out.dtype != f.dtype
                                or out.device != f.device or not out.is_contiguous()):
            raise ValueError("out must be a second contiguous state buffer like f")
        if f.device.type == "cuda":
            return self._launch(f, float(nu), fvec, uvec, out)
        self.plain_calls += 1
        f_new, rho, u = self._plain(f, nu, fvec, uvec)
        if out is not None:
            f_new = out.copy_(f_new)
        return f_new, rho, u

    def plain(self, f, nu, u_in=None, force=None):
        """The step's plain PyTorch version on f's device: (f_new, rho, u),
        f untouched.  The CPU path, and the oracle the kernel is held
        against on the card; it counts no call."""
        return self._plain(f, nu, _force3(force), _u_in3(u_in))

    def _plain(self, f, nu, fvec, uvec):
        """The step on ``pad_halo``-pulled whole arrays; f untouched."""
        S = tuple(f.shape[1:])
        fpad = stream.pad_halo(f, self.periodic)

        def shifted(q, offs):
            return stream._shift_slices(fpad[q], offs, S)

        return _stream_bc_collide(self.lat, self.cfg, self.codes, self.do_coll_codes, shifted,
                                  self.map.to(f.device), nu, fvec, u_in=uvec)

    def _launch(self, f, nu, fvec, uvec, out):
        if self.device.type != "cuda" or f.device != self.map.device:
            raise ValueError(f"f is on {f.device}, the step was built for {self.device}")
        if f.dtype != torch.float32:
            raise NotImplementedError("the CUDA kernels take float32 state only")
        X, Y, Z = self.shape
        if tuple(f.shape) != (self.lat.Q, X, Y, Z) or not f.is_contiguous():
            raise ValueError(f"f must be a contiguous [{self.lat.Q}, {X}, {Y}, {Z}] tensor, "
                             f"got {tuple(f.shape)}")
        lib = load_library()
        f_new = torch.empty_like(f) if out is None else out
        rho = torch.empty((X, Y, Z), dtype=f.dtype, device=f.device)
        u = torch.empty((3, X, Y, Z), dtype=f.dtype, device=f.device)
        stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
        rc = lib.tnl_lbm_ab_step(f.data_ptr(), f_new.data_ptr(), self.map.data_ptr(),
                                 rho.data_ptr(), u.data_ptr(), X, Y, Z,
                                 _periodic_bits(self.periodic), self._variant, nu, *fvec, *uvec,
                                 int(self.cfg.high_precision_rho), stream_ptr)
        if rc != 0:
            raise RuntimeError(f"{self.kernel.name} launch failed: CUDA error {rc}")
        self.kernel.launches += 1
        return f_new, rho, u


def make_fused_step(cfg: LBMConfig, domain: Domain, device, with_macro: bool = True,
                    prepadded: bool = False, local_shape=None, force_field: bool = False,
                    macro_only: bool = False) -> FusedStepAB:
    """A-B step for (cfg, domain) on ``device``: see :class:`FusedStepAB`.

    The JAX function's TPU knobs (``tile``, ``tiles_per_program``) shape
    its VMEM windows and have no counterpart here.  Its variants are not
    ported yet: ``force_field`` and ``macro_only`` (ROADMAP A11),
    ``prepadded`` and ``local_shape`` (the sharded path, ROADMAP A13), and
    ``with_macro=False``, the benchmark variant without the rho/u writes
    (ROADMAP A7).
    """
    if force_field or macro_only:
        raise NotImplementedError("force_field / macro_only are not ported yet (ROADMAP A11)")
    if prepadded or local_shape is not None:
        raise NotImplementedError("prepadded / local_shape (the sharded A-B step) are not "
                                  "ported yet (ROADMAP A13)")
    if not with_macro:
        raise NotImplementedError("with_macro=False is not ported yet (ROADMAP A7)")
    return FusedStepAB(cfg, domain, device)
