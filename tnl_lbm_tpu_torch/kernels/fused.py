"""The A-B step (B4) and the per-site logic of the fused kernels in plain PyTorch.

Counterpart of ``tnl_lbm_tpu/kernels/fused.py``: the layout-independent
half (``_prep``, ``_moments_local``, ``_eq_local``, ``_eq_kind``,
``_pull_transform``, ``_stream_bc_collide``; the last four also serve the
D2Q9 step of ``kernels/fused_2d.py``) and ``make_fused_step``, the A-B step
with the full 3D boundary set.  The same logic, per site, is the
CUDA device code in ``csrc/lbm_site.cuh``; the functions here are its plain
versions, run on whole arrays for CPU tensors (here and in
``kernels/fused_aa.py``) and used as the oracle the CUDA kernels are held
against.

``shifted(q, (ox, oy, oz))`` returns DF component q read at the given site
offsets - the only layout-dependent piece, supplied by the caller.

:class:`FusedStepAB` launches ``csrc/ab_step.cu`` on CUDA tensors and runs
its plain version on CPU tensors; it never runs the plain version in the
kernel's place.  :class:`FusedStepSiteMajor` is the same step on the
site-major layout [X, Y, QPAD, Z] (``csrc/ab_step_sitemajor.cu``).
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
        raise NotImplementedError(f"a per-site {what} field is not taken here ({roadmap})")
    return tuple(float(v) for v in arr.astype(np.float32))


def _force3(force) -> tuple[float, float, float]:
    return host_vector3(force, "force", "the force_field variants take one")


def _u_in3(u_in) -> tuple[float, float, float]:
    return host_vector3(u_in, "inflow velocity", "inflow profiles: ROADMAP A6/A8")


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
    order the CUDA ``moments_local`` adds in.  ``force`` holds D scalars."""
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
    for a in range(lat.D):
        acc = None
        for q in range(lat.Q):
            c = int(lat.c[q][a])
            if c == 0:
                continue
            term = f_in[q] if c > 0 else -f_in[q]
            acc = term if acc is None else acc + term
        j.append(acc)
    u = torch.stack([(j[a] + 0.5 * force[a]) / rho for a in range(lat.D)])
    return rho, u


def _eq_local(lat, rho, u, kind):
    """Equilibria with per-q scalar weights: "quad", "well" (the deviation
    w (feq - 1)) or "invcum" (the per-axis product form); the CUDA ``eq_q``."""
    if kind == "invcum":
        return eqlib.eq_inv_cum(lat, rho, u)
    uu = u[0] * u[0]
    for a in range(1, lat.D):
        uu = uu + u[a] * u[a]
    rows = []
    for q in range(lat.Q):
        cu = int(lat.c[q][0]) * u[0]
        for a in range(1, lat.D):
            cu = cu + int(lat.c[q][a]) * u[a]
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
    if cfg.forcing_hook is not None:
        raise NotImplementedError("a config with a forcing hook runs through "
                                  "kernels/hooked.py make_hooked_fused_step, which builds "
                                  "these kernels on the config without it")
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


def _pull_transform(lat, codes, shifted, masks, thetas=None):
    """Streaming-stage reads + pull-side BC transforms: the pull of the Q
    components, the outflow pull rules, the Bouzidi pull at FLUID_NEAR_WALL
    sites (with ``thetas``, D2Q9), the WALL swap and the symmetry mirrors -
    everything before the moments."""
    Q = lat.Q
    opp = np.asarray(lat.opp)

    def from_x(q, dx):
        """Component q pulled along y (and z) as streaming does, from x + dx."""
        return shifted(q, (dx,) + tuple(-int(v) for v in lat.c[q][1:]))

    f_in = torch.stack([shifted(q, tuple(-int(v) for v in lat.c[q])) for q in range(Q)])
    if GEO.OUTFLOW_RIGHT in codes:
        rows = [from_x(q, -1) for q in range(Q)]
        f_in = torch.where(masks[GEO.OUTFLOW_RIGHT], torch.stack(rows), f_in)
    if GEO.OUTFLOW_RIGHT_INTERP in codes:
        # Geier speed-of-sound interpolated outflow: the c_x = -1 components
        # blend x-1 and x (streaming_AB.h:209-242)
        cs = stream.SPEED_OF_SOUND
        rows = [cs * from_x(q, -1) + (1 - cs) * from_x(q, 0) if int(lat.c[q][0]) == -1
                else f_in[q] for q in range(Q)]
        f_in = torch.where(masks[GEO.OUTFLOW_RIGHT_INTERP], torch.stack(rows), f_in)
    if thetas is not None and GEO.FLUID_NEAR_WALL in codes:
        f_in = torch.where(masks[GEO.FLUID_NEAR_WALL],
                           stream.bouzidi(lat, shifted, f_in, thetas), f_in)
    if GEO.WALL in codes:
        f_swapped = torch.stack([f_in[int(opp[q])] for q in range(Q)])
        f_in = torch.where(masks[GEO.WALL], f_swapped, f_in)
    for c in sorted(codes & bc.sym_table(lat.D).keys()):
        axis, sign = bc.sym_table(lat.D)[c]
        mirror = np.asarray(lat.mirror(axis))
        f_in = torch.stack([
            torch.where(masks[c], f_in[int(mirror[q])], f_in[q])
            if int(lat.c[q][axis]) == sign else f_in[q]
            for q in range(Q)])
    return f_in


def _stream_bc_collide(lat, cfg, codes, do_coll_codes, shifted, m, nu, force,
                       u_in=(0.0, 0.0, 0.0), out_perm=None, defer_nothing=False, thetas=None,
                       collision_force=None, macro_only=False):
    """Pull-stream + BC mask-selects + collision on whole arrays.

    ``m`` is the int map of the sites computed, ``force`` D scalars or D
    per-site fields (the force_field variants), ``u_in`` D scalars or a
    [D, ...] profile broadcastable to the sites.  ``macro_only=True`` is the
    u* pre-pass (reference kernels.h:178-218): it returns (None, rho, u),
    the moments of the pulled and wall/symmetry-transformed DFs with the
    homogeneous force, before the inflow/outflow macro overrides.
    ``out_perm`` permutes the output components before the NOTHING restore
    (the A-A even step writes opposite-direction, streaming_AA.h:16-45);
    ``defer_nothing=True`` skips the restore - the A-A odd step applies it
    at the destination site, after the push.  ``thetas`` are the Bouzidi
    thetas (D2Q9); ``collision_force`` goes to the collision as its
    ``force`` (the D2Q9 SRT's Guo term; None for the cumulant cascades,
    which take the force through u).
    """
    Q = lat.Q
    masks = {c: (m == int(c)) for c in codes}
    f_in = _pull_transform(lat, codes, shifted, masks, thetas)
    rho, u = _moments_local(lat, f_in, force, cfg.well, high_precision=cfg.high_precision_rho)
    if macro_only:
        return None, rho, u

    f_in, rho, u = bc.apply_moment_bcs(lat, codes, masks, f_in, rho, u, u_in,
                                       lambda r, v: _eq_local(lat, r, v, _eq_kind(cfg)), cfg.well)

    one = torch.ones((), dtype=f_in.dtype, device=f_in.device)
    rho_safe = torch.where(rho == 0, one, rho)
    f_post = cfg.collision(lat, f_in, rho_safe, u, nu, force=collision_force)
    do_coll = torch.zeros_like(m, dtype=torch.bool)
    for code in do_coll_codes:
        do_coll = do_coll | (m == code)
    f_post = torch.where(do_coll, f_post, f_in)

    if out_perm is not None:
        f_post = torch.stack([f_post[int(out_perm[q])] for q in range(Q)])
    if GEO.NOTHING in codes and not defer_nothing:
        center = torch.stack([shifted(q, (0,) * lat.D) for q in range(Q)])
        f_post = torch.where(masks[GEO.NOTHING], center, f_post)

    rho_out, u_out = rho, u
    for c in (GEO.WALL, GEO.NOTHING):
        if c in codes:
            rho_out = torch.where(masks[c], one, rho_out)
            u_out = torch.where(masks[c], torch.zeros_like(u), u_out)
    return f_post, rho_out, u_out


#: the ``mode`` argument of ``tnl_lbm_ab_step`` / ``tnl_lbm_aa_even`` / ``tnl_lbm_aa_odd``:
#: the step, the step with a per-site force (force_field), the u* pre-pass (macro_only)
MODE_STEP, MODE_FORCE_FIELD, MODE_MACRO_ONLY = 0, 1, 2


def variant_mode(force_field: bool, macro_only: bool) -> tuple[int, str]:
    """(the C ``mode``, the kernel-name suffix) of a step variant."""
    if force_field and macro_only:
        raise ValueError("force_field and macro_only exclude each other")
    if force_field:
        return MODE_FORCE_FIELD, "_force_field"
    return (MODE_MACRO_ONLY, "_macro_only") if macro_only else (MODE_STEP, "")


def check_force_field(field, D: int, shape, device) -> torch.Tensor:
    """The per-site force of a force_field step: a contiguous float32
    [D, *S] tensor on ``device``, as the kernel reads it."""
    want = (D,) + tuple(shape)
    if (not torch.is_tensor(field) or tuple(field.shape) != want
            or field.dtype != torch.float32 or field.device != device
            or not field.is_contiguous()):
        got = (tuple(field.shape), field.dtype, field.device) if torch.is_tensor(field) else field
        raise ValueError(f"a force_field step takes its force as a contiguous float32 {want} "
                         f"tensor on {device}, got {got}")
    return field


def site_force(field, fadd):
    """The per-site force the force_field variants apply: the homogeneous
    ``fadd`` (D float32 values) plus the field, as the plain hooked step
    adds the hook's output to the body force."""
    return [fadd[a] + field[a] for a in range(field.shape[0])]


class FusedStepAB:
    """``step(f, nu, u_in=None, force=None, parity=0, out=None) -> (f_new, rho, u)``.

    One A-B step (pull, the full 3D BC set, CUM_WELL or CUM) out of place:
    the result goes to a new tensor, or into ``out`` (a second state
    buffer, not ``f``), so a caller can ping-pong two buffers.  ``u_in``
    and ``force`` are homogeneous [3] vectors, given as host values;
    ``parity`` is accepted for the common step contract and ignored.
    ``kernel`` counts the launches, ``plain_calls`` the CPU-path calls.

    Variants (JAX ``make_fused_step``'s flags), each its own kernel instance:

    - ``force_field``: ``force`` is a per-site [3, X, Y, Z] float32 tensor on
      f's device, read at each site in place of the homogeneous force; a
      [3] host vector ``force_add`` is added to it at every site (the
      hooked pipeline's body force, so that no pass sums the two);
    - ``macro_only``: the u* pre-pass - ``step(f, nu, u_in=None,
      force=None) -> (rho0, u0)``: pull, the outflow pull rules, the WALL
      swap and the symmetry mirrors, the moments with the homogeneous
      force; no collision, no f output, no inflow/outflow macro override.
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, device, force_field: bool = False,
                 macro_only: bool = False):
        if cfg.streaming != "AB":
            raise ValueError("make_fused_step needs streaming='AB'")
        self.cfg = cfg
        self.device = torch.device(device)
        self.lat, self.codes, self.do_coll_codes = _prep(cfg, domain)
        self.shape = domain.shape
        self.periodic = domain.periodic
        self.force_field, self.macro_only = force_field, macro_only
        self._mode, suffix = variant_mode(force_field, macro_only)
        self.kernel = CudaKernel("ab_step" + suffix, "tnl_lbm_tpu_torch/csrc/ab_step.cu",
                                 "tnl_lbm_tpu/kernels/fused.py:585")
        self.plain_calls = 0
        if self.device.type == "cuda":
            _check_kernel_config(cfg, domain, self.device)
            self._variant = _AB_VARIANTS[(cfg.well, _eq_kind(cfg))]
        self.map = torch.as_tensor(np.ascontiguousarray(domain.map, np.uint8), device=self.device)

    def reset_counts(self) -> None:
        self.kernel.launches = self.plain_calls = 0

    def _forces(self, f, force, force_add):
        """(the per-site field or None, the homogeneous three floats)."""
        if self.force_field:
            return check_force_field(force, 3, self.shape, f.device), _force3(force_add)
        if force_add is not None:
            raise ValueError("force_add belongs to the force_field variant")
        return None, _force3(force)

    def __call__(self, f, nu, u_in=None, force=None, parity: int = 0, out=None,
                 force_add=None):
        del parity
        field, fvec = self._forces(f, force, force_add)
        uvec = _u_in3(u_in)
        if out is not None and (self.macro_only or out is f or out.shape != f.shape
                                or out.dtype != f.dtype or out.device != f.device
                                or not out.is_contiguous()):
            raise ValueError("out must be a second contiguous state buffer like f "
                             "(and the u* pass writes no state)")
        if f.device.type == "cuda":
            return self._launch(f, float(nu), field, fvec, uvec, out)
        self.plain_calls += 1
        f_new, rho, u = self._plain(f, nu, fvec, uvec, field)
        if self.macro_only:
            return rho, u
        if out is not None:
            f_new = out.copy_(f_new)
        return f_new, rho, u

    def plain(self, f, nu, u_in=None, force=None, parity: int = 0, force_add=None):
        """The step's plain PyTorch version on f's device: (f_new, rho, u),
        or (rho0, u0) for the u* pass; f untouched (``parity`` is ignored,
        as by the step).  The CPU path, and the oracle the kernel is held
        against on the card; it counts no call."""
        del parity
        field, fvec = self._forces(f, force, force_add)
        f_new, rho, u = self._plain(f, nu, fvec, _u_in3(u_in), field)
        return (rho, u) if self.macro_only else (f_new, rho, u)

    def _plain(self, f, nu, fvec, uvec, field=None):
        """The step on ``pad_halo``-pulled whole arrays (``field``: the
        force_field variant's per-site force); f untouched."""
        S = tuple(f.shape[1:])
        fpad = stream.pad_halo(f, self.periodic)

        def shifted(q, offs):
            return stream._shift_slices(fpad[q], offs, S)

        force = fvec if field is None else site_force(field, fvec)
        return _stream_bc_collide(self.lat, self.cfg, self.codes, self.do_coll_codes, shifted,
                                  self.map.to(f.device), nu, force, u_in=uvec,
                                  macro_only=self.macro_only)

    def _launch(self, f, nu, field, fvec, uvec, out):
        if self.device.type != "cuda" or f.device != self.map.device:
            raise ValueError(f"f is on {f.device}, the step was built for {self.device}")
        if f.dtype != torch.float32:
            raise NotImplementedError("the CUDA kernels take float32 state only")
        X, Y, Z = self.shape
        if tuple(f.shape) != (self.lat.Q, X, Y, Z) or not f.is_contiguous():
            raise ValueError(f"f must be a contiguous [{self.lat.Q}, {X}, {Y}, {Z}] tensor, "
                             f"got {tuple(f.shape)}")
        lib = load_library()
        f_new = None
        if not self.macro_only:
            f_new = torch.empty_like(f) if out is None else out
        rho = torch.empty((X, Y, Z), dtype=f.dtype, device=f.device)
        u = torch.empty((3, X, Y, Z), dtype=f.dtype, device=f.device)
        stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
        rc = lib.tnl_lbm_ab_step(f.data_ptr(), None if f_new is None else f_new.data_ptr(),
                                 self.map.data_ptr(), None if field is None else field.data_ptr(),
                                 rho.data_ptr(), u.data_ptr(), X, Y, Z,
                                 _periodic_bits(self.periodic), self._variant, self._mode, nu,
                                 *fvec, *uvec, int(self.cfg.high_precision_rho), stream_ptr)
        if rc != 0:
            raise RuntimeError(f"{self.kernel.name} launch failed: CUDA error {rc}")
        self.kernel.launches += 1
        return (rho, u) if self.macro_only else (f_new, rho, u)


def make_fused_step(cfg: LBMConfig, domain: Domain, device, with_macro: bool = True,
                    prepadded: bool = False, local_shape=None, force_field: bool = False,
                    macro_only: bool = False) -> FusedStepAB:
    """A-B step for (cfg, domain) on ``device``: see :class:`FusedStepAB`,
    with its ``force_field`` and ``macro_only`` variants.

    The JAX function's TPU knobs (``tile``, ``tiles_per_program``) shape
    its VMEM windows and have no counterpart here.  Not ported yet:
    ``prepadded`` and ``local_shape`` (the sharded path, ROADMAP A13), and
    ``with_macro=False``, the benchmark variant without the rho/u writes
    (ROADMAP A7).
    """
    if prepadded or local_shape is not None:
        raise NotImplementedError("prepadded / local_shape (the sharded A-B step) are not "
                                  "ported yet (ROADMAP A13)")
    if not with_macro:
        raise NotImplementedError("with_macro=False is not ported yet (ROADMAP A7)")
    return FusedStepAB(cfg, domain, device, force_field=force_field, macro_only=macro_only)


#: components per site of the site-major layout: Q padded to 32 with zeros
QPAD = 32


def to_sitemajor(f: torch.Tensor) -> torch.Tensor:
    """[Q, X, Y, Z] -> [X, Y, QPAD, Z], the dummy components zero-filled."""
    Q, X, Y, Z = f.shape
    fs = f.new_zeros((X, Y, QPAD, Z))
    fs[:, :, :Q] = f.permute(1, 2, 0, 3)
    return fs


def from_sitemajor(fs: torch.Tensor, Q: int) -> torch.Tensor:
    """[X, Y, QPAD, Z] -> [Q, X, Y, Z] (contiguous)."""
    return fs[:, :, :Q].permute(2, 0, 1, 3).contiguous()


class FusedStepSiteMajor:
    """``step(fs, nu, u_in=None, force=None, parity=0, map_arr_in=None) -> (fs_new, rho, u)``.

    The A-B step (B4's update, boundary set and variants) on the
    site-major layout [X, Y, QPAD, Z] of ``to_sitemajor`` (JAX
    ``make_fused_step_sitemajor``, B4s): a new state whose five dummy
    components are zero, rho [X, Y, Z] and u [3, X, Y, Z] (None with
    ``with_macro=False``).  ``map_arr_in`` replaces the domain's map for
    this call (a [X, Y, Z] map of the codes the domain has).  ``kernel``
    counts the launches, ``plain_calls`` the CPU-path calls.
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, device, with_macro: bool = True):
        if cfg.streaming != "AB":
            raise ValueError("make_fused_step_sitemajor needs streaming='AB'")
        self.cfg = cfg
        self.with_macro = with_macro
        self.device = torch.device(device)
        self.lat, self.codes, self.do_coll_codes = _prep(cfg, domain)
        self.shape = domain.shape
        self.periodic = domain.periodic
        self.kernel = CudaKernel("ab_step_sitemajor", "tnl_lbm_tpu_torch/csrc/ab_step_sitemajor.cu",
                                 "tnl_lbm_tpu/kernels/fused.py:732")
        self.plain_calls = 0
        if self.device.type == "cuda":
            _check_kernel_config(cfg, domain, self.device)
            self._variant = _AB_VARIANTS[(cfg.well, _eq_kind(cfg))]
        self.map = torch.as_tensor(np.ascontiguousarray(domain.map, np.uint8), device=self.device)

    def reset_counts(self) -> None:
        self.kernel.launches = self.plain_calls = 0

    def _map(self, fs, map_arr_in):
        if map_arr_in is None:
            return self.map
        m = torch.as_tensor(np.asarray(map_arr_in) if not torch.is_tensor(map_arr_in)
                            else map_arr_in).to(device=fs.device, dtype=torch.uint8)
        if tuple(m.shape) != tuple(self.shape):
            raise ValueError(f"map_arr_in must be {list(self.shape)}, got {tuple(m.shape)}")
        return m.contiguous()

    def _check(self, fs) -> None:
        X, Y, Z = self.shape
        if tuple(fs.shape) != (X, Y, QPAD, Z) or not fs.is_contiguous():
            raise ValueError(f"fs must be a contiguous [{X}, {Y}, {QPAD}, {Z}] tensor, "
                             f"got {tuple(fs.shape)}")
        if fs.dtype != self.cfg.compute_dtype:
            raise ValueError(f"fs is {fs.dtype}, the step computes in {self.cfg.compute_dtype}")

    def __call__(self, fs, nu, u_in=None, force=None, parity: int = 0, map_arr_in=None):
        del parity
        self._check(fs)
        m = self._map(fs, map_arr_in)
        if fs.device.type == "cuda":
            return self._launch(fs, float(nu), _force3(force), _u_in3(u_in), m)
        self.plain_calls += 1
        return self._plain(fs, nu, u_in, force, m)

    def plain(self, fs, nu, u_in=None, force=None, parity: int = 0, map_arr_in=None):
        """The step's plain PyTorch version on fs's device: ``from_sitemajor``,
        B4's plain step, ``to_sitemajor``; fs untouched, no call counted."""
        del parity
        self._check(fs)
        return self._plain(fs, nu, u_in, force, self._map(fs, map_arr_in))

    def _plain(self, fs, nu, u_in, force, m):
        f = from_sitemajor(fs, self.lat.Q)
        fpad = stream.pad_halo(f, self.periodic)
        S = tuple(f.shape[1:])

        def shifted(q, offs):
            return stream._shift_slices(fpad[q], offs, S)

        f_new, rho, u = _stream_bc_collide(self.lat, self.cfg, self.codes, self.do_coll_codes,
                                           shifted, m.to(fs.device), nu, _force3(force),
                                           u_in=_u_in3(u_in))
        fs_new = to_sitemajor(f_new)
        return (fs_new, rho, u) if self.with_macro else (fs_new, None, None)

    def _launch(self, fs, nu, fvec, uvec, m):
        if self.device.type != "cuda" or fs.device != self.map.device:
            raise ValueError(f"fs is on {fs.device}, the step was built for {self.device}")
        if fs.dtype != torch.float32:
            raise NotImplementedError("the CUDA kernels take float32 state only")
        X, Y, Z = self.shape
        lib = load_library()
        fs_new = torch.empty_like(fs)
        rho = u = None
        if self.with_macro:
            rho = torch.empty((X, Y, Z), dtype=fs.dtype, device=fs.device)
            u = torch.empty((3, X, Y, Z), dtype=fs.dtype, device=fs.device)
        stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(fs.device).cuda_stream)
        rc = lib.tnl_lbm_ab_step_sitemajor(fs.data_ptr(), fs_new.data_ptr(), m.data_ptr(),
                                           None if rho is None else rho.data_ptr(),
                                           None if u is None else u.data_ptr(), X, Y, Z,
                                           _periodic_bits(self.periodic), self._variant, nu,
                                           *fvec, *uvec, int(self.cfg.high_precision_rho),
                                           stream_ptr)
        if rc != 0:
            raise RuntimeError(f"{self.kernel.name} launch failed: CUDA error {rc}")
        self.kernel.launches += 1
        return fs_new, rho, u


def make_fused_step_sitemajor(cfg: LBMConfig, domain: Domain, device, with_macro: bool = True,
                              force_field: bool = False,
                              macro_only: bool = False) -> FusedStepSiteMajor:
    """A-B step on the site-major layout for (cfg, domain) on ``device``: see
    :class:`FusedStepSiteMajor`.

    The JAX function's TPU knobs (``tile``, ``tiles_per_program``) shape its
    DMA windows and have no counterpart here.  It has no ``force_field`` or
    ``macro_only`` variant, and neither has the port's (both raise).
    """
    if force_field or macro_only:
        raise NotImplementedError("the site-major A-B step (B4s) has no force_field or "
                                  "macro_only variant: the JAX make_fused_step_sitemajor has "
                                  "neither (make_fused_step has both)")
    return FusedStepSiteMajor(cfg, domain, device, with_macro=with_macro)
