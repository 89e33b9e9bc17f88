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
kernel's place; with ``prepadded=True`` it is the sharded step's B4 on a
shard's haloed block (``csrc/halo_step.cu``).  :class:`FusedStepSiteMajor`
is the same step on the site-major layout [X, Y, QPAD, Z]
(``csrc/ab_step_sitemajor.cu``).
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
from tnl_lbm_tpu_torch.ops.collision_kbc import COLLISIONS_KBC
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
#: GEO codes the one-kernel A-A pair (B1) handles; pair dispatch runs the full-set
#: pair (B1b) on the other A-A maps (kernels/fused_aa.py make_dispatch_pair)
PAIR_CODES = frozenset({GEO.FLUID, GEO.WALL, GEO.NOTHING})

#: the cumulant instances of ``tnl_lbm_ab_step`` / ``tnl_lbm_aa_even`` /
#: ``tnl_lbm_aa_odd`` (and of B1b's and B10's cumulant sources), their C
#: ``variant`` per (collision id, well, equilibrium kind).  B4s, B7 and B8 have
#: these only.
CUM_VARIANTS = {("CUM_WELL", True, "well"): 0, ("CUM", False, "quad"): 1,
                ("CUM", False, "invcum"): 2}
#: the A-A kernels' variant for CUM_WELL on a map of PAIR_CODES: the odd step's lean
#: instance without the boundary switch (the even step runs its CUM_WELL instance)
_AA_LEAN_VARIANT = 3
#: the one instance of the one-kernel A-A pair (B1)
PAIR_VARIANT = ("CUM_WELL", True, "well")

#: the other collisions of the per-step kernels (B4, B2, B3, the step and its
#: force_field mode), in the sources of their families (``csrc/coll_srt.cu``,
#: ``coll_clbm.cu``, ``coll_kbc.cu``): id -> (C entry, collision index within it,
#: KBC variant bits: 1 the trace, 2 the heat flux, 4 its central moments).  The
#: one-kernel NN step (B10, ``csrc/nn_coll_*.cu``) and the full-set pair (B1b,
#: ``csrc/pair_coll_*.cu``) have the same rows under their own entries
#: (``family_entry``).
COLLISION_INSTANCES = {
    "SRT": ("tnl_lbm_coll_srt", 0, 0), "SRT_MODIF_FORCE": ("tnl_lbm_coll_srt", 1, 0),
    "SRT_WELL": ("tnl_lbm_coll_srt", 2, 0), "BGK": ("tnl_lbm_coll_srt", 3, 0),
    "BGK_WELL": ("tnl_lbm_coll_srt", 4, 0), "MRT_LES": ("tnl_lbm_coll_clbm", 0, 0),
    "CLBM": ("tnl_lbm_coll_clbm", 1, 0), "CLBM_WELL": ("tnl_lbm_coll_clbm", 2, 0),
    **{f"KBC_{k}{n}": ("tnl_lbm_coll_kbc", 0, (n in (2, 4)) | 2 * (n in (3, 4)) | 4 * (k == "C"))
       for k in "NC" for n in (1, 2, 3, 4)},
}
#: CUM with eq_entropic, which only the family sources have: the cumulant
#: cascade on total DFs with the equilibrium kind read at run time, row 3 of
#: the moment-space family (``csrc/coll_clbm.cu`` ``Cum<false>``)
CUM_ENTROPIC = ("CUM", False, "entropic")
CUM_ENTROPIC_INSTANCE = ("tnl_lbm_coll_clbm", 3, 0)
#: the collisions on deviation (well-conditioned) DFs
WELL_COLLISIONS = frozenset({"CUM_WELL", "SRT_WELL", "BGK_WELL", "CLBM_WELL"})
#: the C code of each equilibrium kind (``csrc/lbm_site.cuh`` EQ_*); the family
#: instances take it at run time: the well kind under the *_WELL collisions,
#: else quad, invcum or entropic
EQ_CODES = {"quad": 0, "well": 1, "invcum": 2, "entropic": 3}
#: the ROADMAP entry a kernel without an instance of a config names
OTHER_KERNELS_ROADMAP = "ROADMAP Bcol"
#: the float64 instances: the per-step kernels' (B4, B2, B3) CUM_WELL step
#: (``csrc/f64_ab.cu``, ``f64_aa.cu``) and the pair's (B1, ``f64_pair.cu``);
#: the ROADMAP entry of the float64 instances still to port, and of 16-bit
#: storage under float64 compute
F64_INSTANCE = ("cum", CUM_VARIANTS[("CUM_WELL", True, "well")])
F64_ROADMAP = "ROADMAP Bf64"
HALF_F64_ROADMAP = "ROADMAP Bh64"
#: the ROADMAP entry of the per-site inflow profiles the kernels do not take:
#: B4 takes one in its CUM_WELL step (the profile instances), the rest not yet
PROFILE_ROADMAP = "ROADMAP Bprof"
#: the ROADMAP entry of the sharded lattice's parts still to port
SHARDED_ROADMAP = "ROADMAP A13b"
#: the cumulant variants with haloed instances (csrc/halo_step.cu): the A-B
#: step's three, the A-A odd step's three and its lean one; in float64 the
#: A-B step's CUM_WELL one (csrc/f64_ab.cu)
HALO_AB_VARIANTS = frozenset({0, 1, 2})
HALO_ODD_VARIANTS = frozenset({0, 1, 2, _AA_LEAN_VARIANT})


@dataclasses.dataclass
class CudaKernel:
    """One hand-written kernel: its name, where it lives, which Pallas
    kernel it replaces, and how often its wrapper launched it."""

    name: str
    source: str
    replaces: str
    launches: int = 0


def kernel_counters(*wrappers) -> list:
    """The CudaKernel records of kernel wrappers: their ``kernel``/``ab``/
    ``even``/``odd`` attributes, and those of a hooked step's ``kernels``."""
    out = []
    for w in wrappers:
        if w is None:
            continue
        out += [v for v in vars(w).values() if isinstance(v, CudaKernel)]
        for sub in getattr(w, "kernels", None) or ():
            out += kernel_counters(sub)
    return out


def check_out(out, f) -> None:
    """``out`` (None, or the buffer a step writes its state into) must be a
    second contiguous buffer like ``f``."""
    if out is not None and (out is f or out.shape != f.shape or out.dtype != f.dtype
                            or out.device != f.device or not out.is_contiguous()):
        raise ValueError("out must be a second contiguous state buffer like f")


def macro_buffers(macro_out, shape, D: int, dtype, device):
    """(rho, u) for a launch to write: the caller's pair (``macro_out``,
    checked: contiguous [*S] and [D, *S] of ``dtype`` on ``device``), or two
    new tensors.  Fixed buffers let a replayed CUDA graph write the same
    addresses on every step."""
    shape = tuple(shape)
    if macro_out is None:
        return (torch.empty(shape, dtype=dtype, device=device),
                torch.empty((D,) + shape, dtype=dtype, device=device))
    rho, u = macro_out
    for t, want in ((rho, shape), (u, (D,) + shape)):
        if (tuple(t.shape) != want or t.dtype != dtype or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"macro_out must hold contiguous {dtype} tensors of {want} on "
                             f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    return rho, u


def into(macro_out, rho, u):
    """The plain path's (rho, u), copied into ``macro_out`` when given."""
    if macro_out is None:
        return rho, u
    macro_buffers(macro_out, rho.shape, u.shape[0], rho.dtype, rho.device)
    return macro_out[0].copy_(rho), macro_out[1].copy_(u)


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


#: numpy's type of each compute dtype the kernels take
NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def host_vector3(value, what: str, roadmap: str,
                 dtype=torch.float32) -> tuple[float, float, float]:
    """A homogeneous [3] input (u_in, force) as three Python floats rounded
    to the compute ``dtype`` (float32, or float64, which keeps a double
    input as given); None is zero.  A CUDA tensor is refused rather than
    read back to the host once per step; a per-site field raises naming
    ``roadmap``."""
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
    return tuple(float(v) for v in arr.astype(NP_DTYPES.get(dtype, np.float32)))


def _force3(force, dtype=torch.float32) -> tuple[float, float, float]:
    return host_vector3(force, "force", "the force_field variants take one", dtype)


def _u_in3(u_in, dtype=torch.float32) -> tuple[float, float, float]:
    return host_vector3(u_in, "inflow velocity",
                        f"per-site inflow profiles: the A-B step's CUM_WELL instance takes "
                        f"one; {PROFILE_ROADMAP}", dtype)


def inflow_profile(u_in, shape, device, dtype) -> torch.Tensor:
    """A per-site inflow profile (a tensor or host array [3, ...] that
    broadcasts to [3, X, Y, Z], sim_2's [3, 1, Y, Z]) as a [3, X, Y, Z] view
    on ``device`` in ``dtype``: zero strides on its broadcast axes, so the
    kernel reads it in place.  A host profile is copied to ``device`` (the
    driver caches its copies, ``Simulation._device_input``); one on another
    device raises."""
    if not torch.is_tensor(u_in):
        u_in = torch.as_tensor(np.asarray(u_in), device=device)
    elif u_in.device.type == "cpu" and torch.device(device).type != "cpu":
        u_in = u_in.to(device)
    elif u_in.device != torch.device(device):
        raise ValueError(f"the inflow profile is on {u_in.device}, f on {device}")
    prof = u_in.to(dtype)
    if prof.dim() > 4 or prof.shape[0] != 3:
        raise ValueError(f"an inflow profile is [3, ...] broadcasting to [3, {shape}], "
                         f"got {tuple(prof.shape)}")
    prof = prof.reshape((3,) + (1,) * (4 - prof.dim()) + tuple(prof.shape[1:]))
    return prof.expand((3,) + tuple(shape))


def _periodic_bits(periodic) -> int:
    return sum(1 << a for a, p in enumerate(periodic) if p)


def _eq_kind(cfg: LBMConfig) -> str:
    """The in-kernel equilibrium of a config (JAX fused.py:144)."""
    if cfg.eq is eqlib.eq_inv_cum:
        return "invcum"
    if cfg.eq is eqlib.eq_entropic:
        return "entropic"
    if cfg.eq is eqlib.eq_well or cfg.well:
        return "well"
    if cfg.eq is eqlib.eq_quadratic:
        return "quad"
    raise NotImplementedError(f"equilibrium {getattr(cfg.eq, '__name__', cfg.eq)} is not one the "
                              f"kernels compute (eq_quadratic, eq_well, eq_inv_cum, eq_entropic)")


#: the registry id of each collision operator (its default equilibrium makes the
#: bare ``collide_srt`` SRT too)
_COLLISION_IDS = {**{fn: cid for cid, fn in {**col.COLLISIONS_D3Q27, **COLLISIONS_KBC}.items()},
                  col.collide_srt: "SRT"}


def collision_id(cfg: LBMConfig) -> str | None:
    """The registry id of cfg's collision (``ops/collision.py COLLISIONS_D3Q27``,
    ``ops/collision_kbc.py COLLISIONS_KBC``), or None for another operator."""
    return _COLLISION_IDS.get(cfg.collision)


def variant_key(cfg: LBMConfig) -> tuple:
    """(collision id, well, equilibrium kind) of a config: what picks a
    kernel's instance."""
    return collision_id(cfg), bool(cfg.well), _eq_kind(cfg)


def _described(cfg: LBMConfig) -> str:
    cid, well, kind = variant_key(cfg)
    name = cid or getattr(cfg.collision, "__name__", cfg.collision)
    return f"{name} with well={well}, equilibrium kind {kind!r}"


def step_instance(cfg: LBMConfig, kernel: str | None = None) -> tuple:
    """The instance of cfg's collision in the kernels that take the whole
    D3Q27 set (the A-B step B4, the A-A even/odd steps B2, B3, their
    force_field mode, the one-kernel NN step B10, the full-set pair B1b):
    ``("cum", variant)`` for the cumulant instances of ``CUM_VARIANTS``, or
    ``(C entry, collision index, equilibrium code, KBC bits)`` for a family
    row: a collision of ``COLLISION_INSTANCES``, or CUM with eq_entropic
    (``CUM_ENTROPIC_INSTANCE``).  The entry is the per-step kernels'
    (``family_entry`` gives B10's and B1b's).  A check of the config alone,
    on any device; the rest raises, naming ``kernel`` (by default the
    per-step kernels of cfg's streaming)."""
    key = variant_key(cfg)
    if key in CUM_VARIANTS:
        return "cum", CUM_VARIANTS[key]
    if key == CUM_ENTROPIC:
        entry, index, kbc = CUM_ENTROPIC_INSTANCE
        return entry, index, EQ_CODES["entropic"], kbc
    cid, well, kind = key
    kernel = kernel or ("the A-A even/odd kernel (B2, B3)" if cfg.streaming == "AA"
                        else "the A-B kernel (B4)")
    missing = f"{kernel} has no instance of {_described(cfg)}"
    if cid not in COLLISION_INSTANCES:
        raise NotImplementedError(
            f"{missing}: the D3Q27 kernels take CUM_WELL with well=True, CUM with "
            f"eq_quadratic, eq_inv_cum or eq_entropic and well=False, and the collisions "
            f"{sorted(COLLISION_INSTANCES)}")
    wants_well = cid in WELL_COLLISIONS
    if well != wants_well or (kind == "well") != wants_well:
        raise NotImplementedError(
            f"{missing}: {cid} runs with "
            + ("well=True and the well-conditioned equilibrium" if wants_well else
               "well=False and eq_quadratic, eq_inv_cum or eq_entropic"))
    entry, index, kbc = COLLISION_INSTANCES[cid]
    return entry, index, EQ_CODES[kind], kbc


def family_entry(instance: tuple, kernel: str) -> str:
    """The C entry of a family instance (``step_instance``, whose entry is
    the per-step kernels' ``tnl_lbm_coll_<family>``) in ``kernel``'s sources:
    "nn" (B10, ``tnl_lbm_nn_coll_<family>``) or "pair" (B1b,
    ``tnl_lbm_pair_coll_<family>``), whose rows are in the same order."""
    return instance[0].replace("tnl_lbm_coll_", f"tnl_lbm_{kernel}_coll_")


def cum_variant(cfg: LBMConfig, kernel: str) -> int:
    """The C variant of a kernel that has the cumulant instances only
    (``CUM_VARIANTS``: B4s, B7, B8); anything else raises naming
    ``OTHER_KERNELS_ROADMAP``.  A check of the config alone, on any device."""
    key = variant_key(cfg)
    if key not in CUM_VARIANTS:
        raise NotImplementedError(
            f"{kernel} has instances of CUM_WELL with well=True and the well-conditioned "
            f"equilibrium, and of CUM with eq_quadratic or eq_inv_cum and well=False, only; "
            f"got {_described(cfg)} (the per-step kernels, their force_field mode, B10 and "
            f"B1b take the other collisions; on this kernel: {OTHER_KERNELS_ROADMAP})")
    return CUM_VARIANTS[key]


def check_pair_variant(cfg: LBMConfig) -> None:
    """Refuse, on any device, a config that the one-kernel A-A pair (B1)
    has no instance of: it has one, ``PAIR_VARIANT``."""
    if variant_key(cfg) != PAIR_VARIANT:
        raise NotImplementedError(
            f"the A-A pair kernel (B1) has one instance: CUM_WELL with well=True and the "
            f"well-conditioned equilibrium; got {_described(cfg)} (the full-set pair, "
            f"make_fused_pair_aa, takes the other collisions and equilibria; B1's one "
            f"instance: {OTHER_KERNELS_ROADMAP})")


def refuse_f64(cfg: LBMConfig, kernel: str) -> None:
    """Refuse a float64 config on a kernel without a float64 instance of it,
    naming ``F64_ROADMAP``."""
    if cfg.compute_dtype == torch.float64:
        raise NotImplementedError(
            f"{kernel} has no float64 instance of {_described(cfg)}: the float64 instances "
            f"are the CUM_WELL step of B4, B2 and B3 and the pair B1 on FLUID/WALL/NOTHING; "
            f"the others: {F64_ROADMAP}")


def check_dtype(f, cfg: LBMConfig) -> None:
    """A launch takes a state of the config's compute dtype only: a float64
    state never reaches a float32 entry, nor a float32 one a float64 entry."""
    if f.dtype != cfg.compute_dtype:
        raise NotImplementedError(f"f is {f.dtype}, the kernel was built for "
                                  f"{cfg.compute_dtype}: its instances take that state only")


def _check_kernel_config(cfg: LBMConfig, domain: Domain, device: torch.device,
                         kernel: str = "this CUDA kernel", f64: bool = False) -> None:
    """Refuse, at build time on a CUDA device, what every CUDA kernel
    refuses: no card, a compute dtype but float32 and float64, float64 where
    the kernel (``kernel``) has no float64 instance of cfg (``f64``: it has
    one), a grid too large.  Each kernel checks its instances itself."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    if cfg.compute_dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"the CUDA kernels compute in float32 or float64, not "
                                  f"{cfg.compute_dtype}")
    if not f64:
        refuse_f64(cfg, kernel)
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
    w (feq - 1)), "invcum" or "entropic" (the per-axis product forms); the
    CUDA ``eq_q``."""
    if kind == "invcum":
        return eqlib.eq_inv_cum(lat, rho, u)
    if kind == "entropic":
        return eqlib.eq_entropic(lat, rho, u)
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
            f"in the pair are ROADMAP B1 (the A-A even/odd kernels and the full-set pair, "
            f"make_fused_pair_aa, take them)")
    do_coll_codes = sorted(int(c) for c in (bc.collision_mask_codes(3) & codes))
    return lat, codes, do_coll_codes


def aa_variant(cfg: LBMConfig, codes, lean: bool = True, kernel: str = "B1b") -> int:
    """The A-A cumulant kernels' variant for (cfg, the codes present):
    ``_AA_LEAN_VARIANT`` for CUM_WELL on a map of FLUID/WALL/NOTHING when
    ``lean``, else the A-B step's variant (``cum_variant``, naming
    ``kernel`` where it raises: cfg must be one of ``CUM_VARIANTS``)."""
    variant = cum_variant(cfg, kernel)
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


def _force_array(force, like: torch.Tensor) -> torch.Tensor:
    """The body force as the 3D collision takes it: D per-site fields
    stacked, or D scalars as one [D, 1, ..., 1] tensor of ``like``'s dtype."""
    if torch.is_tensor(force[0]):
        return torch.stack(list(force))
    return torch.tensor(force, dtype=like.dtype, device=like.device).reshape(
        (len(force),) + (1,) * (like.dim() - 1))


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
    ``force`` (the D2Q9 SRT's Guo term, None without a force).  On the 3D
    lattice the collision takes the body force as the JAX kernel hands it
    over (fused.py:351-355): ``force`` as one [D, 1, 1, 1] tensor, or its
    per-site fields stacked; the cumulant cascades take it through u alone,
    the SRT and BGK families add their forcing terms.
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
    if collision_force is None and lat.D == 3:
        collision_force = _force_array(force, f_in)
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


def kernel_instance(cfg: LBMConfig, force_field: bool, macro_only: bool, kernel: str) -> tuple:
    """The instance of a per-step kernel (B4, B2, B3) for cfg and a step
    variant: ``step_instance`` for the step and its ``force_field`` mode
    (naming ``kernel`` where it raises); with ``macro_only``, which does not
    collide, the u* pass of cfg's storage (variant 0 on deviation DFs, 1 on
    total DFs).  On any device."""
    if macro_only:
        return "cum", 0 if cfg.well else 1
    return step_instance(cfg, (f"the force_field instances of {kernel}" if force_field
                               else None))


#: the ``pattern`` argument of the family sources' entries: the A-B step, the
#: A-A even step (in place), the A-A odd step
PATTERN_AB, PATTERN_EVEN, PATTERN_ODD = 0, 1, 2


def launch_collision(lib, instance, pattern: int, f, fout, m, rho, u, shape, periodic,
                     has_nothing: bool, nu: float, fvec, uvec, neumaier: int, stream_ptr,
                     field=None) -> int:
    """Launch a per-step kernel's family instance (``instance`` from
    ``step_instance``) through its family's C entry, in the force_field mode
    when ``field`` (the per-site force) is given; returns the CUDA error
    code."""
    entry, index, eq_code, kbc = instance
    X, Y, Z = shape
    return getattr(lib, entry)(pattern, int(field is not None), index, eq_code, kbc,
                               f.data_ptr(), None if fout is None else fout.data_ptr(),
                               m.data_ptr(), None if field is None else field.data_ptr(),
                               rho.data_ptr(), u.data_ptr(), X, Y, Z, _periodic_bits(periodic),
                               int(has_nothing), nu, *fvec, *uvec, neumaier, stream_ptr)


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
    """``step(f, nu, u_in=None, force=None, parity=0, out=None, macro_out=None)
    -> (f_new, rho, u)``.

    One A-B step (pull, the full 3D BC set, the config's collision: an
    instance of ``csrc/ab_step.cu`` for CUM_WELL and CUM with eq_quadratic or
    eq_inv_cum, of ``csrc/coll_*.cu`` for the other collisions and CUM with
    eq_entropic, ``step_instance``, in either variant) out of place:
    the result goes to a new tensor, or into ``out`` (a second state
    buffer, not ``f``), so a caller can ping-pong two buffers; rho and u
    go to new tensors, or into ``macro_out`` (a pair of buffers).  ``force``
    is a homogeneous [3] vector given as host values; ``u_in`` is one too,
    or, in the CUM_WELL step, a per-site inflow profile broadcastable to
    [3, X, Y, Z] (sim_2's [3, 1, Y, Z]; a tensor on f's device is read in
    place through its strides, a host one copied there at each call): the
    profile instance (``profile`` counts its launches), which the other
    instances do not have (``PROFILE_ROADMAP``).  The state computes in the
    config's dtype: float32, or float64 in the CUM_WELL step (its instances
    in ``csrc/f64_ab.cu``; the others raise on the card naming
    ``F64_ROADMAP``).  ``parity`` is accepted for the common step contract
    and ignored.  ``kernel`` counts the launches, ``plain_calls`` the
    CPU-path calls.

    Variants (JAX ``make_fused_step``'s flags), each its own kernel instance:

    - ``force_field``: ``force`` is a per-site [3, X, Y, Z] float32 tensor on
      f's device, read at each site in place of the homogeneous force; a
      [3] host vector ``force_add`` is added to it at every site (the
      hooked pipeline's body force, so that no pass sums the two);
    - ``macro_only``: the u* pre-pass - ``step(f, nu, u_in=None,
      force=None) -> (rho0, u0)``: pull, the outflow pull rules, the WALL
      swap and the symmetry mirrors, the moments with the homogeneous
      force; no collision, no f output, no inflow/outflow macro override.

    ``prepadded=True`` is the sharded step's B4 (JAX ``make_fused_step``
    with ``prepadded`` and ``local_shape``): f is a shard's block of
    ``local_shape`` (the domain's by default) with a 1-wide x/y halo,
    [Q, X+2, Y+2, Z], every x/y neighbour read taken from the halo and z
    wrapped or clamped as the domain says; each call gives the block's map
    (``map_arr_in``, uint8 [X, Y, Z] on f's device, the codes the domain
    has), and the step writes the block's f, rho and u (``kernel`` counts
    the launches of ``csrc/halo_step.cu``, in float64 of ``f64_ab.cu``).
    It has the cumulant steps' instances (CUM_WELL, also in float64; CUM
    with eq_quadratic or eq_inv_cum), with a homogeneous inflow velocity;
    the rest raises naming ``SHARDED_ROADMAP``.
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, device, force_field: bool = False,
                 macro_only: bool = False, prepadded: bool = False, local_shape=None):
        if cfg.streaming != "AB":
            raise ValueError("make_fused_step needs streaming='AB'")
        self.cfg = cfg
        self.device = torch.device(device)
        self.lat, self.codes, self.do_coll_codes = _prep(cfg, domain)
        self.prepadded = prepadded
        self.shape = tuple(local_shape) if local_shape is not None else domain.shape
        self.periodic = domain.periodic
        self.force_field, self.macro_only = force_field, macro_only
        self._mode, suffix = variant_mode(force_field, macro_only)
        self._instance = kernel_instance(cfg, force_field, macro_only, "the A-B step (B4)")
        #: the CUM_WELL step: the instance with float64 and profile instances
        self._cum_well_step = self._instance == F64_INSTANCE and self._mode == MODE_STEP
        self._f64 = cfg.compute_dtype == torch.float64
        tag, source = (("_f64", "f64_ab.cu") if self._f64 and self._cum_well_step
                       else ("", "ab_step.cu"))
        replaces = "tnl_lbm_tpu/kernels/fused.py:585"
        if prepadded:
            self._check_halo_instance()
            suffix, source = "_halo", "f64_ab.cu" if self._f64 else "halo_step.cu"
        self.kernel = CudaKernel("ab_step" + tag + suffix, "tnl_lbm_tpu_torch/csrc/" + source,
                                 replaces)
        self.profile = (CudaKernel(f"ab_step{tag}_profile", "tnl_lbm_tpu_torch/csrc/" + source,
                                   replaces) if self._cum_well_step and not prepadded else None)
        self.plain_calls = 0
        if self.device.type == "cuda":
            _check_kernel_config(cfg, domain, self.device, "the A-B step (B4)",
                                 f64=self._cum_well_step)
        self.map = (None if prepadded else
                    torch.as_tensor(np.ascontiguousarray(domain.map, np.uint8), device=self.device))

    def _check_halo_instance(self) -> None:
        """Refuse, on any device, a config the haloed step has no instance of."""
        cum = self._instance[0] == "cum" and self._instance[1] in HALO_AB_VARIANTS
        if self._mode != MODE_STEP or not cum or (self._f64 and not self._cum_well_step):
            raise NotImplementedError(
                f"the sharded A-B step (B4 on a haloed block) has the cumulant steps' instances "
                f"(CUM_WELL, also in float64; CUM with eq_quadratic or eq_inv_cum), not "
                f"{_described(self.cfg)} in {self.cfg.compute_dtype}"
                + (" or the force_field / macro_only variants" if self._mode != MODE_STEP
                   else "") + f" ({SHARDED_ROADMAP})")

    def _block_map(self, f, map_arr_in):
        """The haloed step's map of this call: a uint8 [X, Y, Z] on f's device."""
        m = map_arr_in
        if (not torch.is_tensor(m) or m.dtype != torch.uint8 or m.device != f.device
                or tuple(m.shape) != self.shape or not m.is_contiguous()):
            raise ValueError(f"the haloed step takes the block's map at each call (map_arr_in): "
                             f"a contiguous uint8 {list(self.shape)} tensor on {f.device}")
        return m

    def _check_halo(self, f, out) -> None:
        X, Y, Z = self.shape
        want = (self.lat.Q, X + 2, Y + 2, Z)
        if tuple(f.shape) != want or not f.is_contiguous():
            raise ValueError(f"f must be a contiguous {list(want)} haloed block, "
                             f"got {tuple(f.shape)}")
        if out is not None and (tuple(out.shape) != (self.lat.Q, X, Y, Z) or out.dtype != f.dtype
                                or out.device != f.device or not out.is_contiguous()):
            raise ValueError("out must be a contiguous state block of the local shape")

    def reset_counts(self) -> None:
        self.kernel.launches = self.plain_calls = 0
        if self.profile is not None:
            self.profile.launches = 0

    def _forces(self, f, force, force_add):
        """(the per-site field or None, the homogeneous three floats)."""
        dt = self.cfg.compute_dtype
        if self.force_field:
            return check_force_field(force, 3, self.shape, f.device), _force3(force_add, dt)
        if force_add is not None:
            raise ValueError("force_add belongs to the force_field variant")
        return None, _force3(force, dt)

    def _inflow(self, u_in, device):
        """(the per-site profile as a [3, X, Y, Z] view on ``device``, or
        None; the homogeneous three floats, zero with a profile)."""
        if u_in is None or (u_in.dim() if torch.is_tensor(u_in) else np.ndim(u_in)) <= 1:
            return None, _u_in3(u_in, self.cfg.compute_dtype)
        if self.prepadded:
            raise NotImplementedError(f"the sharded A-B step takes a homogeneous inflow velocity "
                                      f"only ({SHARDED_ROADMAP}, {PROFILE_ROADMAP})")
        if not self._cum_well_step:
            raise NotImplementedError(
                f"the A-B step (B4) takes a per-site inflow profile in its CUM_WELL step only, "
                f"not in {_described(self.cfg)} or the force_field and macro_only variants "
                f"({PROFILE_ROADMAP})")
        return inflow_profile(u_in, self.shape, device, self.cfg.compute_dtype), (0.0, 0.0, 0.0)

    def __call__(self, f, nu, u_in=None, force=None, parity: int = 0, out=None,
                 force_add=None, macro_out=None, map_arr_in=None):
        del parity
        field, fvec = self._forces(f, force, force_add)
        prof, uvec = self._inflow(u_in, f.device)
        if out is not None and self.macro_only:
            raise ValueError("the u* pass writes no state")
        if self.prepadded:
            return self._halo_step(f, nu, fvec, uvec, out, macro_out,
                                   self._block_map(f, map_arr_in))
        check_out(out, f)
        if f.device.type == "cuda":
            return self._launch(f, float(nu), field, fvec, uvec, out, macro_out, prof)
        self.plain_calls += 1
        f_new, rho, u = self._plain(f, nu, fvec, uvec if prof is None else prof, field)
        rho, u = into(macro_out, rho, u)
        if self.macro_only:
            return rho, u
        if out is not None:
            f_new = out.copy_(f_new)
        return f_new, rho, u

    def plain(self, f, nu, u_in=None, force=None, parity: int = 0, force_add=None,
              map_arr_in=None):
        """The step's plain PyTorch version on f's device: (f_new, rho, u),
        or (rho0, u0) for the u* pass; f untouched (``parity`` is ignored,
        as by the step).  The CPU path, and the oracle the kernel is held
        against on the card; it counts no call."""
        del parity
        field, fvec = self._forces(f, force, force_add)
        prof, uvec = self._inflow(u_in, f.device)
        if self.prepadded:
            self._check_halo(f, None)
            return self._plain_halo(f, nu, fvec, uvec, self._block_map(f, map_arr_in))
        f_new, rho, u = self._plain(f, nu, fvec, uvec if prof is None else prof, field)
        return (rho, u) if self.macro_only else (f_new, rho, u)

    def _plain(self, f, nu, fvec, uvec, field=None):
        """The step on ``pad_halo``-pulled whole arrays (``field``: the
        force_field variant's per-site force; ``uvec``: three floats or the
        [3, X, Y, Z] profile); f untouched."""
        S = tuple(f.shape[1:])
        fpad = stream.pad_halo(f, self.periodic)

        def shifted(q, offs):
            return stream._shift_slices(fpad[q], offs, S)

        force = fvec if field is None else site_force(field, fvec)
        return _stream_bc_collide(self.lat, self.cfg, self.codes, self.do_coll_codes, shifted,
                                  self.map.to(f.device), nu, force, u_in=uvec,
                                  macro_only=self.macro_only)

    def _plain_halo(self, fpad, nu, fvec, uvec, m):
        """The haloed step in plain PyTorch: the block's pulls read the x/y
        halo and a z pad of the domain's rule; the rest is the step's."""
        X, Y, Z = self.shape
        fz = stream.pad_halo(fpad, (True, True, self.periodic[2]))[:, 1:-1, 1:-1]

        def shifted(q, offs):
            ox, oy, oz = offs
            return fz[q, 1 + ox : 1 + ox + X, 1 + oy : 1 + oy + Y, 1 + oz : 1 + oz + Z]

        return _stream_bc_collide(self.lat, self.cfg, self.codes, self.do_coll_codes, shifted,
                                  m, nu, fvec, u_in=uvec)

    def _halo_step(self, f, nu, fvec, uvec, out, macro_out, m):
        """The haloed step: its kernel on a CUDA tensor, else its plain version."""
        self._check_halo(f, out)
        if f.device.type != "cuda":
            self.plain_calls += 1
            f_new, rho, u = self._plain_halo(f, nu, fvec, uvec, m)
            rho, u = into(macro_out, rho, u)
            return (f_new if out is None else out.copy_(f_new)), rho, u
        check_dtype(f, self.cfg)
        X, Y, Z = self.shape
        lib = load_library()
        f_new = (torch.empty((self.lat.Q, X, Y, Z), dtype=f.dtype, device=f.device)
                 if out is None else out)
        rho, u = macro_buffers(macro_out, (X, Y, Z), 3, f.dtype, f.device)
        stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
        entry = lib.tnl_lbm_ab_step_f64_halo if self._f64 else lib.tnl_lbm_ab_step_halo
        variant = () if self._f64 else (self._instance[1],)
        rc = entry(f.data_ptr(), f_new.data_ptr(), m.data_ptr(), rho.data_ptr(), u.data_ptr(),
                   X, Y, Z, int(self.periodic[2]), *variant, float(nu), *fvec, *uvec,
                   int(self.cfg.high_precision_rho), stream_ptr)
        if rc != 0:
            raise RuntimeError(f"{self.kernel.name} launch failed: CUDA error {rc}")
        self.kernel.launches += 1
        return f_new, rho, u

    def _launch(self, f, nu, field, fvec, uvec, out, macro_out, prof=None):
        if self.device.type != "cuda" or f.device != self.map.device:
            raise ValueError(f"f is on {f.device}, the step was built for {self.device}")
        check_dtype(f, self.cfg)
        X, Y, Z = self.shape
        if tuple(f.shape) != (self.lat.Q, X, Y, Z) or not f.is_contiguous():
            raise ValueError(f"f must be a contiguous [{self.lat.Q}, {X}, {Y}, {Z}] tensor, "
                             f"got {tuple(f.shape)}")
        lib = load_library()
        f_new = None
        if not self.macro_only:
            f_new = torch.empty_like(f) if out is None else out
        rho, u = macro_buffers(macro_out, (X, Y, Z), 3, f.dtype, f.device)
        stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
        neumaier = int(self.cfg.high_precision_rho)
        pbits = _periodic_bits(self.periodic)
        kernel = self.kernel if prof is None else self.profile
        prof_args = (None, 0, 0, 0, 0) if prof is None else (prof.data_ptr(), *prof.stride())
        if self._f64 or prof is not None:
            # the CUM_WELL step's entries (the only float64 instance, _check_kernel_config):
            # its vector instance with prof null, else its profile instance
            entry = lib.tnl_lbm_ab_step_f64 if self._f64 else lib.tnl_lbm_ab_step_well
            rc = entry(f.data_ptr(), f_new.data_ptr(), self.map.data_ptr(), rho.data_ptr(),
                       u.data_ptr(), X, Y, Z, pbits, nu, *fvec, *uvec, *prof_args, neumaier,
                       stream_ptr)
        elif self._instance[0] == "cum":
            rc = lib.tnl_lbm_ab_step(f.data_ptr(), None if f_new is None else f_new.data_ptr(),
                                     self.map.data_ptr(),
                                     None if field is None else field.data_ptr(), rho.data_ptr(),
                                     u.data_ptr(), X, Y, Z, _periodic_bits(self.periodic),
                                     self._instance[1], self._mode, nu, *fvec, *uvec, neumaier,
                                     stream_ptr)
        else:
            rc = launch_collision(lib, self._instance, PATTERN_AB, f, f_new, self.map, rho, u,
                                  self.shape, self.periodic, False, nu, fvec, uvec, neumaier,
                                  stream_ptr, field)
        if rc != 0:
            raise RuntimeError(f"{kernel.name} launch failed: CUDA error {rc}")
        kernel.launches += 1
        return (rho, u) if self.macro_only else (f_new, rho, u)


def make_fused_step(cfg: LBMConfig, domain: Domain, device, with_macro: bool = True,
                    prepadded: bool = False, local_shape=None, force_field: bool = False,
                    macro_only: bool = False) -> FusedStepAB:
    """A-B step for (cfg, domain) on ``device``: see :class:`FusedStepAB`,
    with its ``force_field`` and ``macro_only`` variants.

    The JAX function's TPU knobs (``tile``, ``tiles_per_program``) shape
    its VMEM windows and have no counterpart here.  ``prepadded`` (with the
    block's ``local_shape``) is the sharded step's haloed block.  Not ported
    yet: ``with_macro=False``, the benchmark variant without the rho/u
    writes (ROADMAP A7).
    """
    if local_shape is not None and not prepadded:
        raise ValueError("local_shape is the haloed block's shape: it needs prepadded=True")
    if not with_macro:
        raise NotImplementedError("with_macro=False is not ported yet (ROADMAP A7)")
    return FusedStepAB(cfg, domain, device, force_field=force_field, macro_only=macro_only,
                       prepadded=prepadded, local_shape=local_shape)


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
        self._variant = cum_variant(cfg, "the site-major A-B step (B4s)")
        if self.device.type == "cuda":
            _check_kernel_config(cfg, domain, self.device, "the site-major A-B step (B4s)")
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
