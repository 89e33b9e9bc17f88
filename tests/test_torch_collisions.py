"""The rest of the D3Q27 collision set and the entropic equilibrium in the
port, held against the JAX package on the CPU.

(a) Each operator of ``COLLISIONS_D3Q27`` beyond the cumulant pair, each
of ``COLLISIONS_KBC``, the Galilean-corrected BGK forms and ``eq_entropic``
against the JAX function on ``tests/test_torch_ops.py``'s 4 x 6 x 5 inputs
with a body force, at 1e-6 in float32.  (b) The plain versions of the A-B
step (B4) and of the A-A even and odd steps (B2, B3) under each id against
the JAX ``make_step`` with a body force on a box of every code: bounds
|df| <= 1e-6, |drho| <= 2e-6, |du| <= 1e-6, and 1e-5 for KBC (the JAX
package's own KBC kernel bound, tests/test_fused_kernel.py:419-421).  An
SRT step with a force shows that the plain kernel step hands the body force
to the collision as the JAX kernel does, and each bit of KBC's variant
moves a step of the card's compare input far past the kernel's bound.
(c) KBC_N1 with ``EQ_ENTROPIC`` through the A-B step against the JAX Pallas
kernel in interpret mode.
(d) The refusals of the kernels that have no instance of these
collisions, B1 (and its variant check), B4s, B7 and B8; the kernels that
have them, B1b (and pair dispatch), the force_field instances of B4 and
B2/B3, B10 and the forcing-hook routes, build and pick the family instance.
(e) ``Simulation``'s "auto" pair dispatch stays per step for a config that
no pair kernel takes (float64) without building a pair; an explicit
``pair_dispatch=True`` raises.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.kernels.fused import make_fused_step as j_make_fused_step
from tnl_lbm_tpu.models import D3Q27
from tnl_lbm_tpu.ops import collision as jcol
from tnl_lbm_tpu.ops import collision_kbc as jkbc
from tnl_lbm_tpu.ops import equilibrium as jeq
from tnl_lbm_tpu.ops import moments as jmom
from tnl_lbm_tpu.sim import Domain as JDomain
from tnl_lbm_tpu.sim import LBMConfig as JConfig
from tnl_lbm_tpu.sim import make_step as j_make_step
from tnl_lbm_tpu.utils import Lattice as JLattice
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.kernels import fused as pfused
from tnl_lbm_tpu_torch.kernels.fused import (
    COLLISION_INSTANCES,
    make_fused_step,
    make_fused_step_sitemajor,
    step_instance,
)
from tnl_lbm_tpu_torch.kernels.fused_aa import (
    dispatch_pair_kind,
    make_dispatch_pair,
    make_fused_pair2_aa,
    make_fused_pair_aa,
    make_fused_step_aa,
)
from tnl_lbm_tpu_torch.kernels.fused_coupled import (
    make_fused_coupled_step,
    make_fused_coupled_step_aa,
)
from tnl_lbm_tpu_torch.kernels.fused_nn_step import make_fused_nn_step
from tnl_lbm_tpu_torch.kernels.hooked import make_hooked_fused_step
from tnl_lbm_tpu_torch.models import D3Q7
from tnl_lbm_tpu_torch.ops import collision as pcol
from tnl_lbm_tpu_torch.ops import collision_kbc as pkbc
from tnl_lbm_tpu_torch.ops import equilibrium as peq
from tnl_lbm_tpu_torch.ops import moments as pmom
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.ops.non_newtonian import CarreauYasuda, make_nn_forcing_hook
from tnl_lbm_tpu_torch.sim.state import Simulation

from test_torch_ops import both, close, macro
from torch_cases import (
    COLLISION_CASES,
    COLLISION_IDS,
    KERNEL_TOL_F,
    U_IN,
    aa_box,
    bc_box,
    channel,
    collision_spec,
    collision_state,
    collision_tol_f,
    nn_case,
)

FORCE = np.array([1e-5, -2e-6, 3e-6], np.float32)


def jax_op(cid):
    return {**jcol.COLLISIONS_D3Q27, **jkbc.COLLISIONS_KBC}[cid]


def port_op(cid):
    return {**pcol.COLLISIONS_D3Q27, **pkbc.COLLISIONS_KBC}[cid]


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------- (a) ops

def test_eq_entropic_matches_jax(one_torch_thread):
    rho, u = macro(21)
    jr, pr = both(rho)
    ju, pu = both(u)
    close(jeq.eq_entropic(D3Q27, jr, ju), peq.eq_entropic(D3Q27, pr, pu))
    assert peq.EQUILIBRIA["EQ_ENTROPIC"] is peq.eq_entropic


OPS = [(cid, {}) for cid in COLLISION_IDS] + [("BGK", {"galilean": True}),
                                        ("BGK_WELL", {"galilean": True})]


@pytest.mark.parametrize("cid,kw", OPS, ids=[c + ("_galilean" if k else "") for c, k in OPS])
def test_collision_matches_jax(cid, kw, one_torch_thread):
    """The operator on DFs off its natural equilibrium, with the moments
    and a body force as the kernels hand them over."""
    eq, well = collision_spec(cid)["eq"], collision_spec(cid)["well"]
    rho, u = macro(23)
    rng = np.random.default_rng(24)
    f = np.asarray(jeq.EQUILIBRIA[eq](D3Q27, jnp.asarray(rho), jnp.asarray(u)), np.float32)
    f = f + (1e-4 * rng.standard_normal(f.shape)).astype(np.float32)
    jf, pf = both(f)
    jF, pF = both(FORCE.reshape(3, 1, 1, 1))
    jrho, ju = jmom.density_velocity(D3Q27, jf, force=jF, well=well)
    prho, pu = pmom.density_velocity(D3Q27, pf, force=pF, well=well)
    jfn, pfn = jax_op(cid), port_op(cid)
    if kw:
        jfn = getattr(jcol, "collide_bgk_well" if cid == "BGK_WELL" else "collide_bgk")
        pfn = getattr(pcol, "collide_bgk_well" if cid == "BGK_WELL" else "collide_bgk")
    out_j = jfn(D3Q27, jf, jrho, ju, 0.02, force=jF, **kw)
    out_p = pfn(D3Q27, pf, prho, pu, 0.02, force=pF, **kw)
    close(out_j, out_p)
    assert np.abs(np.asarray(out_j) - f).max() > 1e-6  # the operator moved the state


def test_registries_hold_every_jax_id():
    assert set(pcol.COLLISIONS_D3Q27) == set(jcol.COLLISIONS_D3Q27)
    assert set(pkbc.COLLISIONS_KBC) == set(jkbc.COLLISIONS_KBC)
    assert set(peq.EQUILIBRIA) == set(jeq.EQUILIBRIA)


# ----------------------------------------------------- (b) the plain kernel steps

NU = 0.02
STEP_FORCE = (1e-5, -2e-6, 3e-6)
BOX = (8, 10, 12)
BOUNDS = {"f": 1e-6, "rho": 2e-6, "u": 1e-6}
spec = collision_spec


def jax_side(s, m, periodic):
    cfg = JConfig(lat=D3Q27, collision={**jcol.COLLISIONS_D3Q27, **jkbc.COLLISIONS_KBC}[
        s["collision_id"]], eq=jeq.EQUILIBRIA[s["eq"]], well=s["well"],
        streaming=s["streaming"], compute_dtype=jnp.float32)
    dom = JDomain(lat=D3Q27, units=JLattice(m.shape, (0, 0, 0), 1.0, 1.0), map=m.copy(),
                  periodic=periodic)
    return cfg, dom


def start(jcfg, shape, seed=31):
    """Seeded DFs off the config's equilibrium."""
    rng = np.random.default_rng(seed)
    rho = (1 + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    u = (0.02 * rng.standard_normal((3,) + shape)).astype(np.float32)
    f = np.asarray(jcfg.eq(D3Q27, jnp.asarray(rho), jnp.asarray(u)), np.float32)
    return f + (1e-4 * rng.standard_normal(f.shape)).astype(np.float32)


def within(ref, got, cid, label):
    tol = {k: max(v, collision_tol_f(cid)) for k, v in BOUNDS.items()}
    d = {n: float(np.abs(np.asarray(a, np.float64) - b.double().numpy()).max())
         for n, a, b in zip(("f", "rho", "u"), ref, got)}
    assert all(d[k] <= tol[k] for k in d), (cid, label, d)


@pytest.mark.parametrize("cid,eq", COLLISION_CASES, ids=[c + (f"-{e}" if e else "")
                                                         for c, e in COLLISION_CASES])
def test_plain_kernel_steps_match_jax_make_step(cid, eq, one_torch_thread):
    """B4's plain version for one step on a box of every 3D code, then B2's
    and B3's (even, then odd) on a box of every A-A code, each against the
    JAX make_step with a body force and an inflow velocity."""
    periodic = (False, False, True)
    for streaming, m in (("AB", bc_box(BOX)), ("AA", aa_box(BOX))):
        s = spec(cid, streaming, eq)
        jcfg, jdom = jax_side(s, m, periodic)
        cfg, dom = interop.config_from_spec(**s), interop.domain_from_numpy(m, periodic)
        jstep = j_make_step(jcfg, jdom)
        f0 = start(jcfg, m.shape)
        fj, fp = jnp.asarray(f0), torch.from_numpy(f0.copy())
        if streaming == "AB":
            step = make_fused_step(cfg, dom, "cpu")
            ref = jstep(fj, NU, u_in=jnp.asarray(U_IN), force=jnp.asarray(STEP_FORCE))
            within(ref, step(fp, NU, u_in=U_IN, force=STEP_FORCE), cid, "A-B")
            assert step.plain_calls == 1 and step.kernel.launches == 0
            continue
        step = make_fused_step_aa(cfg, dom, "cpu")
        for parity in (0, 1):
            ref = jstep(fj, NU, u_in=jnp.asarray(U_IN), force=jnp.asarray(STEP_FORCE),
                        parity=parity)
            got = step(fp, NU, u_in=U_IN, force=STEP_FORCE, parity=parity)
            within(ref, got, cid, ("even", "odd")[parity])
            fj, fp = ref[0], got[0]
        assert step.plain_calls == 2 and step.even.launches == step.odd.launches == 0
        assert float(np.abs(fp.numpy() - f0).max()) > 1e-5


def test_plain_step_passes_the_body_force_to_the_collision(monkeypatch, one_torch_thread):
    """SRT with a force: the plain A-B step equals the JAX step, which hands
    the body force to the collision (JAX fused.py:351-355); with the force
    withheld from the collision, as before, it would not."""
    m, periodic = bc_box(BOX), (False, False, True)
    force = (1e-3, 5e-4, 0.0)
    s = spec("SRT", "AB")
    jcfg, jdom = jax_side(s, m, periodic)
    f0 = start(jcfg, m.shape)
    ref = j_make_step(jcfg, jdom)(jnp.asarray(f0), NU, u_in=jnp.asarray(U_IN),
                                  force=jnp.asarray(force))
    step = make_fused_step(interop.config_from_spec(**s), interop.domain_from_numpy(m, periodic),
                           "cpu")
    within(ref, step(torch.from_numpy(f0.copy()), NU, u_in=U_IN, force=force), "SRT", "force")
    monkeypatch.setattr(pfused, "_force_array", lambda force, like: None)
    withheld = step(torch.from_numpy(f0.copy()), NU, u_in=U_IN, force=force)[0]
    assert float(np.abs(np.asarray(ref[0]) - withheld.numpy()).max()) > 10 * BOUNDS["f"]


#: the pairs of KBC variants that differ in one bit of CollParams::kbc
KBC_BITS = {"trace": ("KBC_N1", "KBC_N2"), "heat_flux": ("KBC_N1", "KBC_N3"),
            "central": ("KBC_N3", "KBC_C3"), "central_with_trace": ("KBC_N4", "KBC_C4")}


@pytest.mark.parametrize("bit", KBC_BITS)
def test_kbc_bits_move_the_card_compare_step(bit, one_torch_thread):
    """On the input of the card's compare (``collision_state`` on the
    24 x 20 x 150 box of every code), flipping one bit of KBC's variant
    moves the plain A-B step by more than 100 times the kernel's bound
    (KERNEL_TOL_F) at the FLUID sites alone: a KBC instance that read a bit
    wrongly fails the compare."""
    shape = (24, 20, 150)
    m = bc_box(shape)
    dom = interop.domain_from_numpy(m, (False, False, True))
    out = []
    for cid in KBC_BITS[bit]:
        cfg = interop.config_from_spec(**spec(cid, "AB"))
        step = make_fused_step(cfg, dom, "cpu")
        out.append(step.plain(collision_state(cfg, shape, "cpu"), NU, u_in=U_IN,
                              force=STEP_FORCE)[0])
    fluid = torch.from_numpy(m == GEO.FLUID)
    assert float((out[0] - out[1]).abs()[:, fluid].max()) > 100 * KERNEL_TOL_F


# ------------------------------------------------- (c) the JAX Pallas kernel

def test_kbc_entropic_ab_step_matches_jax_pallas_interpret(one_torch_thread):
    """KBC_N1 with the entropic equilibrium through the A-B step's plain
    version against the JAX Pallas kernel in interpret mode, as
    tests/test_torch_ab_pallas.py runs it, on the box of every 3D code."""
    m, periodic = channel("box")
    s = spec("KBC_N1", "AB", "EQ_ENTROPIC")
    jcfg, jdom = jax_side(s, m, periodic)
    step = make_fused_step(interop.config_from_spec(**s), interop.domain_from_numpy(m, periodic),
                           "cpu")
    f0 = start(jcfg, m.shape)
    ref = j_make_fused_step(jcfg, jdom)(jnp.asarray(f0), NU, u_in=jnp.asarray(U_IN, jnp.float32),
                                        force=jnp.asarray(STEP_FORCE, jnp.float32))
    within(ref, step(torch.from_numpy(f0), NU, u_in=U_IN, force=STEP_FORCE), "KBC_N1", "pallas")
    assert step_instance(step.cfg) == ("tnl_lbm_coll_kbc", 0, 3, 0)


# ---------------------------------------------------------------- (d) refusals

def duct():
    m = np.zeros((8, 16, 8), np.uint8)
    m[:, 0] = m[:, -1] = m[:, :, 0] = m[:, :, -1] = 1  # GEO.WALL
    return m, (True, False, False)


def test_pair_b1_takes_its_one_instance_only():
    """B1 refuses, on the CPU, a config it has no instance of: a CUM_WELL
    config whose well flag or equilibrium its kernel does not compute, which
    pair dispatch refuses too (no kernel has one), and another collision,
    which pair dispatch hands to B1b on B1's own map; its one instance
    builds."""
    m, periodic = duct()
    dom = interop.domain_from_numpy(m, periodic)
    for bad in (("CUM_WELL", "EQ", False), ("CUM_WELL", "EQ_INV_CUM", False),
                ("SRT_WELL", "EQ_WELL", True)):
        cfg = interop.config_from_spec(*bad, "AA")
        with pytest.raises(NotImplementedError, match="B1"):
            make_fused_pair2_aa(cfg, dom, "cpu")
        if bad[0] == "SRT_WELL":
            assert dispatch_pair_kind(cfg, dom) == "B1b"
            assert type(make_dispatch_pair(cfg, dom, "cpu")).__name__ == "FusedPairAAFull"
            continue
        with pytest.raises(NotImplementedError, match=r"\(B1b\) has no instance"):
            make_dispatch_pair(cfg, dom, "cpu")
    good = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AA")
    assert dispatch_pair_kind(good, dom) == "B1"
    assert type(make_dispatch_pair(good, dom, "cpu")).__name__ == "FusedPairAA"
    cum = interop.config_from_spec("CUM", "EQ", False, "AA")
    assert dispatch_pair_kind(cum, dom) == "B1b"


def _other_kernels(cid):
    """name -> a function that builds each kernel without an instance of ``cid``."""
    m, periodic = bc_box(BOX), (False, False, True)
    ab, aa = (interop.config_from_spec(**spec(cid, st)) for st in ("AB", "AA"))
    dom_ab = interop.domain_from_numpy(m, periodic)
    dom_aa = interop.domain_from_numpy(aa_box(BOX), periodic)
    acfg_ab, acfg_aa = (interop.ade_config_from_spec("CLBM", st) for st in ("AB", "AA"))
    adom = interop.domain_from_numpy(np.zeros(BOX, np.uint8), periodic, lat=D3Q7)
    nm, nper, _, hper = nn_case("duct", (8, 16, 8))
    model = CarreauYasuda(0.1, 1.0, 2.0, 0.5)
    hooked = dataclasses.replace(interop.config_from_spec(**spec(cid, "AB")),
                                 forcing_hook=make_nn_forcing_hook(model, periodic=hper))
    dom_nn = interop.domain_from_numpy(nm, nper)
    return {
        "B1": lambda: make_fused_pair2_aa(aa, interop.domain_from_numpy(*duct()), "cpu"),
        "B1b": lambda: make_fused_pair_aa(aa, dom_aa, "cpu"),
        "B1b dispatch": lambda: make_dispatch_pair(aa, dom_aa, "cpu"),
        "B4s": lambda: make_fused_step_sitemajor(ab, dom_ab, "cpu"),
        "B4 force_field": lambda: make_fused_step(ab, dom_ab, "cpu", force_field=True),
        "B2/B3 force_field": lambda: make_fused_step_aa(aa, dom_aa, "cpu", force_field=True),
        "B7": lambda: make_fused_coupled_step(ab, dom_ab, acfg_ab, adom, "cpu"),
        "B8": lambda: make_fused_coupled_step_aa(aa, dom_aa, acfg_aa, adom, "cpu"),
        "B10": lambda: make_fused_nn_step(hooked, dom_nn, model, hper, "cpu"),
        "hooked": lambda: make_hooked_fused_step(hooked, dom_nn, "cpu"),
    }


REFUSING = ("B1", "B4s", "B7", "B8")
TAKING = ("B1b", "B1b dispatch", "B4 force_field", "B2/B3 force_field", "B10", "hooked")


@pytest.mark.parametrize("kernel", REFUSING)
@pytest.mark.parametrize("cid", ("SRT", "CLBM_WELL", "KBC_C4"))
def test_kernels_without_the_instance_refuse_on_any_device(kernel, cid):
    """Each kernel that has no instance of a new collision refuses it on
    the CPU, naming ROADMAP Bcol; the per-step kernels (B4, B2, B3) and the
    u* pass (macro_only, which does not collide) take it."""
    with pytest.raises(NotImplementedError, match="Bcol"):
        _other_kernels(cid)[kernel]()
    m, periodic = bc_box(BOX), (False, False, True)
    ab = interop.config_from_spec(**spec(cid, "AB"))
    make_fused_step(ab, interop.domain_from_numpy(m, periodic), "cpu", macro_only=True)
    assert cid in COLLISION_INSTANCES and step_instance(ab)[0].startswith("tnl_lbm_coll_")


def _instances(built):
    """The family instances a built kernel wrapper (or hooked step) picked."""
    if hasattr(built, "kernels"):  # a hooked step: its routes' wrappers
        return [i for k in built.kernels for i in _instances(k)]
    inst = getattr(built, "_instance", None)
    return [] if inst is None or inst[0] == "cum" else [inst]


@pytest.mark.parametrize("kernel", TAKING)
@pytest.mark.parametrize("cid", ("SRT", "CLBM_WELL", "KBC_C4"))
def test_kernels_with_the_instance_build_and_pick_the_family_instance(kernel, cid):
    """Each kernel that has the family instances builds on the CPU for a new
    collision and picks its row: the per-step kernels' (entry, collision
    index, equilibrium code, KBC bits), under the kernel's own entry."""
    built = _other_kernels(cid)[kernel]()
    want = step_instance(interop.config_from_spec(**spec(cid, "AB")))
    got = _instances(built)
    assert got and all(i == want for i in got), (got, want)
    if kernel == "hooked":
        assert built.route == "single_kernel" and built.nn_single._variant is None
    if kernel.startswith("B1b"):
        assert type(built).__name__ == "FusedPairAAFull" and built.variant == cid
        assert pfused.family_entry(want, "pair") == want[0].replace("_coll_", "_pair_coll_")


@pytest.mark.parametrize("bad", [("SRT", "EQ_WELL", False), ("SRT_WELL", "EQ", False),
                                 ("KBC_N1", "EQ", True), ("CUM", "EQ_WELL", False)])
def test_per_step_kernels_refuse_a_storage_the_collision_does_not_take(bad):
    """The well flag stays tied to the collision: *_WELL with well=True and
    the well equilibrium, the rest with well=False and the quadratic,
    inverse-cumulant or entropic one; CUM keeps its four instances (the
    entropic one in the family sources), none on the well equilibrium
    without well=True."""
    with pytest.raises(NotImplementedError):
        step_instance(interop.config_from_spec(*bad, "AB"))


# -------------------------------------------------------- (e) "auto" per step

class Duct(Simulation):
    def body_force(self, phys_time):
        return np.array([1e-6, 0.0, 0.0])


def test_auto_pair_dispatch_stays_per_step_without_a_pair_instance(tmp_path, monkeypatch):
    """With no pair kernel having the config's instance (SRT_WELL computed
    in float64: the pairs compute in float32), "auto" keeps per-step
    dispatch from the config alone: it neither builds a pair nor times one
    (the device type is set to "cuda" so that the probe's branch is reached
    on the CPU).  An explicit ``pair_dispatch=True`` raises.  In float32 the
    full-set pair (B1b) has the instance."""
    m, periodic = duct()
    dom = interop.domain_from_numpy(m, periodic, phys_viscosity=NU)
    cfg = interop.config_from_spec(**spec("SRT_WELL", "AA"), dtype="float64")

    def build(pair_dispatch, tag):
        return Duct(cfg, dom, device="cpu", sim_id=tag, results_parent=tmp_path,
                    phys_final_time=1.0, use_fused=True, pair_dispatch=pair_dispatch)

    sim = build("auto", "auto")
    monkeypatch.setattr(sim, "time_pair_routes", lambda *a, **k: pytest.fail("timed a pair"))
    monkeypatch.setattr(sim, "_build_pair", lambda: pytest.fail("built a pair"))
    sim.device = torch.device("cuda")
    assert sim._pair_dispatch_capable() and not sim._pair_has_instance()
    sim._resolve_pair_dispatch()
    assert sim.pair_dispatch is False and sim._pair is None
    with pytest.raises(NotImplementedError, match="float32 only"):
        build(True, "explicit").sim_init()
    for tag, spec32 in (("cum_well", ("CUM_WELL", "EQ_WELL", True, "AA")),
                        ("srt_well", ("SRT_WELL", "EQ_WELL", True, "AA"))):
        sim32 = Duct(interop.config_from_spec(*spec32), dom, device="cpu", sim_id=tag,
                     results_parent=tmp_path, phys_final_time=1.0, use_fused=True)
        assert sim32._pair_has_instance()
