"""Float64 through the kernels' plain versions on the CPU, held to the JAX package.

The float64 instances of sim_2's path - the A-B step (B4) and the A-A
even/odd steps (B2, B3) under CUM_WELL, and the pair (B1) with its state
stored in float64 - and B4's profile instance in float32 and float64: each
plain version, which the wrapper runs for CPU tensors and the card holds its
kernel to, against the JAX step on the same numpy-seeded state (the test
configuration enables JAX x64, so the JAX side computes in float64), one
step or pair at a time.  Float64 bounds: |df| <= 1e-12, |drho| <= 2e-12,
|du| <= 1e-12; float32 ones the JAX kernel suite's
(tests/test_fused_kernel.py:65-67).  The JAX side is ``make_step``, the XLA
step that the JAX suite holds its Pallas kernels to, and that the JAX
driver runs for an inflow profile; B1's plain version also against the JAX
Pallas pair in interpret mode, and ``-m slow`` B4's and B2/B3's against
their Pallas kernels (~20 s each).  Also: the two float32
roundings a float64 run must not take (``host_vector3``,
``Simulation._device_input``), the refusal of every float64 config outside
the ported instances, naming its ROADMAP item, and a float64 run's
checkpoint in both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.apps import sim_2 as jsim_2
from tnl_lbm_tpu.models import D3Q27
from tnl_lbm_tpu.ops import collision as jcol
from tnl_lbm_tpu.ops import equilibrium as jeq
from tnl_lbm_tpu.sim import Domain as JDomain
from tnl_lbm_tpu.sim import LBMConfig as JConfig
from tnl_lbm_tpu.sim import make_step as j_make_step
from tnl_lbm_tpu.utils import Lattice as JLattice
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.apps import sim_2
from tnl_lbm_tpu_torch.kernels.fused import (
    check_dtype,
    host_vector3,
    make_fused_step,
    make_fused_step_sitemajor,
)
from tnl_lbm_tpu_torch.kernels.fused_2d import make_fused_step_2d
from tnl_lbm_tpu_torch.kernels.fused_aa import (
    dispatch_pair_kind,
    make_fused_pair2_aa,
    make_fused_step_aa,
)
from tnl_lbm_tpu_torch.kernels.fused_ade import make_fused_ade_step
from tnl_lbm_tpu_torch.kernels.fused_coupled import (
    make_fused_coupled_step,
    make_fused_coupled_step_aa,
)
from tnl_lbm_tpu_torch.kernels.fused_nn_step import make_fused_nn_step
from tnl_lbm_tpu_torch.kernels.hooked import make_hooked_fused_step
from tnl_lbm_tpu_torch.models import D2Q9, D3Q7
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.ops.non_newtonian import CarreauYasuda, make_nn_forcing_hook
from tnl_lbm_tpu_torch.sim.state import Simulation

from torch_cases import aa_box, bc_box, channel, march_constants, nn_case

NU = 0.02
F64 = {"f": 1e-12, "rho": 2e-12, "u": 1e-12}
F32 = {"f": 1e-6, "rho": 2e-6, "u": 1e-6}
#: an inflow velocity and a force that float32 cannot hold: a rounding of
#: either to float32 moves u by ~1e-9, far past the float64 bound
U_IN64 = (0.0312345678901234, 0.0051234567890123, -0.0041234567890123)
FORCE64 = (1.2345678901234e-5, 2.345678901234e-7, -3.45678901234e-7)
NP = {"float32": np.float32, "float64": np.float64}
JNP = {"float32": jnp.float32, "float64": jnp.float64}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_side(streaming, m, periodic, dtype="float64"):
    cfg = JConfig(lat=D3Q27, collision=jcol.COLLISIONS_D3Q27["CUM_WELL"],
                  eq=jeq.EQUILIBRIA["EQ_WELL"], well=True, streaming=streaming,
                  compute_dtype=JNP[dtype])
    dom = JDomain(lat=D3Q27, units=JLattice(m.shape, (0, 0, 0), 1.0, 1.0), map=m.copy(),
                  periodic=periodic)
    return cfg, dom


def port_side(streaming, m, periodic, dtype="float64"):
    return (interop.config_from_spec("CUM_WELL", "EQ_WELL", True, streaming, dtype=dtype),
            interop.domain_from_numpy(m, periodic))


def duct(shape):
    """sim_2's duct (a NOTHING ring, WALL planes, periodic x) with one
    interior NOTHING site."""
    m = np.zeros(shape, np.uint8)
    m[:, 1] = m[:, -2] = GEO.WALL
    m[:, :, 1] = m[:, :, -2] = GEO.WALL
    m[:, 0] = m[:, -1] = GEO.NOTHING
    m[:, :, 0] = m[:, :, -1] = GEO.NOTHING
    m[shape[0] // 2, 4, 4] = GEO.NOTHING
    return m, (True, False, False)


def seeded_state(shape, dtype="float64", seed=7):
    """Well-conditioned DFs at a seeded rho = 1 +- 0.01, |u| ~ 0.02, in float64
    (the JAX equilibrium), then in ``dtype``."""
    rng = np.random.default_rng(seed)
    rho = 1 + 0.01 * rng.standard_normal(shape)
    u = 0.02 * rng.standard_normal((3,) + shape)
    f = np.asarray(jeq.eq_well(D3Q27, jnp.asarray(rho), jnp.asarray(u)))
    return f.astype(NP[dtype])


def assert_close(j, p, tol, what):
    for name, a, b in zip(("f", "rho", "u"), j, p):
        d = float(np.abs(np.asarray(a, np.float64) - b.double().numpy()).max())
        assert d <= tol[name], (what, name, d)


def run_steps(jstep, step, f0, n, **kw):
    """n steps of the JAX step and the port's from f0 (A-A parities
    alternate), each held to the float64 bounds."""
    fj, fp = jnp.asarray(f0), interop.state_from_numpy(f0, "cpu")  # kept in float64
    for it in range(n):
        fj, rj, uj = jstep(fj, NU, parity=it % 2, **{k: jnp.asarray(v) for k, v in kw.items()})
        fp, rp, up = step(fp, NU, parity=it % 2, **kw)
        assert fp.dtype == rp.dtype == up.dtype == torch.float64
        assert_close((fj, rj, uj), (fp, rp, up), F64, f"step {it}")
    assert np.abs(fp.numpy() - f0).max() > 1e-5  # the steps did work
    return fp


# --------------------------------------------------------------- B4 float64

@pytest.mark.parametrize("kind", ["box", "interp_outflow"])
def test_ab_f64_plain_matches_jax(kind):
    """B4's float64 CUM_WELL step on the box of every code of the 3D set and
    on the interpolated-outflow channel, with an inflow velocity and a force
    that float32 cannot hold (the host_vector3 repair: they reach the step
    unrounded), two steps."""
    m, periodic = channel(kind)
    cfg, dom = port_side("AB", m, periodic)
    step = make_fused_step(cfg, dom, "cpu")
    assert step.kernel.name == "ab_step_f64" and step.kernel.source.endswith("f64_ab.cu")
    jstep = j_make_step(*jax_side("AB", m, periodic))
    run_steps(jstep, step, seeded_state(m.shape), 2, u_in=np.asarray(U_IN64),
              force=np.asarray(FORCE64))
    assert step.plain_calls == 2 and step.kernel.launches == 0


def test_host_vectors_keep_the_compute_dtype():
    """A homogeneous input reaches a float64 kernel as given, a float32 one
    rounded once to float32."""
    assert host_vector3(U_IN64, "u_in", "", torch.float64) == U_IN64
    assert host_vector3(np.asarray(FORCE64), "force", "", torch.float64) == FORCE64
    assert host_vector3(U_IN64, "u_in", "") == tuple(float(np.float32(v)) for v in U_IN64)


# ---------------------------------------------------- B4's profile instances

@pytest.mark.parametrize("full", [False, True], ids=["profile_1yz", "profile_xyz"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ab_profile_plain_matches_jax(dtype, full):
    """B4's profile instance (CUM_WELL) on the box of every code, whose
    INFLOW_LEFT and INFLOW sites read a seeded profile [3, 1, Y, Z] or
    [3, X, Y, Z], against the JAX XLA step, which the JAX driver runs for a
    profile: two steps, float32 at the step bounds, float64 at 1e-12."""
    m, periodic = channel("box")
    X, Y, Z = m.shape
    prof = (0.03 * np.random.default_rng(3).standard_normal((3, X if full else 1, Y, Z)))
    prof = prof.astype(NP[dtype])
    cfg, dom = port_side("AB", m, periodic, dtype)
    step = make_fused_step(cfg, dom, "cpu")
    assert step.profile.name == ("ab_step_profile" if dtype == "float32" else
                                 "ab_step_f64_profile")
    jstep = j_make_step(*jax_side("AB", m, periodic, dtype))
    f0 = seeded_state(m.shape, dtype)
    fj, fp = jnp.asarray(f0), torch.from_numpy(f0.copy())
    tol = F64 if dtype == "float64" else F32
    for it in range(2):
        fj, rj, uj = jstep(fj, NU, u_in=jnp.asarray(prof), force=jnp.asarray(FORCE64, JNP[dtype]))
        fp, rp, up = step(fp, NU, u_in=prof, force=FORCE64)
        assert fp.dtype == torch.float64 if dtype == "float64" else fp.dtype == torch.float32
        assert_close((fj, rj, uj), (fp, rp, up), tol, f"step {it}")
    # the inflow sites took the profile: u there is the profile's
    il = torch.from_numpy(m == GEO.INFLOW_LEFT)
    want = torch.from_numpy(np.broadcast_to(prof, (3, X, Y, Z)).copy()).to(up.dtype)
    assert torch.equal(up[:, il], want[:, il])


# ---------------------------------------------------------- B2/B3 float64

@pytest.mark.parametrize("kind", ["duct", "aa_box"])
def test_aa_f64_plain_matches_jax(kind):
    """B2 and B3's float64 CUM_WELL steps on sim_2's duct (the odd step's
    lean instance) and on the box of every A-A code (the full-set one), both
    parities twice."""
    if kind == "duct":
        m, periodic = duct((12, 12, 12))
    else:
        m, periodic = aa_box((8, 16, 8)), (False, False, True)
    cfg, dom = port_side("AA", m, periodic)
    step = make_fused_step_aa(cfg, dom, "cpu")
    assert (step.even.name, step.odd.name) == ("aa_even_f64", "aa_odd_f64")
    assert step.variant == (3 if kind == "duct" else 0)
    jstep = j_make_step(*jax_side("AA", m, periodic))
    kw = {"force": np.asarray(FORCE64)}
    if kind == "aa_box":
        kw["u_in"] = np.asarray(U_IN64)
    run_steps(jstep, step, seeded_state(m.shape), 4, **kw)
    assert step.plain_calls == 4 and step.even.launches == step.odd.launches == 0


# ----------------------------------------------------------------- B1 float64

def test_pair_f64_plain_matches_jax_over_two_segments():
    """B1's float64 instance (the state stored in float64) on a duct longer
    than one x segment of the march: two pairs against four JAX steps."""
    seg = march_constants()["SEG_MAX"]
    m, periodic = duct((seg + 8, 12, 12))
    cfg, dom = port_side("AA", m, periodic)
    pair = make_fused_pair2_aa(cfg, dom, "cpu")
    assert pair.store_dtype == torch.float64 and pair.kernel.name == "aa_pair_f64"
    assert pair.kernel.source.endswith("f64_pair.cu")
    jstep = j_make_step(*jax_side("AA", m, periodic))
    f0 = seeded_state(m.shape)
    fj, fp = jnp.asarray(f0), torch.from_numpy(f0.copy())
    force = jnp.asarray(FORCE64)
    for it in range(2):
        fj, _, _ = jstep(fj, NU, force=force, parity=0)
        fj, rj, uj = jstep(fj, NU, force=force, parity=1)
        fp, rp, up = pair(fp, NU, force=FORCE64)
        assert fp.dtype == torch.float64
        assert_close((fj, rj, uj), (fp, rp, up), F64, f"pair {it}")
    assert pair.plain_calls == 2
    assert dispatch_pair_kind(cfg, dom) == "B1"


# ------------------------------------------ the Pallas kernels, interpret mode

@pytest.mark.parametrize("kernel", [pytest.param("B4", marks=pytest.mark.slow),
                                    pytest.param("B2_B3", marks=pytest.mark.slow), "B1"])
def test_f64_plain_versions_match_jax_pallas_interpret(kernel):
    """B4, B2/B3 and B1 float64 plain versions against the JAX Pallas
    kernels in interpret mode, one step (a pair) each.  B1, the quickest
    (~10-17 s on one core), runs in the default suite; B4 and B2/B3 (~20 s
    each) under ``-m slow``."""
    from tnl_lbm_tpu.kernels.fused import make_fused_step as j_ab
    from tnl_lbm_tpu.kernels.fused_aa import from_padded_aa, to_padded_aa
    from tnl_lbm_tpu.kernels.fused_aa import make_fused_pair2_aa as j_pair
    from tnl_lbm_tpu.kernels.fused_aa import make_fused_step_aa as j_aa

    if kernel == "B4":
        m, periodic = bc_box((8, 16, 8)), (False, False, True)
        f0 = seeded_state(m.shape)
        out = j_ab(*jax_side("AB", m, periodic))(jnp.asarray(f0), NU, jnp.asarray(U_IN64),
                                                jnp.asarray(FORCE64))
        step = make_fused_step(*port_side("AB", m, periodic), "cpu")
        assert_close(out, step(torch.from_numpy(f0), NU, u_in=np.asarray(U_IN64),
                               force=FORCE64), F64, "B4")
    elif kernel == "B2_B3":
        m, periodic = aa_box((8, 16, 8)), (False, False, True)
        f0 = seeded_state(m.shape)
        jaa = j_aa(*jax_side("AA", m, periodic), tile_even=(8, 8), tile_odd=(8, 8))
        step = make_fused_step_aa(*port_side("AA", m, periodic), "cpu")
        fj, fp = jnp.asarray(f0), torch.from_numpy(f0.copy())
        for parity in (0, 1):
            fj, rj, uj = jaa(fj, NU, u_in=jnp.asarray(U_IN64), force=jnp.asarray(FORCE64),
                             parity=parity)
            fp, rp, up = step(fp, NU, u_in=np.asarray(U_IN64), force=FORCE64, parity=parity)
            assert_close((fj, rj, uj), (fp, rp, up), F64, f"B2/B3 parity {parity}")
    else:
        m, periodic = duct((16, 16, 16))
        f0 = seeded_state(m.shape)
        fj, rj, uj = j_pair(*jax_side("AA", m, periodic), tile=(4, 8))(
            to_padded_aa(jnp.asarray(f0), periodic), NU, force=jnp.asarray(FORCE64))
        pair = make_fused_pair2_aa(*port_side("AA", m, periodic), "cpu")
        assert_close((from_padded_aa(fj, m.shape[-1]), rj, uj),
                     pair(torch.from_numpy(f0), NU, force=FORCE64), F64, "B1")


# ----------------------------------------------- Simulation's profile input

def test_device_input_keeps_the_compute_dtype(tmp_path):
    """The profile a chunk's graph captures is the host profile in the
    compute dtype: a float64 run's keeps its double values (it was cast to
    float32), a float32 run's is rounded once."""
    m, periodic = channel("box")
    prof = 0.03 * np.random.default_rng(4).standard_normal((3, 1) + m.shape[1:])
    for dtype in ("float64", "float32"):
        cfg, dom = port_side("AB", m, periodic, dtype)
        sim = Simulation(cfg, dom, device="cpu", sim_id=dtype, results_parent=tmp_path,
                         use_fused=True)
        got = sim._device_input(prof)
        assert got.dtype == cfg.compute_dtype
        np.testing.assert_array_equal(got.numpy(), prof.astype(NP[dtype]))
        assert sim._device_input(prof) is got  # made once per value


# ----------------------------------------------------------------- refusals

def _float64_kernels():
    """name -> (a function that builds the kernel for a float64 config on a
    card, the ROADMAP item its refusal names)."""
    m, periodic = bc_box((8, 16, 8)), (False, False, True)
    c64 = {(cid, st): interop.config_from_spec(cid, eq, cid == "CUM_WELL", st, dtype="float64")
           for cid, eq in (("CUM_WELL", "EQ_WELL"), ("CUM", "EQ"), ("SRT", "EQ"))
           for st in ("AB", "AA")}
    dom_ab = interop.domain_from_numpy(m, periodic)
    dom_aa = interop.domain_from_numpy(aa_box((8, 16, 8)), periodic)
    dom_duct = interop.domain_from_numpy(*duct((8, 12, 12)))
    acfg = interop.ade_config_from_spec("CLBM", "AB", dtype="float64")
    acfg32 = {st: interop.ade_config_from_spec("CLBM", st) for st in ("AB", "AA")}
    adom = interop.domain_from_numpy(np.zeros((8, 16, 8), np.uint8), periodic, lat=D3Q7)
    nm, nper, _, hper = nn_case("duct", (8, 16, 8))
    model = CarreauYasuda(0.1, 1.0, 2.0, 0.5)
    hooked = dataclasses.replace(c64[("CUM_WELL", "AB")],
                                 forcing_hook=make_nn_forcing_hook(model, periodic=hper))
    dom_nn = interop.domain_from_numpy(nm, nper)
    cfg2d = dataclasses.replace(interop.config_2d_from_spec("SRT"), compute_dtype=torch.float64)
    dom2d = interop.domain_from_numpy(np.zeros((16, 8), np.uint8), (True, True), lat=D2Q9)
    cw_ab, cw_aa = c64[("CUM_WELL", "AB")], c64[("CUM_WELL", "AA")]
    return {
        "B4 SRT": (lambda: make_fused_step(c64[("SRT", "AB")], dom_ab, "cuda"), "Bf64"),
        "B4 CUM": (lambda: make_fused_step(c64[("CUM", "AB")], dom_ab, "cuda"), "Bf64"),
        "B4 force_field": (lambda: make_fused_step(cw_ab, dom_ab, "cuda", force_field=True),
                           "Bf64"),
        "B4 macro_only": (lambda: make_fused_step(cw_ab, dom_ab, "cuda", macro_only=True),
                          "Bf64"),
        "B2/B3 CUM": (lambda: make_fused_step_aa(c64[("CUM", "AA")], dom_aa, "cuda"), "Bf64"),
        "B2/B3 force_field": (lambda: make_fused_step_aa(cw_aa, dom_aa, "cuda",
                                                         force_field=True), "Bf64"),
        "B4s": (lambda: make_fused_step_sitemajor(cw_ab, dom_ab, "cuda"), "Bf64"),
        "B1b map": (lambda: dispatch_pair_kind(cw_aa, dom_aa), "Bf64"),
        "B1b collision": (lambda: dispatch_pair_kind(c64[("CUM", "AA")], dom_duct), "Bf64"),
        "B1 half": (lambda: make_fused_pair2_aa(cw_aa, dom_duct, "cuda",
                                                store_dtype=torch.float16), "Bh64"),
        "B1 half dispatch": (lambda: dispatch_pair_kind(cw_aa, dom_duct, torch.bfloat16),
                             "Bh64"),
        "B5": (lambda: make_fused_step_2d(cfg2d, dom2d, "cuda"), "Bf64"),
        "B6": (lambda: make_fused_ade_step(acfg, adom, "cuda"), "Bf64"),
        "B7": (lambda: make_fused_coupled_step(cw_ab, dom_ab, acfg32["AB"], adom, "cuda"),
               "Bf64"),
        "B8": (lambda: make_fused_coupled_step_aa(cw_aa, dom_aa, acfg32["AA"], adom, "cuda"),
               "Bf64"),
        "B10": (lambda: make_fused_nn_step(hooked, dom_nn, model, hper, "cuda"), "Bf64"),
        "B9 pipeline": (lambda: make_hooked_fused_step(dataclasses.replace(
            hooked, forcing_hook=make_nn_forcing_hook(model)), dom_nn, "cuda"), "Bf64"),
    }


REFUSING_64 = ("B4 SRT", "B4 CUM", "B4 force_field", "B4 macro_only", "B2/B3 CUM",
               "B2/B3 force_field", "B4s", "B1b map", "B1b collision", "B1 half",
               "B1 half dispatch", "B5", "B6", "B7", "B8", "B10", "B9 pipeline")


@pytest.mark.parametrize("kernel", REFUSING_64)
def test_float64_outside_the_instances_refuses_on_the_card(kernel, monkeypatch):
    """Every float64 config that no float64 instance takes raises on the
    card and names its ROADMAP item: another collision or variant of the
    per-step kernels, B4s, B1b's maps and collisions, B5-B10, and 16-bit
    storage under float64 compute (which the pair dispatch refuses on any
    device).  No route runs a plain step on the card in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    kernels = _float64_kernels()
    assert set(kernels) == set(REFUSING_64)
    build, item = kernels[kernel]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        build()


def test_float64_state_never_reaches_a_float32_entry():
    """A launch takes the state of its config's compute dtype only."""
    cfg32, cfg64 = (interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AB", dtype=d)
                    for d in ("float32", "float64"))
    check_dtype(torch.zeros(1, dtype=torch.float64), cfg64)
    with pytest.raises(NotImplementedError, match="float64"):
        check_dtype(torch.zeros(1, dtype=torch.float64), cfg32)
    with pytest.raises(NotImplementedError, match="float32"):
        check_dtype(torch.zeros(1, dtype=torch.float32), cfg64)


# -------------------------------------------------------------- checkpoints

def test_float64_run_checkpoints_bit_for_bit_and_from_jax(tmp_path):
    """sim_2 res 1 in float64 (A-B, the kernel route's plain version): a
    run's ``save_state`` resumes bit for bit in float64; a JAX float64
    checkpoint of the same app resumes in the port in float64, equal to the
    JAX state."""
    first = sim_2.build(1, device="cpu", precision="double", use_fused=True, final_time=1.0,
                        results_parent=tmp_path / "port")
    first.sim_init()
    first._advance(4)
    first.save_state()
    second = sim_2.build(1, device="cpu", precision="double", use_fused=True, final_time=1.0,
                         results_parent=tmp_path / "port")
    second.sim_init()
    assert second.iterations == 4 and second.f.dtype == torch.float64
    assert torch.equal(second.f, first.f)
    ref = jsim_2.build(1, precision="double", final_time=1.0, results_parent=tmp_path / "jax")
    ref.sim_init()
    ref._advance(4)
    ref.save_state()
    port = sim_2.build(1, device="cpu", precision="double", use_fused=True, final_time=1.0,
                       results_parent=tmp_path / "jax")
    port.sim_init()
    assert port.iterations == 4 and port.f.dtype == torch.float64
    np.testing.assert_array_equal(port.f.numpy(), np.asarray(ref.f))
    assert np.asarray(ref.f).dtype == np.float64
