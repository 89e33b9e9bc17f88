"""The one-kernel A-A pair of ``tnl_lbm_tpu_torch.kernels.fused_aa`` on the CPU.

On CPU tensors the pair runs its plain version, the odd step of the even
step (``FusedPairAA.plain``).  It is held against two JAX ``make_step``
A-A steps (and, under ``-m slow``, the JAX ``make_fused_pair2_aa`` in
interpret mode) at the JAX kernel suite's bounds, |df| < 1e-6,
|drho| < 2e-6, |du| < 1e-6; with half storage against the JAX pair in
interpret mode, within one unit in the last place of the store dtype.
Then the pair dispatch of ``Simulation`` and sim_2's ``--storage``, and
the schedule of ``csrc/aa_pair.cu`` (column tiles, x segments, the ring of
even-output slots and the staged input rows) transliterated into numpy.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.apps import sim_1 as jsim_1
from tnl_lbm_tpu.models import D3Q27
from tnl_lbm_tpu.sim import make_step as j_make_step
from tnl_lbm_tpu.sim import state as jstate
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.apps import sim_1, sim_2
from tnl_lbm_tpu_torch.kernels.fused_aa import (
    FusedPairAA,
    FusedPairAAFull,
    PAIR_COLUMN,
    PAIR_STAGES,
    from_storage,
    make_fused_pair2_aa,
    make_fused_step_aa,
    to_storage,
)
from tnl_lbm_tpu_torch.ops import streaming as pstream
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim import make_step
from tnl_lbm_tpu_torch.sim.config import LBMConfig
from tnl_lbm_tpu_torch.sim.state import Simulation, needs_per_step_state

from tnl_lbm_tpu_torch.utils.dtypes import state_agrees

from test_torch_step import FORCE, NU, geometry, jax_side, rand_f, spec
from torch_cases import CSRC, aa_box, bc_box, march_constants

HALF = {"f16": (torch.float16, jnp.float16), "bf16": (torch.bfloat16, jnp.bfloat16)}


def port_pair(kind, **kw):
    m, periodic = geometry(kind)
    return make_fused_pair2_aa(interop.config_from_spec(**spec("AA")),
                               interop.domain_from_numpy(m, periodic), "cpu", **kw)


def assert_close(fj, rj, uj, fp, rp, up, what):
    assert np.abs(np.asarray(fj) - fp.numpy()).max() < 1e-6, f"f, {what}"
    assert np.abs(np.asarray(rj) - rp.numpy()).max() < 2e-6, f"rho, {what}"
    assert np.abs(np.asarray(uj) - up.numpy()).max() < 1e-6, f"u, {what}"


@pytest.mark.parametrize("kind", ["duct", "torus"])
def test_plain_pair_matches_two_jax_steps(kind):
    m, periodic = geometry(kind)
    jcfg, jdom = jax_side(spec("AA"), m, periodic)
    jstep = j_make_step(jcfg, jdom)
    pair = port_pair(kind)
    f0 = rand_f(jcfg, seed=5)
    fj, fp = jnp.asarray(f0), interop.state_from_numpy(f0, "cpu")
    for it in range(2):
        for parity in (0, 1):
            fj, rj, uj = jstep(fj, NU, force=jnp.asarray(FORCE, jnp.float32), parity=parity)
        fp, rp, up = pair(fp, NU, force=FORCE)
        assert_close(fj, rj, uj, fp, rp, up, f"pair {it}")
    assert pair.plain_calls == 2 and pair.kernel.launches == 0
    assert np.abs(fp.numpy() - f0).max() > 1e-5  # the state moved


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["duct", "torus"])
def test_plain_pair_matches_jax_pair2_interpret(kind):
    from tnl_lbm_tpu.kernels.fused_aa import from_padded_aa, to_padded_aa
    from tnl_lbm_tpu.kernels.fused_aa import make_fused_pair2_aa as j_make_pair2

    m, periodic = geometry(kind)
    jcfg, jdom = jax_side(spec("AA"), m, periodic)
    jpair = j_make_pair2(jcfg, jdom, tile=(4, 8))
    pair = port_pair(kind)
    f0 = rand_f(jcfg, seed=5)
    fj, fp = to_padded_aa(jnp.asarray(f0), periodic), interop.state_from_numpy(f0, "cpu")
    for it in range(2):
        fj, rj, uj = jpair(fj, NU, force=jnp.asarray(FORCE, jnp.float32))
        fp, rp, up = pair(fp, NU, force=FORCE)
        assert_close(from_padded_aa(fj, m.shape[-1]), rj, uj, fp, rp, up, f"pair {it}")


def _variant_case():
    """The JAX half-storage test's case (tests/test_fused_kernel.py:681):
    its 8x32x8 duct with a NOTHING site and its seed-23 state."""
    from test_fused_kernel import _variant_domain
    from test_fused_kernel import rand_f as j_rand_f
    from tnl_lbm_tpu.ops import collision as jcol
    from tnl_lbm_tpu.ops import equilibrium as jeq
    from tnl_lbm_tpu.sim import LBMConfig as JConfig

    jdom = _variant_domain()
    jcfg = JConfig(lat=D3Q27, collision=jcol.collide_cum_well, eq=jeq.eq_well, well=True,
                   streaming="AA")
    return jcfg, jdom, np.asarray(j_rand_f(jdom, jcfg, seed=23))


@pytest.mark.parametrize("store", ["f16", "bf16"])
def test_half_pair_matches_jax_pair2_interpret(store):
    from tnl_lbm_tpu.kernels.fused_aa import from_padded_aa, to_padded_aa
    from tnl_lbm_tpu.kernels.fused_aa import make_fused_pair2_aa as j_make_pair2

    tdt, jdt = HALF[store]
    jcfg, jdom, f0 = _variant_case()
    force = np.array([1e-5, 0.0, 0.0])
    jpair = j_make_pair2(jcfg, jdom, tile=(4, 8), store_dtype=jdt)
    fj, rj, uj = jpair(to_padded_aa(jnp.asarray(f0), jdom.periodic, store_dtype=jdt), 0.02,
                       force=jnp.asarray(force, jnp.float32))
    pair = make_fused_pair2_aa(interop.config_from_spec(**spec("AA")),
                               interop.domain_from_numpy(jdom.map, jdom.periodic), "cpu",
                               store_dtype=tdt)
    fp, rp, up = pair(to_storage(interop.state_from_numpy(f0, "cpu"), tdt), 0.02, force=force)
    assert fp.dtype == tdt and rp.dtype == up.dtype == torch.float32
    fj32 = torch.from_numpy(np.asarray(from_padded_aa(fj, jdom.shape[-1]), np.float32))
    assert state_agrees(fj32.to(tdt), fp, tdt)
    assert np.abs(np.asarray(rj) - rp.numpy()).max() < 2e-6
    assert np.abs(np.asarray(uj) - up.numpy()).max() < 1e-6


@pytest.mark.parametrize("store", ["f16", "bf16"])
def test_half_storage_properties(store):
    """As the JAX suite's test_pair2_half_storage_accuracy: the state stays
    narrow, rho and u stay wide, NOTHING sites keep their bits, and the
    velocity stays within the storage-rounding envelope of float32."""
    tdt, _ = HALF[store]
    _, jdom, f0 = _variant_case()
    dom = interop.domain_from_numpy(jdom.map, jdom.periodic)
    cfg = interop.config_from_spec(**spec("AA"))
    full = make_fused_pair2_aa(cfg, dom, "cpu")
    half = make_fused_pair2_aa(cfg, dom, "cpu", store_dtype=tdt)
    assert half.store_dtype == tdt and half.kernel.name == f"aa_pair_{store}"
    start = interop.state_from_numpy(f0, "cpu")
    f32, fh = start, to_storage(start, tdt)
    for _ in range(3):
        f32, _, u32 = full(f32, 0.02, force=FORCE)
        fh, rh, uh = half(fh, 0.02, force=FORCE)
    assert fh.dtype == tdt and rh.dtype == uh.dtype == torch.float32
    du = float((uh.double() - u32.double()).abs().max())
    assert torch.isfinite(uh).all() and 0 < du < {"f16": 2e-3, "bf16": 2e-2}[store]
    assert torch.equal(fh[:, 2, 2, 2], to_storage(start[:, 2, 2, 2], tdt))
    # the conditioning guard: raw (non-well) DFs refuse half storage
    raw = interop.config_from_spec("CUM", "EQ", False, "AA")
    with pytest.raises(ValueError, match="well"):
        make_fused_pair2_aa(raw, dom, "cpu", store_dtype=tdt)
    with pytest.raises(ValueError, match="well"):
        LBMConfig(lat=raw.lat, collision=raw.collision, streaming="AA", storage_dtype=tdt)


def test_storage_round_trip_rounds_to_nearest_even():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(1000).astype(np.float32) * 1e-3)
    assert to_storage(x, None) is x and from_storage(x, torch.float32) is x
    h = to_storage(x, torch.float16)
    np.testing.assert_array_equal(h.numpy(), x.numpy().astype(np.float16))
    assert from_storage(h, torch.float32).dtype == torch.float32


@pytest.mark.parametrize("store", ["f16", "bf16"])
def test_state_agrees_refuses_a_truncating_narrowing(store):
    """The half-storage bound accepts round-to-nearest-even of float32
    values that differ by 1e-9 here and there, and refuses rounding toward
    zero, which also stays within one ulp everywhere."""
    tdt, _ = HALF[store]
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.standard_normal(100_000) * 1e-3).astype(np.float32))
    noisy = x + torch.from_numpy(np.where(rng.random(x.shape) < 1e-3, 1e-9, 0.0)).float()
    rn = x.to(tdt)
    rz = torch.where(rn.float().abs() > x.abs(), torch.nextafter(rn, torch.zeros_like(rn)), rn)
    assert state_agrees(noisy.to(tdt), rn, tdt)
    assert not state_agrees(rz, rn, tdt)
    assert not state_agrees(x, x + 2e-6, torch.float32) and state_agrees(x, x + 5e-7, torch.float32)


def test_pair_writes_into_out_and_refuses_bad_calls():
    pair = port_pair("duct")
    f = interop.state_from_numpy(rand_f(jax_side(spec("AA"), *geometry("duct"))[0]), "cpu")
    out = torch.empty_like(f)
    f_new, _, _ = pair(f, NU, force=FORCE, out=out)
    assert f_new is out and not torch.equal(out, f)
    with pytest.raises(ValueError):
        pair(f, NU, out=f)
    with pytest.raises(ValueError):
        pair(f.half(), NU)
    with pytest.raises(NotImplementedError, match="ROADMAP Bprof"):
        pair(f, NU, u_in=np.zeros((3, 1, 16, 8)))
    with pytest.raises(ValueError, match="prepadded"):  # the haloed pair's flags
        pair(f, NU, bflags=np.ones(6))
    for kw in ({"prepadded": True, "z_halo": 2}, {"local_shape": (8, 16, 8), "z_halo": 2},
               {"z_halo": 2}):
        with pytest.raises(NotImplementedError, match="A13"):
            port_pair("duct", **kw)
    with pytest.raises(ValueError, match="prepadded=True"):
        port_pair("duct", local_shape=(8, 16, 8))
    with pytest.raises(TypeError):
        port_pair("duct", tile=(8, 32))
    with pytest.raises(ValueError):
        make_fused_pair2_aa(interop.config_from_spec(**spec("AB")),
                            interop.domain_from_numpy(*geometry("duct")), "cpu")
    nomacro = port_pair("duct", with_macro=False)
    assert nomacro(f, NU)[1:] == (None, None)


def test_per_step_steps_refuse_half_storage():
    m, periodic = geometry("duct")
    cfg = interop.config_from_spec(**spec("AA"), storage="float16")
    assert cfg.storage_dtype == torch.float16
    dom = interop.domain_from_numpy(m, periodic)
    for build in (lambda: make_step(cfg, dom), lambda: make_fused_step_aa(cfg, dom, "cpu")):
        with pytest.raises(NotImplementedError, match="pair dispatch"):
            build()
    assert make_fused_pair2_aa(cfg, dom, "cpu", store_dtype=cfg.storage_dtype)


def test_cuda_pair_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fused_pair2_aa(interop.config_from_spec(**spec("AA")),
                            interop.domain_from_numpy(*geometry("duct")), "cuda")


# ----------------------------------------------------------- Simulation


class Duct(Simulation):
    """The test duct with a body force, counting its step hooks."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.hook_calls = [0, 0]

    def body_force(self, phys_time):
        return FORCE

    def compute_before_step(self):
        self.hook_calls[0] += 1

    def compute_after_step(self):
        self.hook_calls[1] += 1


def make_sim(tmp_path, pair_dispatch, storage=None, cls=Duct, tag="sim"):
    m, periodic = geometry("duct")
    cfg = interop.config_from_spec(**spec("AA"), storage=storage)
    dom = interop.domain_from_numpy(m, periodic, phys_viscosity=NU)
    return cls(cfg, dom, device="cpu", sim_id=tag, results_parent=tmp_path,
               use_fused=True, pair_dispatch=pair_dispatch)


def sim_1_aa(tmp_path, pair_dispatch, tag="sim_1"):
    """The port's sim_1 at resolution 1 (128 x 32 x 32) with A-A streaming:
    CUM with eq_inv_cum, its inflow, OUTFLOW_RIGHT and the holed wall."""
    return sim_1.build(1, device="cpu", streaming="AA", pair_dispatch=pair_dispatch,
                       results_parent=tmp_path / tag)


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case,chunks", [("duct", (7,)), ("duct", (3, 4)), ("sim_1", (7,)),
                                         ("sim_1", (3, 4))],
                         ids=["from_even", "odd_start", "sim_1_from_even", "sim_1_odd_start"])
def test_pair_dispatch_is_bit_identical_to_per_step(tmp_path, one_torch_thread, case, chunks):
    """(7,): three pairs and a leftover step; (3, 4): a pair and a
    leftover step, then a chunk that starts at an odd iteration and so runs
    per step.  On the duct the pair is B1, on sim_1's A-A map B1b."""
    if case == "duct":
        sims = [make_sim(tmp_path, p, tag=str(p)) for p in (True, False)]
    else:
        sims = [sim_1_aa(tmp_path, p, tag=str(p)) for p in (True, False)]
    for sim in sims:
        sim.sim_init()
        for n in chunks:
            sim._advance(n)
    paired, stepped = sims
    assert paired.pair_dispatch is True and stepped.pair_dispatch is False
    assert type(paired._pair) is (FusedPairAA if case == "duct" else FusedPairAAFull)
    assert paired.iterations == stepped.iterations == 7
    for name in ("f", "rho", "u"):
        assert torch.equal(getattr(paired, name), getattr(stepped, name)), name
    n_pairs = 3 if chunks == (7,) else 1
    assert paired._pair.plain_calls == n_pairs and paired._pair.kernel.launches == 0
    assert paired._step.plain_calls == 7 - 2 * n_pairs
    assert stepped._pair is None and stepped._step.plain_calls == 7


#: pair dispatch's static eligibility per config, the JAX package's
#: ``_pair_dispatch_capable``: the duct under CUM_WELL (B1) and CUM with
#: eq_quadratic (B1b), sim_1's A-A map (B1b), a box with OUTFLOW_RIGHT_INTERP,
#: the duct with a forcing hook, a D2Q9 channel
CAPABLE = {"duct_cum_well": True, "duct_cum_quad": True, "sim_1": True,
           "outflow_right_interp": False, "forcing_hook": False, "d2q9": False}


def both_packages(tmp_path, case):
    """(port Simulation, JAX Simulation) of one config, not initialised."""
    from tnl_lbm_tpu.ops import non_newtonian as jnn
    from tnl_lbm_tpu_torch.ops import non_newtonian as pnn

    if case == "sim_1":
        return (sim_1_aa(tmp_path, True),
                jsim_1.build(1, streaming="AA", pair_dispatch=True, results_parent=tmp_path / "j"))
    if case == "d2q9":
        from test_torch_driver import jax_channel, port_channel

        port, ref = port_channel(tmp_path), jax_channel(tmp_path)
        port.cfg = dataclasses.replace(port.cfg, streaming="AA")
        ref.cfg = dataclasses.replace(ref.cfg, streaming="AA")
        ref.use_fused = True
        return port, ref
    if case == "outflow_right_interp":
        m, periodic = bc_box((8, 16, 12)), (False, False, True)
    else:
        m, periodic = geometry("duct")
    s = spec("AA", "CUM" if case in ("duct_cum_quad", "outflow_right_interp") else "CUM_WELL")
    cfg, dom = interop.config_from_spec(**s), interop.domain_from_numpy(m, periodic)
    jcfg, jdom = jax_side(s, m, periodic)
    if case == "forcing_hook":
        cy = (0.1, 1.0, 2.0, 0.5)
        cfg = dataclasses.replace(cfg, forcing_hook=pnn.make_nn_forcing_hook(
            pnn.CarreauYasuda(*cy), periodic=periodic))
        jcfg = dataclasses.replace(jcfg, forcing_hook=jnn.make_nn_forcing_hook(
            jnn.CarreauYasuda(*cy), periodic=periodic))
    port = Simulation(cfg, dom, device="cpu", sim_id="port", results_parent=tmp_path,
                      use_fused=True, pair_dispatch=True)
    ref = jstate.Simulation(jcfg, jdom, sim_id="jax", results_parent=tmp_path, use_fused=True,
                            pair_dispatch=True)
    return port, ref


@pytest.mark.parametrize("case", sorted(CAPABLE))
def test_pair_dispatch_capability_is_the_jax_packages(tmp_path, case):
    port, ref = both_packages(tmp_path, case)
    assert port._pair_dispatch_capable() is ref._pair_dispatch_capable() is CAPABLE[case]


def test_pair_dispatch_picks_b1_or_b1b_and_refuses_what_neither_builds(tmp_path):
    """The duct under CUM_WELL keeps B1 in every store dtype; sim_1's A-A map
    (CUM, eq_inv_cum) and the duct under CUM run B1b; half storage on the
    box of every A-A code, and a float64 state on a B1b map, raise naming their
    ROADMAP items rather than running per step."""
    m, periodic = geometry("duct")
    dom = interop.domain_from_numpy(m, periodic, phys_viscosity=NU)
    built = {}
    for tag, s, storage in (("b1", spec("AA"), None), ("b1_f16", spec("AA"), "float16"),
                            ("b1b", spec("AA", "CUM"), None)):
        sim = Simulation(interop.config_from_spec(**s, storage=storage), dom, device="cpu",
                         sim_id=tag, results_parent=tmp_path, use_fused=True, pair_dispatch=True)
        sim.sim_init()
        built[tag] = sim._pair
    assert type(built["b1"]) is type(built["b1_f16"]) is FusedPairAA
    assert built["b1_f16"].store_dtype == torch.float16
    assert type(built["b1b"]) is FusedPairAAFull
    sim = sim_1_aa(tmp_path, True)
    sim.sim_init()
    assert type(sim._pair) is FusedPairAAFull and sim._pair_dispatch_ok()
    assert sim._pair.codes == sim._step.codes and sim.f.dtype == torch.float32
    half = Simulation(interop.config_from_spec(**spec("AA"), storage="bfloat16"),
                      interop.domain_from_numpy(aa_box((8, 16, 12)), (False, False, True)),
                      device="cpu", sim_id="half", results_parent=tmp_path, use_fused=True)
    with pytest.raises(NotImplementedError, match="ROADMAP B1h"):
        half.sim_init()
    wide = Simulation(interop.config_from_spec(**{**spec("AA", "CUM"), "dtype": "float64"}), dom,
                      device="cpu", sim_id="f64", results_parent=tmp_path, use_fused=True,
                      pair_dispatch=True)
    with pytest.raises(NotImplementedError, match="ROADMAP Bf64"):
        wide.sim_init()
    auto = sim_1_aa(tmp_path, "auto", tag="auto")
    auto.sim_init()
    assert auto.pair_dispatch is False and auto._pair is None  # "auto" is per step on the CPU


def test_sim_1_in_pairs_matches_jax_steps(tmp_path, one_torch_thread):
    """sim_1's A-A map at resolution 1 through pair dispatch (B1b's plain
    version), two pairs from a seeded state with the app's inflow, against
    four JAX A-A steps of the JAX app's config and map: f, rho and u within
    the kernel suite's per-step bounds times the steps."""
    from test_torch_layouts import seeded

    sim = sim_1_aa(tmp_path, True)
    ref = jsim_1.build(1, streaming="AA", results_parent=tmp_path / "j")
    assert np.array_equal(sim.domain.map, np.asarray(ref.domain.map))
    sim.sim_init()
    jstep = j_make_step(ref.cfg, ref.domain)
    f0 = seeded(ref.cfg, sim.domain.shape)
    sim.f.copy_(torch.from_numpy(f0))
    fj = jnp.asarray(f0)
    nu = sim.domain.units.lbm_viscosity()
    u_in = jnp.asarray(sim.update_inflow(0.0), jnp.float32)
    for k in range(2):
        sim._advance(2)
        for parity in (0, 1):
            fj, rj, uj = jstep(fj, nu, u_in=u_in, parity=parity)
        steps = 2 * (k + 1)
        for name, a, b, bound in (("f", fj, sim.f, 1e-6), ("rho", rj, sim.rho, 2e-6),
                                  ("u", uj, sim.u, 1e-6)):
            d = float(np.abs(np.asarray(a) - b.numpy()).max())
            assert d < bound * steps, (name, steps, d)
    assert sim._pair.plain_calls == 2 and sim._step.plain_calls == 0
    assert float(np.abs(sim.f.numpy() - f0).max()) > 1e-5


def test_hooks_run_once_per_pair(tmp_path):
    paired, stepped = make_sim(tmp_path, True, tag="p"), make_sim(tmp_path, False, tag="s")
    for sim in (paired, stepped):
        sim.sim_init()
        sim._advance(6)
    assert paired.hook_calls == [3, 3] and stepped.hook_calls == [6, 6]
    assert paired.f is not None and paired.f.dtype == torch.float32


def test_pair_loop_ping_pongs_the_persistent_spare(tmp_path):
    """A float32 pair loop keeps the state in ``f`` and the spare buffer made
    at sim_init across chunks, allocating none; a 16-bit state keeps no
    float32 spare."""
    sim = make_sim(tmp_path, True, tag="f32")
    sim.sim_init()
    buffers = {sim.f.data_ptr(), sim._spare.data_ptr()}
    seen = set()
    for n in (2, 4, 2):
        sim._advance(n)
        assert {sim.f.data_ptr(), sim._spare.data_ptr()} == buffers
        seen.add(sim.f.data_ptr())
    assert seen == buffers and sim.iterations == 8 and sim._pair.plain_calls == 4
    half = make_sim(tmp_path, True, storage="float16", tag="f16")
    half.sim_init()
    assert half._spare is None


def test_needs_per_step_state_turns_pair_dispatch_off(tmp_path):
    class ReadsF(Duct):
        @needs_per_step_state
        def compute_after_step(self):
            assert self.f is not None

    sim = make_sim(tmp_path, True, cls=ReadsF)
    sim.sim_init()
    sim._advance(4)
    assert not sim._pair_dispatch_ok() and sim._pair is None
    assert sim._step.plain_calls == 4


def test_dispatch_chunks_do_not_rescan_the_map(tmp_path):
    """The pair-dispatch decision is made once at sim_init: a chunk must not
    scan the geometry map (np.unique over 16.7M sites at 256^3 cost more
    than the pair kernel itself)."""
    sim = make_sim(tmp_path, True)
    sim.sim_init()

    def scan():
        raise AssertionError("the geometry map was scanned during a dispatch chunk")

    sim.domain.codes_present = scan
    sim._advance(4)
    assert sim._pair.plain_calls == 2


def test_half_storage_forces_pair_dispatch(tmp_path):
    for pd in ("auto", True):
        sim = make_sim(tmp_path, pd, storage="bfloat16", tag=f"h{pd}")
        sim.sim_init()
        assert sim.pair_dispatch is True and sim._pair.store_dtype == torch.bfloat16
        sim._advance(2)
        assert sim.f.dtype == torch.float32 and sim._pair.plain_calls == 1
    sim = make_sim(tmp_path, False, storage="float16", tag="off")
    with pytest.raises(ValueError, match="pair"):
        sim.sim_init()


def test_auto_resolves_to_per_step_on_the_cpu(tmp_path):
    sim = make_sim(tmp_path, "auto")
    sim.sim_init()
    assert sim.pair_dispatch is False and sim.pair_probe_ms is None and sim._pair is None


def test_sim2_storage_runs_the_pair_path(tmp_path, capsys):
    sim = sim_2.main(["1", "--device", "cpu", "--storage", "f16", "--final-time", "0.05",
                      "--results-dir", str(tmp_path)])
    assert "final l1error_phys" in capsys.readouterr().out
    assert sim.cfg.streaming == "AA" and sim.use_fused and sim.pair_dispatch is True
    assert sim.cfg.storage_dtype == torch.float16 and sim.id.endswith("_store_f16")
    assert sim._pair.plain_calls * 2 == sim.iterations >= 10 and sim._step.plain_calls == 0
    assert sim.f.dtype == torch.float32 and torch.isfinite(sim.u).all()
    assert sim.error_history and np.isfinite(sim.last_errors).all()


# ------------------------------------- the schedule of csrc/aa_pair.cu


def _neighbour(s, d, n, periodic):
    """Python transliteration of csrc/lbm_site.cuh neighbour."""
    t = s + d
    if periodic:
        return t + n if t < 0 else (t - n if t >= n else t)
    return 0 if t < 0 else (n - 1 if t >= n else t)


def _push_targets(s, c, n, periodic):
    """numpy transliteration of csrc/lbm_site.cuh push_targets over an
    array of coordinates: (t0, t1), -1 where there is no target."""
    none = np.full_like(s, -1)
    if c == 0:
        return s, none
    if periodic:
        return (s + c) % n, none
    t = s + c
    t0 = np.where((t >= 0) & (t < n), t, -1)
    return t0, np.where((c > 0) & (s == 0) | (c < 0) & (s == n - 1), s, -1)


def _march(shape, periodic, seg_len, dtype, seed=4, outflow=False, ring_groups=None):
    """Run csrc/aa_pair.cu's schedule in numpy, block by block: the copies
    of ``issue`` into byte-level stages, the even warps' staged reads, ring
    and code writes (a seeded stand-in for the even output, a seeded map of
    FLUID, WALL and NOTHING codes) and their copies of NOTHING tile sites,
    the odd warps' ring reads and the codes their pushes read.  The two kinds of warps hand planes over through barriers:
    even plane i waits for odd plane i - 3 (``odd_done``), odd plane o for
    even plane o + 1 (``planes_done``).  The model runs the even warps as far
    ahead as that allows, so a group rewritten before its last reader read
    it shows as a wrong plane, and the reuse events record each group's and
    stage's last reader beside its next writer.  Each barrier wait is held
    to the phase it must see (mbarrier.try_wait.parity: the parity of that
    phase, and no later phase complete).  Returns (times each site
    was the odd warps', the largest odd read against pad_halo of the even
    output, the reuse events), and asserts that every push reads its
    target's code and that the even warps copy each NOTHING site once.
    ``outflow``: the full-set pair's schedule (csrc/aa_pair_full.cu), no
    stages (the even warps read the state), OUTFLOW_RIGHT sites in the map
    whose odd pulls read all 27 slots of plane o - 1, and OUT_GROUPS ring
    groups of each class unless ``ring_groups`` gives (P, Z, M)."""
    k = march_constants()
    TY, TZ, NST, G, H = k["TY"], k["TZ"], k["NSTAGES"], k["GROUP"], k["HANDOFF"]
    PG, ZG, MG, CP = k["P_GROUPS"], k["Z_GROUPS"], k["M_GROUPS"], k["CODE_PLANES"]
    if outflow:
        PG, ZG, MG = ring_groups or (k["OUT_GROUPS"],) * 3
    staged = not outflow
    WY, WZ = TY + 2, TZ + 2
    WS = WY * WZ
    X, Y, Z = shape
    px, py, pz = periodic
    lat = interop.config_from_spec(**spec("AA")).lat
    cx, cy, cz = (np.asarray(lat.c)[:, a].astype(int) for a in range(3))
    opp = np.asarray(lat.opp)
    slot = 3 * (cy + 1) + (cz + 1)
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((27,) + shape).astype(dtype)  # the stored state
    ev = rng.standard_normal((27,) + shape).astype(np.float32)  # stands in for even(f)
    pad = pstream.pad_halo(torch.from_numpy(ev), periodic).numpy()
    kinds = [GEO.FLUID, GEO.WALL, GEO.NOTHING] + ([GEO.OUTFLOW_RIGHT] if outflow else [])
    geo = rng.choice(np.array(kinds, np.uint8), shape)
    copied = np.zeros(shape, np.int64)  # NOTHING sites the even warps wrote
    isz = np.dtype(dtype).itemsize
    VEC = 16 // isz
    RB = 16 + ((TZ * isz + 4 + 15) // 16) * 16  # row_bytes<S>
    HI = 16 + TZ * isz  # hi_halo_byte<S>
    fbytes = f.reshape(-1).view(np.uint8)
    N, YZ = X * Y * Z, Y * Z
    odd_count = np.zeros(shape, np.int64)
    worst = 0.0
    events = []  # (what, buffer, written at, previous content last read at)
    nzt = -(-Z // TZ)
    for col in range(-(-Y // TY) * nzt):
        y0, z0 = (col // nzt) * TY, (col % nzt) * TZ
        ny, nz = min(TY, Y - y0), min(TZ, Z - z0)
        zlo, zhi = _neighbour(z0 - 1, 0, Z, pz), _neighbour(z0 - 1, nz + 1, Z, pz)
        t = np.arange(k["EVEN_THREADS"])  # one window site each
        lyw, lzw = t // WZ, t % WZ
        on = (t < WS) & (lyw <= ny + 1) & (lzw <= nz + 1)
        t_on = t[on]
        yg = np.array([_neighbour(y0 - 1, v, Y, py) for v in lyw[on]])
        zg = np.array([_neighbour(z0 - 1, v, Z, pz) for v in lzw[on]])
        half = 2 * (zg & 1) if isz == 2 else 0
        soff = lyw[on] * RB + np.where(lzw[on] == 0, half,
                                       np.where(lzw[on] == nz + 1, HI + half,
                                                16 + (lzw[on] - 1) * isz))
        ry = np.arange(WY)[: ny + 2]
        rowy = np.array([_neighbour(y0 - 1, v, Y, py) for v in ry])
        ly, lz = np.divmod(np.arange(k["TILE_SITES"]), TZ)
        mine = (ly < ny) & (lz < nz)
        ly, lz = ly[mine], lz[mine]
        wc = (ly + 1) * WZ + lz + 1
        for xs in range(0, X, seg_len):
            xe = min(xs + seg_len, X)
            n_even = xe - xs + 2
            ring = np.full((PG + ZG + MG, G, WS), np.nan, np.float32)
            ring_read = {}  # buffer -> iteration of the last read of its content
            stages = [None] * NST
            stage_read = {}
            codes = np.full((CP, WS), 0xEE, np.uint8)
            code_read = {}  # code plane -> last odd plane whose pushes read it
            done = {"full": [0] * NST, "planes": [0] * H, "odd": [0] * H}  # completed phases

            def issue(j):
                xg = _neighbour(xs - 1, j, X, px)
                st = np.full(27 * WY * RB, 0xEE, np.uint8)
                rows = (np.arange(27)[:, None] * WY + ry[None, :]).ravel()  # q WY + ry
                base = (np.arange(27)[:, None] * N + xg * YZ + rowy[None, :] * Z).ravel()
                src = (base + z0)[:, None] * isz + np.arange(nz * isz)  # the bulk copy
                st[(rows * RB + 16)[:, None] + np.arange(nz * isz)] = fbytes[src]
                for at, zh in ((0, zlo), (HI, zhi)):  # the halo words
                    e = base + zh
                    if isz == 2:
                        e = e & ~1
                    st[(rows * RB + at)[:, None] + np.arange(4)] = fbytes[e[:, None] * isz
                                                                          + np.arange(4)]
                # issued at even plane j - 1, after every even warp read plane j - 2
                events.append(("stage", j % NST, j - 2, stage_read.get(j % NST, -(10**9))))
                stages[j % NST] = (j, st)
                done["full"][j % NST] += 1

            for j in range(min(NST - 1, n_even) if staged else 0):
                issue(j)
            odd_planes = range(1, n_even - 1)

            def wait(kind, k, parity, n):
                # mbarrier.try_wait.parity: the barrier's n-th phase (its
                # parity given) has completed and no later one has
                assert parity == n % 2 and done[kind][k] == n + 1, (kind, k, parity, n)

            order, done_odd, i = [], 0, 0  # even as far ahead as odd_done allows
            while i < n_even or done_odd < len(odd_planes):
                if i < n_even and (i < 4 or done_odd >= i - 3):
                    order.append(("even", i))
                    i += 1
                else:
                    o = odd_planes[done_odd]
                    assert i > o + 1  # planes_done(o + 1)
                    order.append(("odd", o))
                    done_odd += 1
            for kind, i in order:
                if kind == "even":
                    if staged and i + NST - 1 < n_even:
                        issue(i + NST - 1)  # after every even warp read plane i - 1
                    if i >= 4:  # the kernel's waits, as written there
                        wait("odd", (i - 4) % H, ((i - 4) // H) & 1, (i - 4) // H)
                    xg = _neighbour(xs - 1, i, X, px)
                    if staged:
                        wait("full", i % NST, (i // NST) & 1, i // NST)
                        plane, st = stages[i % NST]
                        assert plane == i
                        got = np.stack([st[(q * WY * RB + soff)[:, None] + np.arange(isz)]
                                        .reshape(-1).view(dtype) for q in range(27)])
                        np.testing.assert_array_equal(got, f[:, xg, yg, zg])
                        stage_read[i % NST] = i
                    bufs = (i % PG, PG + i % ZG, PG + ZG + i % MG)
                    for r in range(27):
                        buf = bufs[0] if cx[r] > 0 else (bufs[1] if cx[r] == 0 else bufs[2])
                        ring[buf, slot[r], t_on] = ev[r, xg, yg, zg]
                    for buf in bufs:  # the wait covers readers up to odd plane i - 3
                        events.append(("ring", buf, i - 3, ring_read.get(buf, -(10**9))))
                    # odd plane i - 3 arrived, so odd plane i - 4 has pushed
                    events.append(("codes", i % CP, i - 4, code_read.get(i % CP, -(10**9))))
                    codes[i % CP, t_on] = geo[xg, yg, zg]
                    inner = ((lyw[on] >= 1) & (lyw[on] <= ny) & (lzw[on] >= 1) & (lzw[on] <= nz)
                             & (geo[xg, yg, zg] == GEO.NOTHING))
                    if 1 <= i <= n_even - 2:  # a NOTHING tile site of an odd plane
                        copied[xg, yg[inner], zg[inner]] += 1
                    done["planes"][i % H] += 1
                else:
                    o = i
                    wait("planes", (o + 1) % H, ((o + 1) // H) & 1, (o + 1) // H)
                    x = xs + o - 1
                    y, z = y0 + ly, z0 + lz
                    bufs = ((o + 1) % PG, PG + o % ZG, PG + ZG + (o - 1) % MG)
                    for q in range(27):
                        r = opp[q]
                        buf = bufs[0] if cx[r] > 0 else (bufs[1] if cx[r] == 0 else bufs[2])
                        got = ring[buf, slot[r], wc - cy[q] * WZ - cz[q]]
                        want = pad[r, x + 1 - cx[q], y + 1 - cy[q], z + 1 - cz[q]]
                        worst = max(worst, float(np.abs(got - want).max()))
                        ring_read[buf] = o
                    out = geo[x, y, z] == GEO.OUTFLOW_RIGHT
                    if out.any():  # every slot from plane o - 1 (x - 1, wrapped or clamped)
                        prev = ((o - 1) % PG, PG + (o - 1) % ZG, PG + ZG + (o - 1) % MG)
                        for q in range(27):
                            r = opp[q]
                            buf = prev[0] if cx[r] > 0 else (prev[1] if cx[r] == 0 else prev[2])
                            got = ring[buf, slot[r], (wc - cy[q] * WZ - cz[q])[out]]
                            want = pad[r, x, (y + 1 - cy[q])[out], (z + 1 - cz[q])[out]]
                            worst = max(worst, float(np.abs(got - want).max()))
                            ring_read[buf] = o
                    odd_count[x, y, z] += 1
                    assert (codes[o % CP, wc] == geo[x, y, z]).all()
                    done["odd"][(o - 1) % H] += 1
                    # the pushes, after the arrive: a target's code is the
                    # window's at offset c_q (s + c_q, wrapped) or 0 (the
                    # site itself, replicated at a closed face)
                    for q in range(27):
                        tx = _push_targets(np.full_like(y, x), cx[q], X, px)
                        ty = _push_targets(y, cy[q], Y, py)
                        tz = _push_targets(z, cz[q], Z, pz)
                        for a, b, c in itertools.product((0, 1), repeat=3):
                            ok = (tx[a] >= 0) & (ty[b] >= 0) & (tz[c] >= 0)
                            dx, dy, dz = (0 if a else cx[q]), (0 if b else cy[q]), (0 if c else cz[q])
                            got = codes[(o + dx) % CP, wc + dy * WZ + dz]
                            want = geo[tx[a][ok], ty[b][ok], tz[c][ok]]
                            np.testing.assert_array_equal(got[ok], want)
                    for dx in (-1, 0, 1):
                        code_read[(o + dx) % CP] = o
    np.testing.assert_array_equal(copied, geo == GEO.NOTHING)
    return odd_count, worst, events


_PERIODIC = list(itertools.product([False, True], repeat=3))


@pytest.mark.parametrize("periodic", _PERIODIC,
                         ids=["".join("p" if p else "c" for p in per) for per in _PERIODIC])
def test_pair_window_equals_pad_halo(periodic):
    """The pair kernel's schedule (csrc/aa_pair.cu, constants read from
    csrc/pair_march.cuh) on a shape that no column tile and no x segment
    divides, per periodic combination: every site is the odd sub-step's
    exactly once; every odd pull, taken from the ring of even-output slots,
    is pad_halo of the even output at s - c_q, which the odd step reads;
    each ring group is overwritten only after its last reader arrived on the
    barrier its writer waits for, each stage only after the even warps read
    it, each plane of codes only after the last pushes that read it; every
    push reads its target's code and every NOTHING site is copied once by
    the even warps; and the staged rows (16-byte
    pieces, the z-halo words) give the even sub-step the input at its window
    site, bit for bit, in float32 and, with its halo words, in float16."""
    k = march_constants()
    assert (k["TY"], k["TZ"]) == PAIR_COLUMN and k["NSTAGES"] == PAIR_STAGES
    assert (k["P_GROUPS"], k["Z_GROUPS"], k["M_GROUPS"], k["GROUP"]) == (2, 3, 4, 9)
    assert k["EVEN_THREADS"] >= k["WSITES"] and k["EVEN_THREADS"] % 32 == 0
    assert k["THREADS"] == k["EVEN_THREADS"] + k["TILE_SITES"] and k["HANDOFF"] >= 4
    shape = (7, PAIR_COLUMN[0] + 3, PAIR_COLUMN[1] + 8)  # 11 rows, 40 z sites
    for dtype, seg_len in ((np.float32, 3), (np.float16, 5)):
        count, worst, events = _march(shape, periodic, seg_len, dtype)
        assert (count == 1).all(), dtype
        assert worst == 0.0, dtype
        assert all(read <= covered for _, _, covered, read in events), dtype


@pytest.mark.parametrize("periodic", [(False, False, True), (True, False, False),
                                      (False, True, False)], ids=["ccp", "pcc", "cpc"])
def test_full_pair_ring_keeps_the_outflow_plane(periodic):
    """The full-set pair's schedule (csrc/aa_pair_full.cu, the march of
    csrc/pair_march.cuh without stages) on a map with OUTFLOW_RIGHT sites,
    over x segments of 3 and 8 planes (a segment then starts at X - 1):
    every site is the odd sub-step's once, every pull - an OUTFLOW_RIGHT
    site's 27 from plane o - 1 too - is pad_halo of the even output at its
    source, and no ring group is overwritten before its last reader
    arrived.  Its shared memory is the 12-group ring and the codes, one
    block of 608 threads per SM; with B1's 2 + 3 + 4 groups the outflow
    pulls would read overwritten groups."""
    k = march_constants()
    assert k["OUT_GROUPS"] == 4 and k["OUT_SMEM_BYTES"] == 146_880 + 1_700 <= 227 * 1024
    src = (CSRC / "aa_pair_full.cu").read_text()
    assert "OUT_SMEM_BYTES" in src and "STAGED = false, OUTFLOW = true" in src
    shape = (9, PAIR_COLUMN[0] + 3, PAIR_COLUMN[1] + 8)
    for seg in (3, 8):
        count, worst, events = _march(shape, periodic, seg, np.float32, outflow=True)
        assert (count == 1).all() and worst == 0.0, seg
        assert all(read <= covered for _, _, covered, read in events), seg
    _, worst, events = _march(shape, periodic, 3, np.float32, outflow=True,
                              ring_groups=(k["P_GROUPS"], k["Z_GROUPS"], k["M_GROUPS"]))
    assert worst > 0 or any(read > covered for _, _, covered, read in events)


def test_pair_segments_cover_x_when_x_is_shorter_than_a_segment():
    count, worst, events = _march((3, 5, 8), (True, False, True), 8, np.float32)
    assert (count == 1).all() and worst == 0.0
    assert all(read <= covered for _, _, covered, read in events)


def test_pair_seg_len_is_validated():
    with pytest.raises(ValueError, match="seg_len"):
        port_pair("duct", seg_len=0)
    pair = port_pair("duct", seg_len=2)
    f = interop.state_from_numpy(rand_f(jax_side(spec("AA"), *geometry("duct"))[0]), "cpu")
    assert torch.equal(pair(f, NU)[0], port_pair("duct")(f, NU)[0])


def test_auto_check_decides_on_separated_chains_only():
    """The check of the "auto" probe (chip_smoke.py auto_choice and its GPU
    test) gives a verdict only where every chain of one route is faster
    than every chain of the other and the medians differ by more than 10%."""
    from torch_cases import separated_faster

    assert separated_faster([2.59, 2.58, 2.60], [2.86, 2.87, 2.85]) == 0  # 256^3, PERF.md
    assert separated_faster([2.86, 2.87, 2.85], [2.59, 2.58, 2.60]) == 1
    # res 2, launch-bound: overlapping chains, whatever the medians say
    assert separated_faster([0.075, 0.090, 0.071], [0.059, 0.080, 0.060]) is None
    # separated, but within 10%
    assert separated_faster([0.0429, 0.0431], [0.0452, 0.0455]) is None
