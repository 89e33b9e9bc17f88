"""The sharded A-A pair of the port (``parallel/sharded.py``
``make_sharded_fused_pair2_aa``: B1 or B1b on persistent haloed shard
blocks) against the port's unsharded pair and per-step runs and against the
JAX package's steps, on the CPU, where the wrappers run their plain
versions.

The plans put N shards on N x ``cpu`` (``cpu_plan``, as in
tests/test_torch_sharded.py); the JAX side runs on the conftest's 8
virtual CPU devices.  Held:

- the sharded pair bit for bit the unsharded pair on sim_2's duct in every
  store dtype and float64, and on sim_1's A-A channel (B1b) on 2 x 2 and
  4 x 2 plans;
- two sharded pairs against four JAX ``make_step`` A-A steps at the step
  bounds (tests/test_sharded.py:483), and with ``-m slow`` against the JAX
  sharded pair in Pallas interpret mode (~13 s);
- ``Simulation`` under a plan in pairs against its per-step sharded run and
  the JAX ``Simulation(plan, use_fused=False)`` on the same 4 x 2 mesh
  (tests/test_sharded.py:304);
- the layout helpers against JAX ``to_padded_aa_sharded`` /
  ``from_padded_aa_sharded`` on the blocks' interiors, 16-bit included;
- a checkpoint written between runs of pairs resumes per step and
  unsharded;
- the refusals that stay: z meshes, uneven plans, B1b's family collisions.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from tnl_lbm_tpu.models import D3Q27 as JD3Q27
from tnl_lbm_tpu.ops import collision as jcol
from tnl_lbm_tpu.ops import equilibrium as jeq
from tnl_lbm_tpu.parallel import sharded as jsh
from tnl_lbm_tpu.sim import Domain as JDomain
from tnl_lbm_tpu.sim import LBMConfig as JConfig
from tnl_lbm_tpu.sim import make_step as jmake_step
from tnl_lbm_tpu.sim.state import Simulation as JSimulation
from tnl_lbm_tpu.utils import Lattice as JLattice
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.apps import sim_1
from tnl_lbm_tpu_torch.kernels.fused_aa import (
    from_storage,
    make_dispatch_pair,
    make_fused_pair_aa,
    to_storage,
)
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.parallel import sharded as sh
from tnl_lbm_tpu_torch.parallel.profiling import pair_halo_traffic
from tnl_lbm_tpu_torch.sim.state import Simulation

NU = 0.02
FORCE = (1e-5, 0.0, 0.0)
U_IN = (0.01, 0.0, 0.0)
SHAPE = (16, 16, 8)
NAMES = ("x", "y", "z")
STORES = {"f32": None, "f16": torch.float16, "bf16": torch.bfloat16}
needs_8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_plan(counts, axes=NAMES):
    """A plan of prod(counts) shards on the CPU (axis names per lattice axis)."""
    used = [(n, a) for n, a in zip(counts, axes) if a is not None]
    devices = np.empty(int(np.prod([n for n, _ in used])), dtype=object)
    devices[:] = ["cpu"] * devices.size
    mesh = sh.Mesh(devices.reshape([n for n, _ in used]), [a for _, a in used])
    return sh.ShardPlan(mesh, axes)


def seeded_f(cfg, shape, seed=1):
    rng = np.random.default_rng(seed)
    rho = torch.from_numpy(1 + 0.01 * rng.standard_normal(shape))
    u = torch.from_numpy(0.02 * rng.standard_normal((3,) + shape))
    return cfg.eq(cfg.lat, rho, u).to(cfg.compute_dtype).contiguous()


def duct_map():
    """sim_2's forced duct at 16 x 16 x 8: the NOTHING ring, the WALL
    planes, periodic x."""
    X, Y, Z = SHAPE
    m = np.zeros(SHAPE, np.uint8)
    m[:, 1] = m[:, -2] = GEO.WALL
    m[:, :, 1] = m[:, :, -2] = GEO.WALL
    m[:, 0] = m[:, -1] = GEO.NOTHING
    m[:, :, 0] = m[:, :, -1] = GEO.NOTHING
    return m, (True, False, False)


def sim1_map():
    """sim_1's channel at 16 x 16 x 8: its resolution-1 map's planes x = 0,
    8, ..., 112 and the outflow plane, every second y row and every fourth z
    (the inflow, the wall with its hole, the outflow, the NOTHING ring)."""
    sim = sim_1.build(1, device="cpu", results_parent=tempfile.mkdtemp())
    m = sim.domain.map
    xs = list(range(0, m.shape[0] - 8, 8)) + [m.shape[0] - 1]
    m = np.ascontiguousarray(m[xs][:, ::2, ::4])
    assert m.shape == SHAPE and GEO.OUTFLOW_RIGHT in m and GEO.INFLOW_LEFT in m
    return m, sim.domain.periodic


def cum_well(dtype="float32"):
    return interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AA", dtype=dtype)


def pairs_vs_unsharded(cfg, m, periodic, counts, store_dtype=None, n_pairs=2, u_in=None):
    """n_pairs of the sharded pair against the unsharded pair (the pair
    dispatch kernel's plain version), from one seeded state; returns the
    sharded pair."""
    dom = interop.domain_from_numpy(m, periodic)
    plan = cpu_plan(counts)
    one = make_dispatch_pair(cfg, dom, "cpu", store_dtype=store_dtype)
    pair = sh.make_sharded_fused_pair2_aa(cfg, dom, plan, store_dtype=store_dtype)
    f = seeded_f(cfg, m.shape)
    f1 = to_storage(f, store_dtype)
    fp = pair.pad(plan.shard_field(f, like_f=True))
    spare = fp.empty_like()
    for _ in range(n_pairs):
        f1, r1, u1 = one(f1, NU, u_in=u_in, force=FORCE)
        fN, rN, uN = pair(fp, NU, u_in=u_in, force=FORCE, out=spare)
        fp, spare = fN, fp
    assert fp.dtype == f1.dtype
    assert torch.equal(pair.unpad(fp).gather(), from_storage(f1, cfg.compute_dtype))
    assert torch.equal(rN.gather(), r1) and torch.equal(uN.gather(), u1)
    assert pair.local_step.plain_calls == n_pairs * plan.n_shards
    return pair


# ------------------------------------------------- the pair against the pair

@pytest.mark.parametrize("store", ("f32", "f16", "bf16", "f64"))
def test_sharded_pair_on_sim2_map_equals_unsharded(store):
    """sim_2's duct (B1) on a 2 x 2 plan in each store dtype, and float64:
    bit for bit the unsharded pair."""
    m, periodic = duct_map()
    cfg = cum_well("float64" if store == "f64" else "float32")
    pair = pairs_vs_unsharded(cfg, m, periodic, (2, 2, 1), STORES.get(store))
    assert pair.local_step.kernel.name.startswith("aa_pair_halo_")


@pytest.mark.parametrize("counts", ((2, 2, 1), (4, 2, 1)), ids=("x2y2", "x4y2"))
def test_sharded_pair_on_sim1_map_equals_unsharded(counts):
    """sim_1's A-A channel (B1b: CUM with eq_inv_cum, the inflow, the
    outflow pulls across the x seams) bit for bit the unsharded pair."""
    m, periodic = sim1_map()
    cfg = interop.config_from_spec("CUM", "EQ_INV_CUM", False, "AA")
    pair = pairs_vs_unsharded(cfg, m, periodic, counts, u_in=U_IN)
    assert pair.local_step.kernel.name == "aa_pair_full_halo"


def test_sharded_pair_halo_is_refreshed_and_never_written():
    """A call writes the interiors of ``out`` and leaves its halo; the next
    call's exchange refreshes the input's halo, so junk there never reaches
    the result; the pair's slabs per pair."""
    m, periodic = duct_map()
    cfg = cum_well()
    dom = interop.domain_from_numpy(m, periodic)
    plan = cpu_plan((2, 2, 1))
    pair = sh.make_sharded_fused_pair2_aa(cfg, dom, plan)
    fp = pair.pad(plan.shard_field(seeded_f(cfg, SHAPE), like_f=True))
    clean, _, _ = pair(fp, NU, force=FORCE)
    for b in fp.blocks:
        b[:, :2] = 9.0
        b[:, :, -2:] = -9.0
    out = fp.map(lambda b: torch.full_like(b, 7.0))
    got, _, _ = pair(fp, NU, force=FORCE, out=out)
    assert got is out
    for a, b in zip(got.blocks, clean.blocks):
        assert torch.equal(a[:, 2:-2, 2:-2], b[:, 2:-2, 2:-2])
        assert bool((a[:, :2] == 7.0).all()) and bool((a[:, :, -2:] == 7.0).all())
    Xl, Yl, Z = plan.local_shape(dom)
    traffic = pair_halo_traffic(dom, plan, itemsize=2)
    assert traffic.bytes_per_step_per_device == 2 * 27 * 2 * ((Yl + 4) + (Xl + 4)) * Z * 2
    assert "MB/pair/device" in traffic.log_line(4, 1.0)


# -------------------------------------------------- against the JAX package

def _jax_duct(dtype=jnp.float32):
    m, periodic = duct_map()
    jdom = JDomain(lat=JD3Q27, units=JLattice(SHAPE, (0, 0, 0), 1.0, 1.0), map=m,
                   periodic=periodic)
    jcfg = JConfig(lat=JD3Q27, collision=jcol.collide_cum_well, eq=jeq.eq_well, well=True,
                   streaming="AA", compute_dtype=dtype)
    return jdom, jcfg


def test_sharded_pair_two_pairs_equal_jax_make_step():
    """Two sharded pairs on a 4 x 2 plan against four JAX ``make_step`` A-A
    steps on one device, within 1e-6 / 2e-6 / 1e-6."""
    jdom, jcfg = _jax_duct()
    m, periodic = duct_map()
    cfg = cum_well()
    dom = interop.domain_from_numpy(m, periodic)
    plan = cpu_plan((4, 2, 1))
    pair = sh.make_sharded_fused_pair2_aa(cfg, dom, plan)
    f0 = seeded_f(cfg, SHAPE)
    step = jax.jit(jmake_step(jcfg, jdom), static_argnames=("parity",))
    fj = jnp.asarray(f0.numpy())
    for it in range(4):
        fj, rj, uj = step(fj, NU, force=jnp.asarray(FORCE, jnp.float32), parity=it % 2)
    fp = pair.pad(plan.shard_field(f0, like_f=True))
    for _ in range(2):
        fp, rp, up = pair(fp, NU, force=FORCE)
    for a, b, tol in ((pair.unpad(fp).gather(), fj, 1e-6), (rp.gather(), rj, 2e-6),
                      (up.gather(), uj, 1e-6)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=0)


class _Forced(Simulation):
    def body_force(self, t):
        return np.array(FORCE)


@needs_8
@pytest.mark.slow
def test_sharded_pair_equals_jax_sharded_pair_in_interpret_mode():
    """Two sharded pairs on a 4 x 2 plan against the JAX sharded pair
    (``make_sharded_fused_pair2_aa``, its Pallas kernel in interpret mode)
    on the same 4 x 2 mesh, within 1e-6 / 2e-6 / 1e-6."""
    jdom, jcfg = _jax_duct()
    m, periodic = duct_map()
    dom = interop.domain_from_numpy(m, periodic)
    plan = cpu_plan((4, 2, 1))
    jplan = jsh.ShardPlan(mesh=JMesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("x", "y")),
                          spatial_axes=("x", "y", None))
    f0 = seeded_f(cum_well(), SHAPE)
    jpair = jsh.make_sharded_fused_pair2_aa(jcfg, jdom, jplan, tile=(4, 8), tiles_per_program=1)
    jmap = jplan.shard_field(jnp.asarray(m), like_f=False)
    jfp = jsh.to_padded_aa_sharded(jplan.shard_field(jnp.asarray(f0.numpy()), like_f=True),
                                   jplan, jdom)
    run = jax.jit(lambda fp: jpair(fp, jmap, NU, force=jnp.asarray(FORCE, jnp.float32)))
    pair = sh.make_sharded_fused_pair2_aa(cum_well(), dom, plan)
    fp = pair.pad(plan.shard_field(f0, like_f=True))
    for _ in range(2):
        jfp, rj, uj = run(jfp)
        fp, rp, up = pair(fp, NU, force=FORCE)
    fj = jsh.from_padded_aa_sharded(jfp, jplan, jdom)
    for a, b, tol in ((pair.unpad(fp).gather(), fj, 1e-6), (rp.gather(), rj, 2e-6),
                      (up.gather(), uj, 1e-6)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=0)


@needs_8
def test_simulation_pairs_under_plan_equal_per_step_and_jax(tmp_path):
    """``Simulation(plan, pair_dispatch=True)`` on a 4 x 2 plan, 4 steps in
    pairs: the port's per-step sharded run and the JAX ``Simulation(plan,
    use_fused=False)`` on the same 4 x 2 mesh within 1e-6."""
    m, periodic = duct_map()
    dom = interop.domain_from_numpy(m, periodic, phys_viscosity=NU)
    runs = {}
    for name, pair in (("pairs", True), ("steps", False)):
        sim = _Forced(cum_well(), dom, device="cpu", sim_id=name, results_parent=tmp_path,
                      use_fused=True, pair_dispatch=pair, plan=cpu_plan((4, 2, 1)))
        sim.sim_init()
        assert sim._pair_dispatch_ok() == pair
        sim._advance(4)
        assert sim.iterations == 4
        runs[name] = (sim.f.gather(), sim.rho, sim.u)
        if pair:
            assert sim._pair.local_step.plain_calls == 2 * 8
    for a, b in zip(runs["pairs"], runs["steps"]):
        assert float((a - b).abs().max()) <= 1e-6

    jdom, jcfg = _jax_duct()
    jdom = JDomain(lat=JD3Q27, units=JLattice(SHAPE, (0, 0, 0), 1.0, 1.0, phys_viscosity=NU),
                   map=m, periodic=periodic)
    mesh = JMesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("x", "y"))

    class JForced(JSimulation):
        def body_force(self, t):
            return np.array(FORCE)

    jsim = JForced(jcfg, jdom, sim_id="jax", results_parent=tmp_path,
                   plan=jsh.ShardPlan(mesh=mesh, spatial_axes=("x", "y", None)), use_fused=False)
    jsim.sim_init()
    jsim._advance(4)
    np.testing.assert_allclose(runs["pairs"][0].numpy(), np.asarray(jsim.f), atol=1e-6, rtol=0)
    np.testing.assert_allclose(runs["pairs"][2].numpy(), np.asarray(jsim.u), atol=1e-6, rtol=0)


@needs_8
@pytest.mark.parametrize("store", ("f32", "f16", "bf16"))
def test_layout_helpers_equal_jax_on_the_interior(store):
    """``to_padded_aa_sharded`` / ``from_padded_aa_sharded`` on a 2 x 2 plan
    against the JAX helpers (whose blocks carry a y pad of 8) on every
    block's interior, narrowed and widened alike."""
    m, periodic = duct_map()
    jdom, _ = _jax_duct()
    dom = interop.domain_from_numpy(m, periodic)
    plan = cpu_plan((2, 2, 1))
    jplan = jsh.ShardPlan(mesh=JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("x", "y")),
                          spatial_axes=("x", "y", None))
    f0 = seeded_f(cum_well(), SHAPE)
    jstore = {"f32": None, "f16": jnp.float16, "bf16": jnp.bfloat16}[store]
    jpad = np.asarray(jsh.to_padded_aa_sharded(jplan.shard_field(jnp.asarray(f0.numpy()),
                                                                 like_f=True),
                                               jplan, jdom, store_dtype=jstore).astype(jnp.float32))
    pad = sh.to_padded_aa_sharded(plan.shard_field(f0, like_f=True), plan, dom, STORES[store])
    Xl, Yl, Z = plan.local_shape(dom)
    for k, b in enumerate(pad.blocks):
        i, j, _ = plan.block_index(k)
        jb = jpad[:, i * (Xl + 4) + 2: i * (Xl + 4) + 2 + Xl,
                  j * (Yl + 16) + 8: j * (Yl + 16) + 8 + Yl, :Z]
        assert b.dtype == (STORES[store] or torch.float32)
        np.testing.assert_array_equal(b[:, 2:-2, 2:-2].float().numpy(), jb)
    back = sh.from_padded_aa_sharded(pad, plan, dom, dtype=torch.float32).gather()
    jback = jsh.from_padded_aa_sharded(
        jsh.to_padded_aa_sharded(jplan.shard_field(jnp.asarray(f0.numpy()), like_f=True),
                                 jplan, jdom, store_dtype=jstore), jplan, jdom,
        dtype=jnp.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


# ------------------------------------------------------------- checkpoints

def test_checkpoint_in_pairs_resumes_per_step_unsharded(tmp_path):
    """4 steps in pairs on a 2 x 2 plan, saved in the JAX shard layout
    (a file per shard), resumed unsharded per step for 4 more: bit for bit
    8 uninterrupted unsharded steps."""
    m, periodic = duct_map()
    dom = interop.domain_from_numpy(m, periodic, phys_viscosity=NU)

    def sim(run, plan, pair):
        return _Forced(cum_well(), dom, device="cpu", sim_id="ckpt", results_parent=run,
                       use_fused=True, pair_dispatch=pair, plan=plan)

    ref = sim(tmp_path / "ref", None, False)
    ref.sim_init()
    ref._advance(8)
    first = sim(tmp_path / "run", cpu_plan((2, 2, 1)), True)
    first.sim_init()
    first._advance(4)
    assert first._pair.local_step.plain_calls == 2 * 4
    first.save_state()
    assert len(list(first.results_dir.glob("checkpoint_shard*.npz"))) == 4
    second = sim(tmp_path / "run", None, False)
    second.sim_init()
    assert second.iterations == 4 and not second._pair_dispatch_ok()
    second._advance(4)
    assert torch.equal(second.f, ref.f) and torch.equal(second.u, ref.u)


# ---------------------------------------------------------------- refusals

def test_sharded_pair_refuses_what_is_not_ported():
    """z meshes, plans that do not divide the lattice and B1b's family
    collisions raise naming A13b; "auto" under a plan stays per step on the
    CPU."""
    m, periodic = duct_map()
    dom = interop.domain_from_numpy(m, periodic)
    with pytest.raises(NotImplementedError, match="A13b"):
        sh.make_sharded_fused_pair2_aa(cum_well(), dom, cpu_plan((1, 1, 2)))
    with pytest.raises(NotImplementedError, match="A13b"):
        sh.make_sharded_fused_pair2_aa(cum_well(), dom, cpu_plan((3, 1, 1)))
    with pytest.raises(NotImplementedError, match="A13b"):
        sh.to_padded_aa_sharded(None, cpu_plan((1, 2, 2)), dom)
    srt = interop.config_from_spec("SRT", "EQ", False, "AA")
    with pytest.raises(NotImplementedError, match="A13b"):
        sh.make_sharded_fused_pair2_aa(srt, dom, cpu_plan((2, 1, 1)))
    with pytest.raises(NotImplementedError, match="A13b"):
        make_fused_pair_aa(srt, dom, "cpu", prepadded=True, local_shape=(8, 16, 8))
    auto = _Forced(cum_well(), interop.domain_from_numpy(m, periodic, phys_viscosity=NU),
                   device="cpu", sim_id="auto", results_parent=tempfile.mkdtemp(),
                   use_fused=True, pair_dispatch="auto", plan=cpu_plan((2, 2, 1)))
    auto.sim_init()
    assert auto.pair_dispatch is False and auto._pair is None  # per step on the CPU
