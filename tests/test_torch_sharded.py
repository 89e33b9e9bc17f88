"""The sharded lattice of the port (``tnl_lbm_tpu_torch/parallel``) against the
JAX package's (``tnl_lbm_tpu/parallel/sharded.py``) and against the port's
own one-device steps, on the CPU.

The port's plans here put N shards on N x ``cpu``, as the JAX side runs on
8 virtual CPU devices (tests/conftest.py).  Held:

- ``choose_plan``'s shard counts equal JAX's over shapes, device counts and
  periodic flags;
- ``_halo_exchange`` equals JAX's, w = 1 and 2, periodic and not;
- the plain ``make_sharded_step`` equals JAX ``make_sharded_step`` on the
  same mesh in float64 within 1e-12 (tests/test_sharded.py:24-53, :72, :84);
- the kernels' sharded steps, through the haloed plain versions, equal the
  port's unsharded kernel steps bit for bit on sim_2's and sim_1's maps;
  the uneven A-B step too, pad-1 periodic included; uneven A-A raises;
- sim_2's ``build`` sizes each scaling as JAX's does; ``sim_1 --sharded`` and
  ``sim_2 --sharded`` on two shards equal the unsharded runs;
- sharded checkpoints in the JAX layout cross between the packages and
  between sharded and unsharded runs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from tnl_lbm_tpu.apps import sim_2 as jsim_2
from tnl_lbm_tpu.models import D2Q9 as JD2Q9
from tnl_lbm_tpu.models import D3Q27 as JD3Q27
from tnl_lbm_tpu.ops import collision as jcol
from tnl_lbm_tpu.ops import equilibrium as jeq
from tnl_lbm_tpu.parallel import sharded as jsh
from tnl_lbm_tpu.sim import Domain as JDomain
from tnl_lbm_tpu.sim import LBMConfig as JConfig
from tnl_lbm_tpu.sim import checkpoint as jckpt
from tnl_lbm_tpu.utils import Lattice as JLattice
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.apps import sim_1, sim_2
from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa
from tnl_lbm_tpu_torch.models import D2Q9, D3Q27
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.parallel import sharded as sh
from tnl_lbm_tpu_torch.parallel.profiling import halo_traffic, predicted_weak_scaling
from tnl_lbm_tpu_torch.sim import checkpoint as ckpt
from tnl_lbm_tpu_torch.sim import make_step
from tnl_lbm_tpu_torch.sim.config import Domain
from tnl_lbm_tpu_torch.utils.units import Lattice

NU = 0.02
NAMES = ("x", "y", "z")
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
    u = torch.from_numpy(0.02 * rng.standard_normal((cfg.lat.D,) + shape))
    return cfg.eq(cfg.lat, rho, u).to(cfg.compute_dtype).contiguous()


# ------------------------------------------------------------------ the plan

PLAN_SHAPES = (((32, 256, 256), (True, False, False)), ((128, 32, 32), (False, False, False)),
               ((30, 14, 9), (True, True, False)), ((7, 13, 5), (False, True, True)),
               ((64, 32), (False, True)))


@needs_8
@pytest.mark.parametrize("n", (1, 2, 3, 4, 6, 8))
@pytest.mark.parametrize("shape,periodic", PLAN_SHAPES)
def test_choose_plan_counts_equal_jax(shape, periodic, n):
    """Same device count, weights (1, 8, 64) and allow_z=False: same mesh."""
    jlat, lat = (JD3Q27, D3Q27) if len(shape) == 3 else (JD2Q9, D2Q9)
    m = np.zeros(shape, np.uint8)
    jdom = JDomain(lat=jlat, units=JLattice(shape, (0,) * len(shape), 1.0, 1.0), map=m,
                   periodic=periodic)
    dom = Domain(lat=lat, units=Lattice(shape, (0,) * len(shape), 1.0, 1.0), map=m,
                 periodic=periodic)
    jplan = jsh.choose_plan(jdom, jax.devices()[:n])
    plan = sh.choose_plan(dom, ["cpu"] * n)
    want = tuple(jplan.mesh.shape[a] if a is not None else 1 for a in jplan.spatial_axes)
    assert plan.counts == want
    assert plan.padded_shape(dom) == jplan.padded_shape(jdom)
    assert plan.local_shape(dom) == jplan.local_shape(jdom)


@needs_8
@pytest.mark.parametrize("w", (1, 2))
@pytest.mark.parametrize("per", (False, True))
def test_halo_exchange_equals_jax(per, w):
    """Each shard's padded block along x (4 shards), y (2 shards) and z
    (one shard: the local wrap or edge pad) against JAX ``_halo_exchange``
    inside shard_map, the padded blocks laid side by side."""
    from jax import shard_map

    rng = np.random.default_rng(3)
    f = rng.standard_normal((3, 8, 6, 5))
    mesh = JMesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("x", "y"))
    plan = cpu_plan((4, 2, 1), ("x", "y", None))
    blocks = plan.shard_field(f, like_f=True).blocks
    for adim, name in ((1, "x"), (2, "y"), (3, None)):
        jout = shard_map(lambda b: jsh._halo_exchange(mesh, b, adim, name, per, w), mesh=mesh,
                         in_specs=P(None, "x", "y"), out_specs=P(None, "x", "y"),
                         check_vma=False)(jnp.asarray(f))
        padded = sh._halo_exchange(plan, blocks, adim, adim - 1, per, w)
        rows = [np.concatenate([padded[plan.shard_at((i, j, 0))].numpy() for j in range(2)],
                               axis=2) for i in range(4)]
        np.testing.assert_array_equal(np.concatenate(rows, axis=1), np.asarray(jout))


# ------------------------------------------------- the plain sharded step

def _jax_vs_port(jcfg, cfg, m, periodic, counts, n_steps, parities, force=None, u_in=None):
    jdom = JDomain(lat=JD3Q27, units=JLattice(m.shape, (0, 0, 0), 1.0, 1.0), map=m,
                   periodic=periodic)
    dom = interop.domain_from_numpy(m, periodic)
    names = tuple(a for a, n in zip(NAMES, counts) if n > 1)
    axes = tuple(a if n > 1 else None for a, n in zip(NAMES, counts))
    n_dev = int(np.prod(counts))
    jmesh = JMesh(np.asarray(jax.devices()[:n_dev]).reshape([n for n in counts if n > 1]), names)
    jplan = jsh.ShardPlan(mesh=jmesh, spatial_axes=axes)
    jstep = jsh.make_sharded_step(jcfg, jdom, jplan)
    plan = cpu_plan(counts, axes)
    step = sh.make_sharded_step(cfg, dom, plan)
    f0 = seeded_f(cfg, m.shape).numpy()
    fj = jplan.shard_field(jnp.asarray(f0), like_f=True)
    mj = jplan.shard_field(jnp.asarray(m), like_f=False)
    fp = plan.shard_field(f0, like_f=True)
    fvec = None if force is None else np.asarray(force)
    jforce = None if fvec is None else jnp.asarray(fvec)
    juin = None if u_in is None else jnp.asarray(np.asarray(u_in))
    jitted = {p: jax.jit(lambda f, p=p: jstep(f, mj, NU, u_in=juin, force=jforce, parity=p))
              for p in (0, 1)}
    for it in range(n_steps):
        p = it % 2 if parities else 0
        fj, rj, uj = jitted[p](fj)
        fp, rp, up = step(fp, NU, u_in=u_in, force=fvec, parity=p)
    for a, b in ((fp, fj), (rp, rj), (up, uj)):
        np.testing.assert_allclose(a.gather().numpy(), np.asarray(b), atol=1e-12, rtol=0)


@needs_8
def test_plain_sharded_step_periodic_box_equals_jax():
    """tests/test_sharded.py:72: the periodic box on a 4 x 2 mesh, SRT, a force."""
    m = np.zeros((8, 8, 8), np.uint8)
    jcfg = JConfig(lat=JD3Q27, collision=jcol.collide_srt, compute_dtype=jnp.float64)
    cfg = interop.config_from_spec("SRT", "EQ", False, "AB", dtype="float64")
    _jax_vs_port(jcfg, cfg, m, (True,) * 3, (4, 2, 1), 4, False, force=[1e-5, 0.0, 0.0])


@needs_8
def test_plain_sharded_step_aa_parities_equal_jax():
    """tests/test_sharded.py:84: A-A parities on a 2 x 2 x 2 mesh, SRT."""
    m = np.zeros((8, 8, 8), np.uint8)
    jcfg = JConfig(lat=JD3Q27, collision=jcol.collide_srt, streaming="AA",
                   compute_dtype=jnp.float64)
    cfg = interop.config_from_spec("SRT", "EQ", False, "AA", dtype="float64")
    _jax_vs_port(jcfg, cfg, m, (True,) * 3, (2, 2, 2), 4, True)


@needs_8
def test_plain_sharded_step_walled_cumulant_equals_jax():
    """A duct with walls, NOTHING layers and an inflow/outflow pair, CUM with
    eq_inv_cum on a 2 x 2 mesh: the direction-subset exchange and the
    outflow's x-1 pull across the x seam."""
    m = np.zeros((8, 8, 6), np.uint8)
    m[:, 1] = m[:, -2] = GEO.WALL
    m[:, 0] = m[:, -1] = GEO.NOTHING
    m[0, 2:-2] = GEO.INFLOW_LEFT
    m[-1, 2:-2] = GEO.OUTFLOW_RIGHT
    jcfg = JConfig(lat=JD3Q27, collision=jcol.collide_cum, eq=jeq.eq_inv_cum,
                   compute_dtype=jnp.float64)
    cfg = interop.config_from_spec("CUM", "EQ_INV_CUM", False, "AB", dtype="float64")
    _jax_vs_port(jcfg, cfg, m, (False, False, True), (2, 2, 1), 3, False,
                 force=[1e-5, 0.0, 0.0], u_in=[0.01, 0.0, 0.0])


# ---------------------------------------------- the kernels' sharded steps

def _duct(X, Y):
    """sim_2's forced duct map (NOTHING ring, WALL planes, periodic x)."""
    m = np.zeros((X, Y, Y), np.uint8)
    m[:, 1] = m[:, -2] = GEO.WALL
    m[:, :, 1] = m[:, :, -2] = GEO.WALL
    m[:, 0] = m[:, -1] = GEO.NOTHING
    m[:, :, 0] = m[:, :, -1] = GEO.NOTHING
    return m, (True, False, False)


def _sim1_map(tmp_path):
    """sim_1's channel at resolution 1 (128 x 32 x 32: the inflow, the
    outflow, the wall with a hole, the NOTHING ring)."""
    sim = sim_1.build(1, device="cpu", results_parent=tmp_path)
    return sim.domain.map, sim.domain.periodic


def _kernel_vs_sharded(cfg, m, periodic, counts, n_steps, u_in=(0.01, 0.0, 0.0)):
    dom = interop.domain_from_numpy(m, periodic)
    plan = cpu_plan(counts)
    if cfg.streaming == "AB":
        one, sharded = make_fused_step(cfg, dom, "cpu"), sh.make_sharded_fused_step(cfg, dom, plan)
    else:
        one = make_fused_step_aa(cfg, dom, "cpu")
        sharded = sh.make_sharded_fused_step_aa(cfg, dom, plan)
    f1 = seeded_f(cfg, m.shape)
    fN = plan.shard_field(f1, like_f=True)
    for it in range(n_steps):
        p = it % 2 if cfg.streaming == "AA" else 0
        f1, r1, u1 = one(f1, NU, u_in=u_in, force=(1e-5, 0.0, 0.0), parity=p)
        fN, rN, uN = sharded(fN, NU, u_in=u_in, force=(1e-5, 0.0, 0.0), parity=p)
    for a, b in ((fN, f1), (rN, r1), (uN, u1)):
        assert torch.equal(a.gather(), b)
    return sharded


@pytest.mark.parametrize("streaming", ("AB", "AA"))
@pytest.mark.parametrize("counts", ((1, 2, 1), (2, 2, 1)))
def test_sharded_kernel_steps_on_sim2_map_bit_for_bit(streaming, counts):
    """sim_2's duct (CUM_WELL; the odd step's lean instance) on y and x/y
    plans through the haloed plain versions: bit for bit the unsharded
    kernel steps' plain versions, with the launches counted as plain calls."""
    m, periodic = _duct(8, 16)
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, streaming)
    step = _kernel_vs_sharded(cfg, m, periodic, counts, 4)
    assert step.local_step.plain_calls == 4 * int(np.prod(counts))
    if streaming == "AA":
        assert step.local_step.odd.name == "aa_odd_halo" and step.local_step.variant == 3


@pytest.mark.parametrize("streaming", ("AB", "AA"))
def test_sharded_kernel_steps_on_sim1_map_bit_for_bit(streaming, tmp_path):
    """sim_1's channel (CUM, eq_inv_cum, inflow, OUTFLOW_RIGHT across the x
    seams) on a 2 x 2 plan."""
    m, periodic = _sim1_map(tmp_path)
    m = np.ascontiguousarray(m[::4])  # 32 x 32 x 32 with the wall, inflow and outflow
    m[0, 1:-1, 1:-1][m[0, 1:-1, 1:-1] == GEO.WALL] = GEO.INFLOW_LEFT
    cfg = interop.config_from_spec("CUM", "EQ_INV_CUM", False, streaming)
    _kernel_vs_sharded(cfg, m, periodic, (2, 2, 1), 2)


def test_sharded_kernel_steps_refuse_what_is_not_ported():
    m, periodic = _duct(8, 8)
    dom = interop.domain_from_numpy(m, periodic)
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AB")
    with pytest.raises(NotImplementedError, match="A13b"):
        sh.make_sharded_fused_step(cfg, dom, cpu_plan((1, 1, 2)))
    with pytest.raises(NotImplementedError, match="A13b"):
        sh.make_sharded_fused_step(interop.config_from_spec("SRT", "EQ", False, "AB"), dom,
                                   cpu_plan((2, 1, 1)))
    aa = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AA", dtype="float64")
    with pytest.raises(NotImplementedError, match="A13b"):
        sh.make_sharded_fused_step_aa(aa, dom, cpu_plan((2, 1, 1)))
    with pytest.raises(NotImplementedError, match="A13b"):
        sh.make_sharded_fused_step_aa(dataclasses.replace(cfg, streaming="AA"), dom,
                                      cpu_plan((2, 1, 1)), force_field=True)


@pytest.mark.parametrize("shape,counts,periodic", (
    ((7, 12, 6), (4, 1, 1), (True, False, False)),     # pad 1 on a periodic axis
    ((9, 10, 6), (2, 3, 1), (True, False, True)),
    ((10, 7, 6), (3, 2, 1), (False, True, False))))
def test_uneven_ab_step_equals_unsharded(shape, counts, periodic):
    """A lattice the plan does not divide pads and crops: the kernels'
    uneven step bit for bit the unsharded kernel step (float32), the plain
    uneven step within 1e-12 of the plain step (float64: torch's CPU
    reductions may add in another order on another block shape)."""
    m = np.zeros(shape, np.uint8)
    if not periodic[1]:
        m[:, 0] = m[:, -1] = GEO.WALL
    if not periodic[0]:
        m[0], m[-1] = GEO.INFLOW_LEFT, GEO.OUTFLOW_RIGHT
    dom = interop.domain_from_numpy(m, periodic)
    plan = cpu_plan(counts)
    assert not plan.divisible(dom)
    for dt in ("float32", "float64"):
        cfg = interop.config_from_spec("CUM", "EQ_INV_CUM", False, "AB", dtype=dt)
        if dt == "float32":
            one = make_fused_step(cfg, dom, "cpu")
            step = sh._make_uneven_sharded_step(cfg, dom, plan,
                                                inner_builder=sh.make_sharded_fused_step)
        else:
            one, step = make_step(cfg, dom), sh.make_sharded_step(cfg, dom, plan)
        f1 = seeded_f(cfg, shape)
        fN = plan.shard_field(f1, like_f=True, padded_shape=step.padded_shape)
        for _ in range(3):
            f1, r1, u1 = one(f1, NU, u_in=[0.01, 0.0, 0.0], force=[1e-5, 0.0, 0.0])
            fN, rN, uN = step(fN, NU, u_in=[0.01, 0.0, 0.0], force=[1e-5, 0.0, 0.0])
        for a, b in ((fN, f1), (rN, r1), (uN, u1)):
            if dt == "float32":
                assert torch.equal(a.gather(), b)
            else:
                np.testing.assert_allclose(a.gather().numpy(), b.numpy(), atol=1e-12, rtol=0)
    aa = interop.config_from_spec("CUM", "EQ_INV_CUM", False, "AA")
    with pytest.raises(NotImplementedError, match="A-B streaming"):
        sh.make_sharded_step(aa, dom, plan)


def test_halo_traffic_counts_the_cut_faces():
    """The bytes of the y cut, all components and the 9 that cross it, and
    the weak-scaling model on them: the slabs' link time against a step."""
    m, periodic = _duct(32, 256)
    dom = interop.domain_from_numpy(m, periodic)
    plan = cpu_plan((1, 2, 1))
    ht = halo_traffic(dom, plan, subset=False)
    assert ht.bytes_per_step_per_device == 2 * 27 * 32 * 256 * 4
    assert ht.messages_per_step_per_device == 2 and ht.n_devices == 2
    assert halo_traffic(dom, plan).bytes_per_step_per_device == 2 * 9 * 32 * 256 * 4
    t_halo = 2 * 9 * 32 * 256 * 4 / 450e9
    assert predicted_weak_scaling(dom, plan, 1e-3) == 1.0
    assert predicted_weak_scaling(dom, plan, 1e-3, overlapped=False) == \
        pytest.approx(1e-3 / (1e-3 + t_halo))
    assert predicted_weak_scaling(dom, plan, t_halo / 2) == pytest.approx(0.5)


# ------------------------------------------------------------------ the apps

@pytest.mark.parametrize("n", (1, 2, 4, 8))
@pytest.mark.parametrize("scaling", ("strong", "weak_1d", "weak_3d"))
def test_sim2_scaling_sizes_equal_jax(scaling, n, tmp_path):
    """sim_2's build per scaling and device count: the lattice, its
    periodic axes, sim_id, the PRINT/PROBE1 periods and the final time."""
    j = jsim_2.build(2, scaling=scaling, n_devices=n, results_parent=tmp_path / "jax")
    p = sim_2.build(2, device="cpu", scaling=scaling, n_devices=n,
                    results_parent=tmp_path / "port")
    assert p.domain.shape == j.domain.shape and p.domain.periodic == j.domain.periodic
    assert p.id == j.id
    assert p.phys_final_time == j.phys_final_time
    for name in ("print", "probe1"):
        assert p.cnt[name].period == j.cnt[name].period


def _run(sim):
    sim.run()
    return sim


def test_sim2_sharded_equals_unsharded(tmp_path):
    """sim_2 res 1 --sharded --use-fused on two CPU shards (choose_plan cuts
    x at this size), A-B and A-A, 20 steps each: the same fields and L1 as
    the unsharded runs, through the haloed plain versions."""
    for streaming in ("AB", "AA"):
        kw = dict(device="cpu", final_time=0.08, streaming=streaming, use_fused=True)
        one = _run(sim_2.build(1, results_parent=tmp_path / f"one{streaming}", **kw))
        two = _run(sim_2.build(1, results_parent=tmp_path / f"two{streaming}", sharded=True,
                               devices=["cpu", "cpu"], n_devices=2, **kw))
        assert two.plan.counts == (2, 1, 1) and two.iterations == one.iterations == 20
        assert torch.equal(two.f.gather(), one.f) and torch.equal(two.u, one.u)
        assert two.last_errors == one.last_errors
        assert two._step.local_step.plain_calls == 2 * 20  # a launch a shard and step


def test_sim1_sharded_equals_unsharded(tmp_path):
    """sim_1 res 1 --sharded --streaming AA on two CPU shards, 10 steps
    (B2, and B3 on haloed blocks): the unsharded run's fields; the VTK
    cuts read the gathered fields."""
    kw = dict(device="cpu", final_time=0.001, streaming="AA", use_fused=True)
    one = _run(sim_1.build(1, results_parent=tmp_path / "one", **kw))
    two = _run(sim_1.build(1, results_parent=tmp_path / "two", sharded=True,
                           devices=["cpu", "cpu"], **kw))
    assert two.plan.counts == (2, 1, 1) and two.iterations == one.iterations == 10
    assert torch.equal(two.f.gather(), one.f)
    assert torch.equal(two.rho, one.rho) and torch.equal(two.u, one.u)
    cut = "vtk2D/cut_Z_000000.vti"
    assert (two.results_dir / cut).read_bytes() == (one.results_dir / cut).read_bytes()


# ------------------------------------------------------------- checkpoints

def _duct_sim(tmp_path, sim_id, plan=None, use_fused=True):
    sim = sim_2.build(1, device="cpu", results_parent=tmp_path, streaming="AB",
                      use_fused=use_fused)
    sim = sim_2.Sim2(sim.cfg, sim.domain, device="cpu", sim_id=sim_id, results_parent=tmp_path,
                     fx_lbm=sim.fx_lbm, analytical=sim.analytical, use_fused=use_fused,
                     plan=plan, steps_per_dispatch=4)
    sim.collect_stats = True
    return sim


def test_port_sharded_checkpoint_loads_in_jax(tmp_path):
    """A sharded run's save writes the JAX layout (a shard file per shard,
    ``__shards__``); the JAX loader reassembles the gathered state and
    statistics."""
    sim = _duct_sim(tmp_path, "port", plan=cpu_plan((2, 1, 1)))
    sim.sim_init()
    sim._advance(4)
    sim.save_state()
    files = sorted(p.name for p in sim.results_dir.glob("checkpoint_shard*.npz"))
    assert len(files) == 2 and files[0].startswith("checkpoint_shard000_")
    arrays, meta = jckpt.load_checkpoint(sim.results_dir)
    np.testing.assert_array_equal(arrays["f"], sim.f.gather().numpy())
    np.testing.assert_array_equal(arrays["vm"], sim.vm.gather().numpy())
    assert meta["iterations"] == 4
    ported, _ = ckpt.load_checkpoint(sim.results_dir)
    np.testing.assert_array_equal(ported["f"], arrays["f"])


@needs_8
def test_jax_sharded_checkpoint_resumes_sharded(tmp_path):
    """A JAX save on 8 virtual devices resumes a port run on two shards."""
    sim = _duct_sim(tmp_path, "jax", plan=cpu_plan((1, 2, 1)))
    f0 = seeded_f(sim.cfg, sim.domain.shape).numpy()
    mesh = JMesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("x", "y"))
    jckpt.save_checkpoint(sim.results_dir,
                          {"f": jax.device_put(jnp.asarray(f0), NamedSharding(mesh, P(None, "x",
                                                                                       "y")))},
                          {"iterations": 6, "stat_counter": 0, "stat2_counter": 0,
                           "counters": {}, "probe_cycles": {}})
    sim.flags.create("loadstate")
    sim.sim_init()
    assert sim.iterations == 6 and isinstance(sim.f, sh.ShardedField)
    np.testing.assert_array_equal(sim.f.gather().numpy(), f0)


def test_resume_sharded_to_unsharded_and_back(tmp_path):
    """4 steps sharded, save; resume unsharded for 4, save; resume sharded
    for 4: bit for bit 12 uninterrupted unsharded steps, statistics too."""
    ref = _duct_sim(tmp_path / "ref", "run")
    ref.sim_init()
    ref._advance(12)
    run = tmp_path / "resume"
    for plan in (cpu_plan((2, 1, 1)), None, cpu_plan((1, 2, 1))):
        sim = _duct_sim(run, "run", plan=plan)
        sim.sim_init()
        sim._advance(4)
        sim.save_state()
    assert sim.iterations == 12
    assert torch.equal(sim.f.gather(), ref.f) and torch.equal(sim.u, ref.u)
    assert torch.equal(sim.vm.gather(), ref.vm) and torch.equal(sim.vm2.gather(), ref.vm2)
