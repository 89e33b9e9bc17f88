"""The sharded 2D and coupled lattices of the port (``parallel/sharded.py``
``make_sharded_fused_step_2d``, ``make_sharded_ade_step``,
``make_sharded_fused_ade_step``; ``CoupledSimulation(plan=...)``) against
the JAX package's and against the port's own one-device steps, on the CPU.

The plans put N shards on N x ``cpu`` (``cpu_plan``, as in
tests/test_torch_sharded.py); the JAX side runs on the conftest's 8
virtual CPU devices.  Held:

- the plain ``make_sharded_ade_step`` equals JAX ``make_sharded_ade_step``
  on the same mesh in float64 within 1e-12: sim_coupled's ADE map, a map
  with TRANSFER codes, a per-site diffusion field, A-B and A-A;
- the sharded D2Q9 step (B5 halo) and the sharded ADE step (B6 halo),
  through their haloed plain versions, equal the port's unsharded B5 and
  B6 steps bit for bit on 1, 2 (x), 2 (y) and 2 x 2 shards, with seams
  through the Bouzidi ring and through the WALL_BODY rows; the uneven 2D
  step too, a pad of one on a periodic axis included;
- ``sim2d_1``, ``sim2d_2``, ``sim2d_3`` and ``sim_coupled`` ``--sharded`` on
  two CPU shards equal their unsharded runs;
- a sharded coupled checkpoint (f and g) loads in JAX, and a JAX one
  resumes in the port;
- the refusals: ``use_fused`` A-A coupled under a plan (ROADMAP §C), the
  z cuts of the kernel steps (A13b), the plain step's OUTFLOW_PE rules; a
  hook under a plan takes the sharded hooked steps.

``-m slow`` holds the sharded kernel steps to the JAX fused sharded steps
in Pallas interpret mode.
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

from tnl_lbm_tpu.models import D2Q9 as JD2Q9
from tnl_lbm_tpu.models import D3Q7 as JD3Q7
from tnl_lbm_tpu.ops import collision_2d as jcol2
from tnl_lbm_tpu.ops import collision_ade as jcade
from tnl_lbm_tpu.parallel import sharded as jsh
from tnl_lbm_tpu.sim import Domain as JDomain
from tnl_lbm_tpu.sim import LBMConfig as JConfig
from tnl_lbm_tpu.sim import checkpoint as jckpt
from tnl_lbm_tpu.utils import Lattice as JLattice
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.apps import sim2d_1, sim2d_2, sim2d_3, sim_coupled
from tnl_lbm_tpu_torch.kernels.fused_2d import make_fused_step_2d
from tnl_lbm_tpu_torch.kernels.fused_ade import make_fused_ade_step
from tnl_lbm_tpu_torch.models import D2Q9, D3Q7
from tnl_lbm_tpu_torch.ops import collision_2d as col2
from tnl_lbm_tpu_torch.ops import collision_ade as cade
from tnl_lbm_tpu_torch.parallel import sharded as sh
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.step_ade import ADEGEO, transfer_direction_flags
from tnl_lbm_tpu_torch.utils.units import Lattice

from test_torch_sharded import cpu_plan
from torch_cases import FORCE_2D, ade_box, ade_case, case_2d, parabolic_2d, seeded_2d, seeded_ade

NU = 0.02
PHI_IN, TCOEF = 0.7, 0.3
COUNTS_2D = ((1, 1), (2, 1), (1, 2), (2, 2))
COUNTS_3D = tuple(c + (1,) for c in COUNTS_2D)
needs_8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(sim):
    sim.run()
    return sim


# ------------------------------------------------- the plain sharded ADE step

def _ade_transfer_map(shape=(8, 16, 8)):
    """``ade_box`` with OUTFLOW_RIGHT for its OUTFLOW_PE, so that y may shard:
    WALL and WALL_BODY rows, symmetry planes, a solid slab behind the three
    TRANSFER codes, a PERIODIC block and a NOTHING site."""
    m = ade_box(shape)
    m[m == ADEGEO.OUTFLOW_PE] = ADEGEO.OUTFLOW_RIGHT
    return m, (False, False, True)


def _sim_coupled_ade_map(shape=(12, 8, 4)):
    """sim_coupled's ADE channel at a small size: WALL_BODY walls on the y
    faces, INFLOW at x = 0, OUTFLOW_PE at x = X-1, periodic z."""
    m, periodic = ade_case("channel", shape)
    return m, periodic


@needs_8
@pytest.mark.parametrize("case,counts,streaming,variable", (
    ("sim_coupled", (2, 1, 1), "AB", False),
    ("sim_coupled", (2, 1, 1), "AB", True),
    ("transfer", (2, 2, 1), "AB", True),
    ("transfer", (1, 2, 1), "AB", False),
    ("transfer", (2, 2, 1), "AA", True)))
def test_plain_sharded_ade_step_equals_jax(case, counts, streaming, variable):
    """Three steps (A-A: both parities) of the plain sharded ADE step on the
    JAX step's mesh, float64, against JAX ``make_sharded_ade_step``."""
    if case == "sim_coupled":
        m, periodic = _sim_coupled_ade_map()
    else:
        m, periodic = _ade_transfer_map()
    if streaming == "AA":
        m = m.copy()
        m[m == ADEGEO.OUTFLOW_RIGHT] = ADEGEO.FLUID  # the JAX A-A outflow reads its own slot
    shape = m.shape
    names = tuple(a for a, n in zip("xyz", counts) if n > 1)
    axes = tuple(a if n > 1 else None for a, n in zip("xyz", counts))
    n_dev = int(np.prod(counts))
    jmesh = JMesh(np.asarray(jax.devices()[:n_dev]).reshape([n for n in counts if n > 1]), names)
    jplan = jsh.ShardPlan(mesh=jmesh, spatial_axes=axes)
    jcfg = JConfig(lat=JD3Q7, collision=jcade.collide_clbm_ade, streaming=streaming,
                   compute_dtype=jnp.float64)
    jdom = JDomain(lat=JD3Q7, units=JLattice(shape, (0, 0, 0), 1.0, 1.0), map=m.copy(),
                   periodic=periodic)
    jstep = jsh.make_sharded_ade_step(jcfg, jdom, jplan)
    cfg = LBMConfig(lat=D3Q7, collision=cade.collide_clbm_ade, streaming=streaming,
                    compute_dtype=torch.float64)
    dom = interop.domain_from_numpy(m, periodic, lat=interop.D3Q7)
    plan = cpu_plan(counts, axes)
    step = sh.make_sharded_ade_step(cfg, dom, plan)
    g0, u0, nu0 = (t.double().numpy() for t in seeded_ade(shape, "cpu"))
    nu_j = jplan.shard_field(jnp.asarray(nu0), like_f=False) if variable else NU
    nu_p = torch.from_numpy(nu0) if variable else NU
    flags = transfer_direction_flags(D3Q7, m)
    gj = jplan.shard_field(jnp.asarray(g0), like_f=True)
    uj = jplan.shard_field(jnp.asarray(u0), like_f=True)
    mj = jplan.shard_field(jnp.asarray(m), like_f=False)
    tj = jplan.shard_field(jnp.asarray(flags), like_f=True)
    gp = plan.shard_field(g0, like_f=True)
    up = plan.shard_field(u0, like_f=True)
    tp = torch.from_numpy(flags)
    jitted = {p: jax.jit(lambda g, p=p: jstep(g, uj, mj, nu_j, phi_in=PHI_IN, transfer_dirs=tj,
                                              transfer_coeff=TCOEF, parity=p))
              for p in (0, 1)}
    for it in range(3):
        parity = it % 2 if streaming == "AA" else 0
        gj, pj = jitted[parity](gj)
        gp, pp = step(gp, up, nu_p, phi_in=PHI_IN, transfer_dirs=tp, transfer_coeff=TCOEF,
                      parity=parity)
    np.testing.assert_allclose(gp.gather().numpy(), np.asarray(gj), atol=1e-12, rtol=0)
    np.testing.assert_allclose(pp.gather().numpy(), np.asarray(pj), atol=1e-12, rtol=0)


def test_plain_sharded_ade_step_refusals():
    """OUTFLOW_PE with a sharded y axis, or a local x width under 3, raises
    (as in the JAX step); the kernel step takes both and refuses z cuts."""
    m, periodic = _sim_coupled_ade_map((8, 8, 4))
    dom = interop.domain_from_numpy(m, periodic, lat=interop.D3Q7)
    cfg = LBMConfig(lat=D3Q7, collision=cade.collide_clbm_ade)
    with pytest.raises(NotImplementedError, match="sharded y/z"):
        sh.make_sharded_ade_step(cfg, dom, cpu_plan((1, 2, 1)))
    with pytest.raises(NotImplementedError, match="x width >= 3"):
        sh.make_sharded_ade_step(cfg, dom, cpu_plan((4, 1, 1)))
    sh.make_sharded_fused_ade_step(cfg, dom, cpu_plan((4, 2, 1)))
    with pytest.raises(NotImplementedError, match="A13b"):
        sh.make_sharded_fused_ade_step(cfg, dom, cpu_plan((1, 1, 2)))


# --------------------------------------------- the kernels' sharded steps

def _dom_2d(kind, shape=(16, 16)):
    m, periodic, bz = case_2d(kind, shape)
    return Domain(lat=D2Q9, units=Lattice(shape, (0, 0), 1.0, 1.0), map=m, periodic=periodic,
                  bouzidi=bz)


@pytest.mark.parametrize("counts", COUNTS_2D)
@pytest.mark.parametrize("kind,collision,forced,profile", (
    ("bouzidi", "CLBM", False, True),
    ("box", "SRT", True, True),
    ("periodic", "SRT", True, False),
    ("channel", "CLBM", False, False)))
def test_sharded_2d_kernel_step_bit_for_bit(kind, collision, forced, profile, counts):
    """Three steps of the sharded D2Q9 step through B5 halo's plain version
    against the unsharded B5 plain step: the y seam of 2 (y) and 2 x 2
    runs through the Bouzidi ring of the block at x 4-5, y 5-8 and the
    box's disks; each shard launches once a step."""
    dom = _dom_2d(kind)
    coll = col2.collide_srt_2d if collision == "SRT" else col2.collide_clbm_2d
    cfg = LBMConfig(lat=D2Q9, collision=coll)
    plan = cpu_plan(counts, ("x", "y"))
    one = make_fused_step_2d(cfg, dom, "cpu")
    step = sh.make_sharded_fused_step_2d(cfg, dom, plan)
    u_in = torch.as_tensor(parabolic_2d(16)).float() if profile else (0.03, 0.004)
    force = FORCE_2D if forced else None
    f1 = seeded_2d(cfg, dom.shape, "cpu")
    fN = plan.shard_field(f1, like_f=True)
    for _ in range(3):
        f1, r1, u1 = one(f1, NU, u_in=u_in, force=force)
        fN, rN, uN = step(fN, NU, u_in=u_in, force=force)
    for a, b in ((fN, f1), (rN, r1), (uN, u1)):
        assert torch.equal(a.gather(), b)
    assert step.local_step.plain_calls == 3 * plan.n_shards
    assert step.local_step.kernel.name == "d2q9_step_halo"


@pytest.mark.parametrize("counts", ((2, 1), (2, 2)))
def test_sharded_2d_force_field_bit_for_bit(counts):
    """The force_field variant: a per-site force field sharded like f, plus
    the homogeneous force_add."""
    dom = _dom_2d("bouzidi")
    cfg = LBMConfig(lat=D2Q9, collision=col2.collide_srt_2d)
    plan = cpu_plan(counts, ("x", "y"))
    one = make_fused_step_2d(cfg, dom, "cpu", force_field=True)
    step = sh.make_sharded_fused_step_2d(cfg, dom, plan, force_field=True)
    rng = np.random.default_rng(5)
    field = torch.from_numpy((1e-5 * rng.standard_normal((2,) + dom.shape)).astype(np.float32))
    f1 = seeded_2d(cfg, dom.shape, "cpu")
    fN = plan.shard_field(f1, like_f=True)
    for it in range(2):
        force = field if it else plan.shard_field(field, like_f=True)
        f1, r1, u1 = one(f1, NU, u_in=(0.03, 0.0), force=field, force_add=FORCE_2D)
        fN, rN, uN = step(fN, NU, u_in=(0.03, 0.0), force=force, force_add=FORCE_2D)
    for a, b in ((fN, f1), (rN, r1), (uN, u1)):
        assert torch.equal(a.gather(), b)


@pytest.mark.parametrize("counts", COUNTS_3D)
@pytest.mark.parametrize("kind,collision,variable", (
    ("box", "CLBM", True), ("channel", "MRT", False), ("periodic", "CLBM-RS", True),
    ("box", "SRT", False)))
def test_sharded_ade_kernel_step_bit_for_bit(kind, collision, variable, counts):
    """Three steps of the sharded ADE step through B6 halo's plain version
    against the unsharded B6 plain step, a per-site nu field and transfer
    links included: the x seams cross the WALL_BODY rows and the box's
    transfer slab, the y seam its WALL_BODY-side patches; OUTFLOW_PE's x-2
    pull reads the 2-wide halo."""
    m, periodic = ade_case(kind, (8, 16, 8))
    dom = interop.domain_from_numpy(m, periodic, lat=interop.D3Q7)
    cfg = interop.ade_config_from_spec(collision)
    plan = cpu_plan(counts)
    one = make_fused_ade_step(cfg, dom, "cpu", variable_diffusion=variable,
                              transfer_coeff=TCOEF)
    step = sh.make_sharded_fused_ade_step(cfg, dom, plan, variable_diffusion=variable,
                                          transfer_coeff=TCOEF)
    g1, u, nu_field = seeded_ade(dom.shape, "cpu")
    nu = nu_field if variable else NU
    gN, uN = plan.shard_field(g1, like_f=True), plan.shard_field(u, like_f=True)
    for _ in range(3):
        g1, p1 = one(g1, u, nu, phi_in=PHI_IN)
        gN, pN = step(gN, uN, nu, phi_in=PHI_IN)
    assert torch.equal(gN.gather(), g1) and torch.equal(pN.gather(), p1)
    assert step.local_step.plain_calls == 3 * plan.n_shards
    assert step.local_step.kernel.name == "ade_step_halo"
    assert (step.tflags is not None) == (kind == "box")


@pytest.mark.parametrize("shape,counts,periodic", (
    ((15, 16), (4, 1), (True, False)),    # pad 1 on a periodic axis
    ((16, 13), (2, 3), (False, True)),
    ((22, 10), (3, 2), (False, False))))
def test_uneven_2d_step_equals_unsharded(shape, counts, periodic):
    """A lattice the plan does not divide pads and crops: the uneven sharded
    D2Q9 step through B5 halo bit for bit the unsharded B5 step, with a
    Bouzidi ring, a profile and a force."""
    m = np.zeros(shape, np.uint8)
    if not periodic[1]:
        m[:, 0] = m[:, -1] = 1  # GEO.WALL
    if not periodic[0]:
        m[0, 1:-1], m[-1, 1:-1] = 4, 5  # GEO.INFLOW, GEO.OUTFLOW_RIGHT
    from torch_cases import bouzidi_ring

    solid = np.zeros(shape, bool)
    solid[5:8, 4:7] = True
    m[solid] = 1
    bz = bouzidi_ring(m, solid, 2)
    dom = Domain(lat=D2Q9, units=Lattice(shape, (0, 0), 1.0, 1.0), map=m, periodic=periodic,
                 bouzidi=bz)
    cfg = LBMConfig(lat=D2Q9, collision=col2.collide_clbm_2d)
    plan = cpu_plan(counts, ("x", "y"))
    assert not plan.divisible(dom)
    one = make_fused_step_2d(cfg, dom, "cpu")
    step = sh._make_uneven_sharded_step(cfg, dom, plan,
                                        inner_builder=sh.make_sharded_fused_step_2d)
    prof = torch.as_tensor(parabolic_2d(shape[1])).float()
    f1 = seeded_2d(cfg, shape, "cpu")
    fN = plan.shard_field(f1, like_f=True, padded_shape=step.padded_shape)
    for _ in range(3):
        f1, r1, u1 = one(f1, NU, u_in=prof, force=FORCE_2D)
        fN, rN, uN = step(fN, NU, u_in=prof, force=FORCE_2D)
    for a, b in ((fN, f1), (rN, r1), (uN, u1)):
        assert torch.equal(a.gather(), b)


# ------------------------------------------------------------------ the apps

def test_sim2d_apps_sharded_equal_unsharded(tmp_path, geos):
    """sim2d_1 (plain and B5), sim2d_3 on choose_plan's uneven 3 shards and
    sim2d_2 (its statistics and snapshot CSV) on two CPU shards: the
    unsharded runs' fields and outputs."""
    for fused in (False, True):
        kw = dict(device="cpu", use_fused=fused)
        one = _run(sim2d_1.build(1, 0.002, tmp_path / f"one{fused}", **kw))
        two = _run(sim2d_1.build(1, 0.002, tmp_path / f"two{fused}", sharded=True,
                                 devices=["cpu", "cpu"], **kw))
        assert two.plan.counts == (2, 1) and two.iterations == one.iterations > 0
        assert torch.equal(two.f.gather(), one.f) and torch.equal(two.u, one.u)
        cut = "vtk2D/cut_X_000000.vti"
        assert (two.results_dir / cut).read_bytes() == (one.results_dir / cut).read_bytes()
    geo = str(geos / "1.txt")
    one = _run(sim2d_3.build(1, geo, final_time=0.01, results_parent=tmp_path / "s3a",
                             values_dir=tmp_path / "v1", device="cpu"))
    three = _run(sim2d_3.build(1, geo, final_time=0.01, results_parent=tmp_path / "s3b",
                               values_dir=tmp_path / "v3", sharded=True, device="cpu",
                               devices=["cpu"] * 3))
    assert three.plan.counts == (3, 1) and not three.plan.divisible(three.domain)
    assert three.iterations == one.iterations == 40
    assert torch.equal(three.f.gather(), one.f) and three.ke_value == one.ke_value
    assert (tmp_path / "v3" / "value_1.txt").read_text() == \
        (tmp_path / "v1" / "value_1.txt").read_text()
    kw = dict(final_time=0.02, stat_start=0.005, stat_end=0.015, device="cpu")
    one = _run(sim2d_2.build(1, geo, results_parent=tmp_path / "s2a", **kw))
    two = _run(sim2d_2.build(1, geo, results_parent=tmp_path / "s2b", sharded=True,
                             devices=["cpu", "cpu"], **kw))
    assert two.iterations == one.iterations == 80 and two.means_frozen == one.means_frozen
    assert torch.equal(two.f.gather(), one.f) and torch.equal(two.sum_v, one.sum_v)
    csv = [p.name for p in one.results_dir.glob("*.csv")]
    assert csv
    for name in csv:
        assert (two.results_dir / name).read_text() == (one.results_dir / name).read_text()


def test_sim2d_hooks_and_refused_configs_under_a_plan(tmp_path):
    """A forcing hook under a plan takes the sharded hooked pipeline (the u*
    pass on the haloed blocks, the hook on the gathered lattice, then B5
    halo's force_field mode), which equals the unsharded hooked step within
    2 ulp of the largest value (a block's plain sums over q round their
    tails otherwise than the whole lattice's); a D2Q9 config B5 refuses
    raises there as unsharded (float64: Bf64)."""
    from tnl_lbm_tpu_torch.kernels.hooked import make_hooked_fused_step

    sim = sim2d_1.build(1, 0.002, tmp_path, device="cpu", use_fused=True, sharded=True,
                        devices=["cpu", "cpu"])
    hook = lambda lat, rho, u, nu, fluid: 1e-4 * u * rho  # noqa: E731
    hooked = dataclasses.replace(sim.cfg, forcing_hook=hook)
    step = sim._sharded_step(hooked)
    assert step.route == "pipeline" and step.base.local_step.kernel.name.endswith("_halo")
    one = make_hooked_fused_step(hooked, sim.domain, "cpu")
    f0 = seeded_2d(sim.cfg, sim.domain.shape, "cpu", 3)
    a = one(f0, NU, force=FORCE_2D)
    b = step(sim.plan.shard_field(f0, like_f=True), NU, force=FORCE_2D)
    for x, y in zip(a, b):
        assert float((x - y.gather()).abs().max()) <= 2.4e-7 * float(x.abs().max())
    f64 = dataclasses.replace(sim.cfg, compute_dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="Bf64"):
        sim._sharded_step(f64)


@pytest.mark.parametrize("fused", (False, True))
def test_sim_coupled_sharded_equals_unsharded(tmp_path, fused):
    """sim_coupled res 1 --sharded on two CPU shards, 9 steps: "sharded"
    (the plain sharded steps) or "sharded-fused" (B4 then B6 on haloed
    blocks, their plain versions), each equal to its unsharded run (the
    plain steps, or B7's plain version: B4 then B6 equals it bit for bit,
    tests/test_torch_coupled.py); the VTK cut reads the gathered phi."""
    kw = dict(device="cpu", use_fused=fused)
    one = _run(sim_coupled.build(1, 0.005, tmp_path / "one", **kw))
    two = _run(sim_coupled.build(1, 0.005, tmp_path / "two", sharded=True,
                                 devices=["cpu", "cpu"], **kw))
    assert two.coupled_kernel == ("sharded-fused" if fused else "sharded")
    assert two.plan.counts == (2, 1, 1) and two.iterations == one.iterations == 9
    assert torch.equal(two.f.gather(), one.f) and torch.equal(two.g.gather(), one.g)
    assert torch.equal(two.phi, one.phi) and torch.equal(two.u, one.u)
    cut = "vtk2D/cut_Z_000000.vti"
    assert (two.results_dir / cut).read_bytes() == (one.results_dir / cut).read_bytes()
    if fused:
        assert two._ade_step.local_step.plain_calls == 2 * 9
        assert two._step.local_step.plain_calls == 2 * 9


def test_sim_coupled_sharded_refusals(tmp_path):
    """use_fused under a plan where the sharded ADE kernel does not take the
    config raises naming ROADMAP §C: A-A streaming, a z cut, a plan that
    does not divide; without use_fused A-A runs the plain sharded steps."""
    with pytest.raises(NotImplementedError, match="ROADMAP §C"):
        sim_coupled.main(["1", "--device", "cpu", "--sharded", "--streaming", "AA",
                          "--use-fused", "--results-dir", str(tmp_path / "aa")])
    sim = sim_coupled.build(1, 0.002, tmp_path / "z", device="cpu", use_fused=True)
    for counts in ((1, 1, 2), (3, 1, 1)):
        sim.plan = cpu_plan(counts)
        with pytest.raises(NotImplementedError, match="ROADMAP §C"):
            sim.sim_init()
    aa = _run(sim_coupled.build(1, 0.002, tmp_path / "aa_plain", device="cpu", streaming="AA",
                                sharded=True, devices=["cpu", "cpu"]))
    assert aa.coupled_kernel == "sharded" and aa.iterations == 4
    assert torch.isfinite(aa.phi).all()


# ------------------------------------------------------------- checkpoints

def _coupled(tmp_path, sim_id, plan, fused=True):
    sim = sim_coupled.build(1, 1.0, tmp_path, device="cpu", use_fused=fused)
    return sim_coupled.SimCoupled(sim.cfg, sim.domain, sim.ade_cfg, sim.ade_domain,
                                  ade_diffusion=5e-3, phi_inflow=1.0, device="cpu",
                                  sim_id=sim_id, results_parent=tmp_path, use_fused=fused,
                                  plan=plan)


def test_sharded_coupled_checkpoint_loads_in_jax_and_resumes(tmp_path):
    """A sharded coupled run's save writes f and g in the JAX layout; the
    JAX loader reassembles both, and a resumed sharded run continues bit
    for bit the uninterrupted one."""
    ref = _coupled(tmp_path / "ref", "run", cpu_plan((2, 1, 1)))
    ref.sim_init()
    ref._advance(6)
    sim = _coupled(tmp_path / "ckpt", "run", cpu_plan((2, 1, 1)))
    sim.sim_init()
    sim._advance(3)
    sim.save_state()
    arrays, meta = jckpt.load_checkpoint(sim.results_dir)
    np.testing.assert_array_equal(arrays["f"], sim.f.gather().numpy())
    np.testing.assert_array_equal(arrays["g"], sim.g.gather().numpy())
    assert meta["iterations"] == 3
    again = _coupled(tmp_path / "ckpt", "run", cpu_plan((2, 1, 1)))
    again.sim_init()
    assert again.iterations == 3 and isinstance(again.g, sh.ShardedField)
    again._advance(3)
    assert torch.equal(again.f.gather(), ref.f.gather())
    assert torch.equal(again.g.gather(), ref.g.gather()) and torch.equal(again.phi, ref.phi)


@needs_8
def test_jax_sharded_coupled_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX save of f and g on 8 virtual devices resumes a port run on two
    shards: the state, g and phi as g's density."""
    sim = _coupled(tmp_path, "jax", cpu_plan((2, 1, 1)), fused=False)
    rng = np.random.default_rng(4)
    f0 = (1.0 / 27 + 1e-3 * rng.standard_normal((27,) + sim.domain.shape)).astype(np.float32)
    g0 = (1.0 / 7 + 1e-3 * rng.standard_normal((7,) + sim.domain.shape)).astype(np.float32)
    mesh = JMesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("x", "y"))
    spec = NamedSharding(mesh, P(None, "x", "y"))
    jckpt.save_checkpoint(sim.results_dir,
                          {"f": jax.device_put(jnp.asarray(f0), spec),
                           "g": jax.device_put(jnp.asarray(g0), spec)},
                          {"iterations": 8, "stat_counter": 0, "stat2_counter": 0,
                           "counters": {}, "probe_cycles": {}})
    sim.flags.create("loadstate")
    sim.sim_init()
    assert sim.iterations == 8 and sim.coupled_kernel == "sharded"
    np.testing.assert_array_equal(sim.f.gather().numpy(), f0)
    np.testing.assert_array_equal(sim.g.gather().numpy(), g0)
    np.testing.assert_allclose(sim.phi.numpy(), g0.sum(0), rtol=1e-6)


# ------------------------------------------------- the JAX Pallas kernels

@pytest.mark.slow
@needs_8
def test_sharded_2d_kernel_step_against_jax_pallas_interpret():
    """The sharded D2Q9 step (B5 halo's plain version) against JAX
    ``make_sharded_fused_step_2d`` in Pallas interpret mode on a 2 x 2 mesh,
    Bouzidi ring and profile: within the step bounds."""
    m, periodic, bz = case_2d("bouzidi", (16, 16))
    jdom = JDomain(lat=JD2Q9, units=JLattice((16, 16), (0, 0), 1.0, 1.0), map=m.copy(),
                   periodic=periodic, bouzidi=bz)
    jcfg = JConfig(lat=JD2Q9, collision=jcol2.collide_clbm_2d, compute_dtype=jnp.float32)
    jmesh = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    jplan = jsh.ShardPlan(mesh=jmesh, spatial_axes=("x", "y"))
    jstep = jsh.make_sharded_fused_step_2d(jcfg, jdom, jplan)
    dom = _dom_2d("bouzidi")
    cfg = LBMConfig(lat=D2Q9, collision=col2.collide_clbm_2d)
    plan = cpu_plan((2, 2), ("x", "y"))
    step = sh.make_sharded_fused_step_2d(cfg, dom, plan)
    prof = parabolic_2d(16).astype(np.float32)
    f0 = seeded_2d(cfg, (16, 16), "cpu")
    fj = jplan.shard_field(jnp.asarray(f0.numpy()), like_f=True)
    mj = jplan.shard_field(jnp.asarray(m), like_f=False)
    fp = plan.shard_field(f0, like_f=True)
    for _ in range(3):
        fj, rj, uj = jstep(fj, mj, NU, u_in=jnp.asarray(prof))
        fp, rp, up = step(fp, NU, u_in=torch.from_numpy(prof))
    for a, b, tol in ((fp, fj, 1e-6), (rp, rj, 2e-6), (up, uj, 1e-6)):
        np.testing.assert_allclose(a.gather().numpy(), np.asarray(b), atol=tol, rtol=0)


@pytest.mark.slow
@needs_8
def test_sharded_ade_kernel_step_against_jax_pallas_interpret():
    """The sharded ADE step (B6 halo's plain version) against JAX
    ``make_sharded_fused_ade_step`` in Pallas interpret mode on a 2 x 2 mesh,
    transfer links and a nu field: within the step bounds."""
    m, periodic = ade_case("box", (8, 16, 8))
    jdom = JDomain(lat=JD3Q7, units=JLattice(m.shape, (0, 0, 0), 1.0, 1.0), map=m.copy(),
                   periodic=periodic)
    jcfg = JConfig(lat=JD3Q7, collision=jcade.collide_clbm_ade, compute_dtype=jnp.float32)
    jmesh = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    jplan = jsh.ShardPlan(mesh=jmesh, spatial_axes=("x", "y", None))
    jstep = jsh.make_sharded_fused_ade_step(jcfg, jdom, jplan, variable_diffusion=True,
                                            transfer_coeff=TCOEF)
    dom = interop.domain_from_numpy(m, periodic, lat=interop.D3Q7)
    cfg = interop.ade_config_from_spec("CLBM")
    plan = cpu_plan((2, 2, 1))
    step = sh.make_sharded_fused_ade_step(cfg, dom, plan, variable_diffusion=True,
                                          transfer_coeff=TCOEF)
    g0, u, nu = seeded_ade(m.shape, "cpu")
    gj = jplan.shard_field(jnp.asarray(g0.numpy()), like_f=True)
    uj = jplan.shard_field(jnp.asarray(u.numpy()), like_f=True)
    nj = jplan.shard_field(jnp.asarray(nu.numpy()), like_f=False)
    mj = jplan.shard_field(jnp.asarray(m), like_f=False)
    gp, up = plan.shard_field(g0, like_f=True), plan.shard_field(u, like_f=True)
    for _ in range(3):
        gj, pj = jstep(gj, uj, mj, nj, phi_in=PHI_IN)
        gp, pp = step(gp, up, nu, phi_in=PHI_IN)
    np.testing.assert_allclose(gp.gather().numpy(), np.asarray(gj), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pp.gather().numpy(), np.asarray(pj), atol=2e-6, rtol=0)


@pytest.fixture(scope="module")
def geos(tmp_path_factory):
    import subprocess
    import sys
    from pathlib import Path

    out = tmp_path_factory.mktemp("geos")
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, str(root / "scripts" / "make_golden_geometries.py"),
                    str(out)], check=True, cwd=root, capture_output=True)
    return out
