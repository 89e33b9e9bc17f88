"""The sharded hooked lattice of the port (``parallel/sharded.py`` with a
forcing hook, ``kernels/hooked.py make_sharded_hooked_fused_step``, the IBM's
sharded methods, ``Simulation(plan=...)`` with a hook, ``sim_ibm --sharded``)
against the JAX package's and against the port's own one-device steps, on
the CPU.

The plans put N shards on N x ``cpu`` (``cpu_plan``); the JAX side runs on
the conftest's 8 virtual CPU devices.  Held:

- the plain sharded step with a hook equals JAX ``make_sharded_step`` in
  float64 within 1e-12: the NN hook, evaluated on the whole lattice, on a 2
  and a 2 x 2 plan; the IBM's ``sharded_hook`` (its sums over the shards)
  within ``TOL_F`` of max |F| (tests/test_torch_ibm.py), CG pinned;
- the IBM's sharded operators equal JAX's and the port's unsharded ones;
- the haloed kernels' plain versions (B4 halo force_field / macro_only, B3
  halo force_field with the force ring and macro_only, B9 halo, B10 halo in
  its three modes) through the sharded steps equal the port's unsharded
  kernels' plain versions bit for bit, with seams through the walls and the
  obstacle on 2, 2 (y) and 2 x 2 shards - B10's odd mode within 2 ulp where
  torch's CPU sum over q rounds the last 32 sites of a tensor as a tail
  (its plain version is the plain step's, which sums with ``torch.sum``);
- both hooked routes under a plan equal the unsharded ``HookedStep``; the
  uneven A-B step with a hook equals it too; a z cut raises naming A13b;
- ``sim_ibm --sharded`` on two CPU shards equals its unsharded run.

``-m slow`` holds the sharded hooked kernel step to the JAX
``make_sharded_hooked_fused_step`` in Pallas interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from tnl_lbm_tpu.ibm import IBM as JIBM
from tnl_lbm_tpu.ibm.generators import points_sphere
from tnl_lbm_tpu.models import D2Q9 as JD2Q9
from tnl_lbm_tpu.models import D3Q27 as JD3Q27
from tnl_lbm_tpu.ops import collision as jcol
from tnl_lbm_tpu.ops import non_newtonian as jnn
from tnl_lbm_tpu.parallel import sharded as jsh
from tnl_lbm_tpu.sim import Domain as JDomain
from tnl_lbm_tpu.sim import LBMConfig as JConfig
from tnl_lbm_tpu.utils import Lattice as JLattice
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.apps import sim_ibm
from tnl_lbm_tpu_torch.ibm import IBM
from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa
from tnl_lbm_tpu_torch.kernels.fused_nn import make_nn_force_kernel
from tnl_lbm_tpu_torch.kernels.fused_nn_step import HALO_WIDTHS, make_fused_nn_step
from tnl_lbm_tpu_torch.kernels.hooked import (
    make_hooked_fused_step,
    make_sharded_hooked_fused_step,
)
from tnl_lbm_tpu_torch.models import D2Q9, D3Q27
from tnl_lbm_tpu_torch.ops import collision as col
from tnl_lbm_tpu_torch.ops import non_newtonian as pnn
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.parallel import sharded as sh
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.utils.units import Lattice

from test_torch_ibm import TOL_F
from test_torch_nn import j_model
from test_torch_sharded import cpu_plan
from test_torch_step import jax_side
from torch_cases import NN_MODELS, nn_case, nn_state, source_constants

NU = 0.02
FORCE = (1e-5, 0.0, 0.0)
COUNTS = ((2, 1, 1), (1, 2, 1), (2, 2, 1))
needs_8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nn_config(kind, streaming, dtype="float32", model=None, shape=None):
    """(port cfg with the NN hook, port domain, model name, hook periodicity)
    of an ``nn_case`` geometry (CUM_WELL)."""
    m, periodic, case_model, per = nn_case(kind, shape)
    model = model or case_model
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, streaming, dtype=dtype)
    cfg = dataclasses.replace(cfg, forcing_hook=pnn.make_nn_forcing_hook(NN_MODELS[model],
                                                                         periodic=per))
    return cfg, interop.domain_from_numpy(m, periodic), model, per


def seeded(cfg, shape, seed=5):
    rho, u = nn_state(shape, seed)
    f = cfg.eq(cfg.lat, torch.from_numpy(rho).double(), torch.from_numpy(u).double())
    return f.to(cfg.compute_dtype).contiguous()


def jax_nn_side(streaming, m, periodic, model, per, dtype=jnp.float32):
    """The JAX config (CUM_WELL with the NN hook) and domain of a map."""
    jcfg, jdom = jax_side(dict(collision_id="CUM_WELL", eq="EQ_WELL", well=True,
                               streaming=streaming), m, periodic)
    return dataclasses.replace(jcfg, compute_dtype=dtype, forcing_hook=jnn.make_nn_forcing_hook(
        j_model(model), periodic=per)), jdom


def jax_plan(counts):
    names = tuple(a for a, n in zip("xyz", counts) if n > 1)
    axes = tuple(a if n > 1 else None for a, n in zip("xyz", counts))
    mesh = JMesh(np.asarray(jax.devices()[:int(np.prod(counts))]).reshape(
        [n for n in counts if n > 1]), names)
    return jsh.ShardPlan(mesh=mesh, spatial_axes=axes), cpu_plan(counts, axes)


# ------------------------------------------- the plain sharded step with a hook

@needs_8
@pytest.mark.parametrize("streaming,counts", [("AB", (2, 1, 1)), ("AA", (2, 2, 1))])
def test_plain_sharded_nn_hooked_step_equals_jax(streaming, counts):
    """The NN hook on the whole lattice (JAX: GSPMD over the global arrays)
    then the plain sharded step with its force, on the walled duct with a
    periodic x (seams through the walls): float64, 3 steps, within 1e-12."""
    cfg, dom, model, per = nn_config("duct", streaming, "float64", shape=(8, 12, 10))
    m = np.asarray(dom.map)
    jcfg, jdom = jax_nn_side(streaming, m, dom.periodic, model, per, jnp.float64)
    jplan, plan = jax_plan(counts)
    jstep = jsh.make_sharded_step(jcfg, jdom, jplan)
    step = sh.make_sharded_step(cfg, dom, plan)
    f0 = seeded(cfg, m.shape)
    fj = jplan.shard_field(jnp.asarray(f0.numpy()), like_f=True)
    mj = jplan.shard_field(jnp.asarray(m), like_f=False)
    fp = plan.shard_field(f0, like_f=True)
    force = np.asarray(FORCE)
    jitted = {p: jax.jit(lambda f, p=p: jstep(f, mj, NU, force=jnp.asarray(force), parity=p))
              for p in (0, 1)}
    for it in range(3):
        p = it % 2 if streaming == "AA" else 0
        fj, rj, uj = jitted[p](fj)
        fp, rp, up = step(fp, NU, force=force, parity=p)
    for a, b in ((fp, fj), (rp, rj), (up, uj)):
        np.testing.assert_allclose(a.gather().numpy(), np.asarray(b), atol=1e-12, rtol=0)


def ibm_setup(grid=(32, 16, 16)):
    """The JAX sharded IBM test's channel (tests/test_ibm_sharded.py:24-39):
    walls on the y and z faces, periodic x, a sphere of points; the JAX and
    the port's IBM of the same cloud, CG pinned."""
    m = np.zeros(grid, np.uint8)
    m[:, 0] = m[:, -1] = GEO.WALL
    m[:, :, 0] = m[:, :, -1] = GEO.WALL
    kw = dict(global_size=grid, phys_origin=(0, 0, 0), phys_dl=1.0, phys_dt=1.0,
              phys_viscosity=0.05)
    pts = points_sphere(center=(10.0, 8.0, 8.0), radius=3.0, sigma=1.2)
    jibm = JIBM(JLattice(**kw), pts, dirac="phi2", method="modified", max_iters=8)
    ibm = IBM(Lattice(**kw), pts, dirac="phi2", method="modified", device="cpu")
    for b in (ibm, jibm):
        b.max_iters, b.tol = 8, 1e-30
    jdom = JDomain(lat=JD3Q27, units=JLattice(**kw), map=m, periodic=(True, False, False))
    dom = Domain(lat=D3Q27, units=Lattice(**kw), map=m, periodic=(True, False, False))
    return jibm, ibm, jdom, dom


@needs_8
def test_plain_sharded_ibm_hook_equals_jax():
    """The IBM's ``sharded_hook`` (each shard samples and spreads the nodes
    it owns, the partial sums added) in the plain sharded step on a 2 x 2
    plan against JAX's in shard_map, 3 steps, float32, CG pinned at 8
    iterations: f, rho and u within TOL_F of their largest magnitude."""
    jibm, ibm, jdom, dom = ibm_setup()
    jplan, plan = jax_plan((2, 2, 1))
    jcfg = JConfig(lat=JD3Q27, collision=jcol.collide_cum,
                   forcing_hook=jibm.sharded_hook(jplan, jdom.shape))
    cfg = LBMConfig(lat=dom.lat, collision=col.collide_cum,
                    forcing_hook=ibm.sharded_hook(plan, dom.shape))
    jstep = jsh.make_sharded_step(jcfg, jdom, jplan)
    step = sh.make_sharded_step(cfg, dom, plan)
    f0 = seeded(cfg, dom.shape)
    fj = jplan.shard_field(jnp.asarray(f0.numpy()), like_f=True)
    mj = jplan.shard_field(jnp.asarray(dom.map), like_f=False)
    fp = plan.shard_field(f0, like_f=True)
    jitted = jax.jit(lambda f: jstep(f, mj, NU, force=jnp.asarray(FORCE, jnp.float32)))
    for _ in range(3):
        fj, rj, uj = jitted(fj)
        fp, rp, up = step(fp, NU, force=np.asarray(FORCE, np.float32))
    assert ibm.last_cg_iters == 8
    for a, b in ((fp, fj), (rp, rj), (up, uj)):
        a, b = a.gather().double().numpy(), np.asarray(b, np.float64)
        assert np.abs(a - b).max() <= TOL_F * np.abs(b).max()


@needs_8
def test_ibm_sharded_operators_match_jax():
    """interpolate_sharded / spread_sharded on a 2 x 2 x 2 plan against JAX's
    in shard_map (tests/test_ibm_sharded.py:110) and against the port's
    unsharded interpolate / spread."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    jibm, ibm, jdom, dom = ibm_setup()
    jplan, plan = jax_plan((2, 2, 2))
    rng = np.random.default_rng(3)
    field = rng.standard_normal((3,) + dom.shape).astype(np.float32)
    vals = rng.standard_normal((ibm.m, 3)).astype(np.float32)
    fs = plan.shard_field(field, like_f=True)
    got_i = ibm.interpolate_sharded(fs, plan, dom.shape)
    got_s = sh.ShardedField(plan, ibm.spread_sharded(torch.from_numpy(vals), plan, dom.shape),
                            (3,) + dom.shape).gather()
    fj = jplan.shard_field(jnp.asarray(field), like_f=True)
    want_i = jax.jit(shard_map(lambda b: jibm.interpolate_sharded(b, jplan, jdom.shape),
                               mesh=jplan.mesh, in_specs=(jplan.spec_f,), out_specs=P(),
                               check_vma=False))(fj)
    want_s = jax.jit(shard_map(lambda v: jibm.spread_sharded(v, jplan, jdom.shape),
                               mesh=jplan.mesh, in_specs=(P(),), out_specs=jplan.spec_f,
                               check_vma=False))(jnp.asarray(vals))
    scale = np.abs(np.asarray(want_i)).max()
    assert np.abs(got_i.numpy() - np.asarray(want_i)).max() <= 1e-6 * scale
    assert np.abs(got_s.numpy() - np.asarray(want_s)).max() <= 1e-6 * np.abs(want_s).max()
    np.testing.assert_allclose(got_i.numpy(), ibm.interpolate(torch.from_numpy(field)).numpy(),
                               rtol=0, atol=1e-6 * scale)
    assert torch.allclose(got_s, ibm.spread(torch.from_numpy(vals), dom.shape), rtol=0,
                          atol=1e-6 * float(got_s.abs().max()))


# --------------------------------------------- the haloed kernels' plain versions

def _walled(shape, periodic):
    """A map with walls across the seams of every plan of COUNTS: the y and
    z faces walled (closed), a wall slab through the x seam, an obstacle
    through the y seam, a NOTHING site and an outflow plane."""
    m = np.zeros(shape, np.uint8)
    X, Y, Z = shape
    if not periodic[1]:
        m[:, 0] = m[:, -1] = GEO.WALL
    m[:, :, 0] = m[:, :, -1] = GEO.WALL
    m[X // 2 - 1 : X // 2 + 1, 2 : Y // 2 + 2, 2:5] = GEO.WALL
    m[2:5, Y // 2 - 1 : Y // 2 + 1, 3:6] = GEO.WALL
    m[1, 3, 4] = GEO.NOTHING
    return m


HALO_CASES = [("ab", "AB", (False, True, False)), ("aa", "AA", (True, False, False))]


@pytest.mark.parametrize("counts", COUNTS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("name,streaming,periodic", HALO_CASES, ids=lambda c: str(c))
def test_haloed_ff_and_mo_plain_equal_unsharded(name, streaming, periodic, counts):
    """B4 halo (A-B) or B2 and B3 halo (A-A, the odd step with the force
    ring) in their force_field and macro_only modes, through the sharded
    steps, against the unsharded kernels' plain versions, bit for bit, on a
    map with walls across the seams and a per-site force that differs at
    every site (the ring's seams read the neighbour's)."""
    del name
    m = _walled((8, 12, 9), periodic)
    dom = interop.domain_from_numpy(m, periodic)
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, streaming)
    plan = cpu_plan(counts)
    make1 = make_fused_step if streaming == "AB" else make_fused_step_aa
    makes = sh.make_sharded_fused_step if streaming == "AB" else sh.make_sharded_fused_step_aa
    rng = np.random.default_rng(9)
    field = torch.from_numpy((1e-4 * rng.standard_normal((3,) + m.shape)).astype(np.float32))
    f0 = seeded(cfg, m.shape)
    for parity in ((0, 1) if streaming == "AA" else (0,)):
        ff1, ffs = make1(cfg, dom, "cpu", force_field=True), makes(cfg, dom, plan,
                                                                   force_field=True)
        a = ff1(f0.clone(), NU, force=field, force_add=FORCE, parity=parity)
        b = ffs(plan.shard_field(f0.clone(), like_f=True), NU, force=field, force_add=FORCE,
                parity=parity)
        for x, y in zip(a, b):
            assert torch.equal(x, y.gather()), ("force_field", parity)
        mo1, mos = make1(cfg, dom, "cpu", macro_only=True), makes(cfg, dom, plan, macro_only=True)
        a = mo1(f0, NU, force=FORCE, parity=parity)
        b = mos(plan.shard_field(f0, like_f=True), NU, force=FORCE, parity=parity)
        for x, y in zip(a, b):
            assert torch.equal(x, y.gather()), ("macro_only", parity)
        kernel = ffs.local_step.kernel if streaming == "AB" else (
            ffs.local_step.even if parity == 0 else ffs.local_step.odd)
        assert ffs.local_step.plain_calls == plan.n_shards
        if streaming == "AB" or parity == 1:
            assert kernel.name.endswith("force_field_halo")


@pytest.mark.parametrize("counts", COUNTS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("kind,model", [("duct", "cy"), ("obstacle", "casson"),
                                        ("periodic", "casson")])
def test_b9_halo_plain_equals_unsharded(kind, model, counts):
    """B9 halo's plain version on each shard's block of u* with the halo
    exchanged under the hook's periodicity, against the unsharded B9's plain
    version (the hook), bit for bit: the walled duct (closed y faces, seams
    through the walls), the obstacle box (every face closed) and the
    periodic box (every face wraps)."""
    cfg, dom, _, per = nn_config(kind, "AB", model=model)
    plan = cpu_plan(counts)
    rho, u = nn_state(dom.shape, 7)
    rho, u = torch.from_numpy(rho), torch.from_numpy(u)
    want = make_nn_force_kernel(NN_MODELS[model], dom, "cpu", periodic=per)(rho, u, NU)
    force = sh.make_sharded_nn_force(NN_MODELS[model], dom, plan, per)
    got = force(plan.shard_field(rho, like_f=False), plan.shard_field(u, like_f=True), NU)
    assert torch.equal(got.gather(), want) and force.local_step.kernel.name == "nn_force_halo"


def test_b10_halo_widths_are_the_sources():
    """The halo widths the wrapper exchanges are csrc/nn_step.cu's, which
    B10 halo's march (nn_step_halo.cu) reads."""
    c = source_constants("nn_step.cu")
    assert HALO_WIDTHS == {0: c["NN_HALO_AB"], 1: c["NN_HALO_EVEN"], 2: c["NN_HALO_ODD"]}


@pytest.mark.parametrize("counts", COUNTS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("kind,streaming", [("duct", "AB"), ("duct", "AA"),
                                            ("obstacle", "AA"), ("periodic", "AA")])
def test_b10_halo_plain_equals_unsharded(kind, streaming, counts):
    """B10 halo's plain version in each mode on each shard's block with the
    mode's halo (3 A-B, 2 even, 4 odd) against the unsharded B10's plain
    version: two steps; bit for bit, but for the odd mode on a lattice whose
    blocks' sums over q round their tails otherwise (within 2 ulp)."""
    cfg, dom, model, per = nn_config(kind, streaming)
    plan = cpu_plan(counts)
    one = make_fused_nn_step(cfg, dom, NN_MODELS[model], per, "cpu")
    shd = sh.make_sharded_fused_nn_step(cfg, dom, plan, NN_MODELS[model], per)
    f1 = seeded(cfg, dom.shape)
    fs = plan.shard_field(f1.clone(), like_f=True)
    for parity in ((0, 1) if streaming == "AA" else (0, 0)):
        a = one(f1, NU, force=FORCE, parity=parity)
        b = shd(fs, NU, force=FORCE, parity=parity)
        for x, y in zip(a, b):
            y = y.gather()
            if parity == 1:  # 2 ulp of the largest value
                assert float((x - y).abs().max()) <= 2.4e-7 * float(x.abs().max()), parity
            else:
                assert torch.equal(x, y), parity
        f1, fs = a[0], b[0]
    assert shd.local_step.plain_calls == 2 * plan.n_shards


# ---------------------------------------------------------- the hooked routes

@pytest.mark.parametrize("single", [True, False], ids=["single_kernel", "pipeline"])
@pytest.mark.parametrize("kind,streaming", [("duct", "AB"), ("obstacle", "AA")])
def test_sharded_hooked_routes_equal_unsharded(kind, streaming, single):
    """Both routes of ``make_sharded_hooked_fused_step`` on a 2 x 2 plan
    against the unsharded ``HookedStep`` of the same route, three steps: bit
    for bit (the pipeline's B4/B2/B3 halo, B9 halo, the force ring; B10
    halo)."""
    cfg, dom, _, _ = nn_config(kind, streaming)
    plan = cpu_plan((2, 2, 1))
    one = make_hooked_fused_step(cfg, dom, "cpu", single_kernel=single)
    shd = make_sharded_hooked_fused_step(cfg, dom, plan, single_kernel=single)
    assert shd.route == one.route == ("single_kernel" if single else "pipeline")
    f1 = seeded(cfg, dom.shape)
    fs = plan.shard_field(f1.clone(), like_f=True)
    for it in range(3):
        p = it % 2 if streaming == "AA" else 0
        a = one(f1, NU, force=FORCE, parity=p)
        b = shd(fs, NU, force=FORCE, parity=p)
        for x, y in zip(a, b):
            assert torch.equal(x, y.gather()), it
        f1, fs = a[0], b[0]
    assert shd.plain_calls > 0


def test_sharded_hooked_2d_and_ibm_pipeline_with_a_force_field():
    """The 2D route (the plain u* pass on the haloed blocks, the hook, B5
    halo's force_field mode) and a body-force field through the 3D pipeline
    with a shard-local hook: equal to the unsharded ``HookedStep`` (2D:
    within 2 ulp of the largest value, as a block's plain sums over q round
    their tails otherwise than the whole lattice's)."""
    m2 = np.zeros((12, 10), np.uint8)
    m2[:, 0] = m2[:, -1] = GEO.WALL
    dom2 = interop.domain_from_numpy(m2, (True, False), lat=JD2Q9)
    cfg2 = dataclasses.replace(interop.config_2d_from_spec("SRT"), forcing_hook=(
        pnn.make_nn_forcing_hook(NN_MODELS["cy"], periodic=(True, False))))
    plan2 = sh.ShardPlan(sh.Mesh(np.array(["cpu", "cpu"], dtype=object), ("x",)), ("x", None))
    rho, u = nn_state(m2.shape, 2)
    f2 = cfg2.eq(D2Q9, torch.from_numpy(rho), torch.from_numpy(u)).contiguous()
    one, shd = make_hooked_fused_step(cfg2, dom2, "cpu"), make_sharded_hooked_fused_step(
        cfg2, dom2, plan2)
    a = one(f2, NU, force=(1e-5, 0.0))
    b = shd(plan2.shard_field(f2, like_f=True), NU, force=(1e-5, 0.0))
    for x, y in zip(a, b):
        assert float((x - y.gather()).abs().max()) <= 2.4e-7 * float(x.abs().max())
    assert shd.base.local_step.plain_calls == plan2.n_shards
    jibm, ibm, jdom, dom = ibm_setup((16, 12, 10))
    plan = cpu_plan((2, 1, 1))
    cfg = LBMConfig(lat=dom.lat, collision=col.collide_cum,
                    forcing_hook=ibm.sharded_hook(plan, dom.shape))
    one = make_hooked_fused_step(dataclasses.replace(cfg, forcing_hook=ibm.forcing_hook()), dom,
                                 "cpu")
    shd = make_sharded_hooked_fused_step(cfg, dom, plan)
    field = torch.full((3,) + dom.shape, 1e-5)
    f0 = seeded(cfg, dom.shape)
    a = one(f0, NU, force=field, hook_consts=ibm.hook_consts())
    b = shd(plan.shard_field(f0, like_f=True), NU, force=field, hook_consts=ibm.hook_consts())
    for x, y in zip(a, b):
        assert torch.equal(x, y.gather())


def test_uneven_hooked_ab_step_and_z_cut():
    """A-B on a plan that does not divide the lattice: the hook cropped to the
    true extent (JAX :269-290), equal to the unsharded pipeline bit for bit;
    a z cut under a hook raises naming A13b."""
    cfg, dom, _, _ = nn_config("duct", "AB", shape=(11, 12, 9))
    plan = cpu_plan((3, 1, 1))
    assert not plan.divisible(dom)
    one = make_hooked_fused_step(cfg, dom, "cpu", single_kernel=False)
    step = sh._make_uneven_sharded_step(cfg, dom, plan,
                                        inner_builder=make_sharded_hooked_fused_step)
    f1 = seeded(cfg, dom.shape)
    fs = plan.shard_field(f1.clone(), like_f=True, padded_shape=step.padded_shape)
    for _ in range(2):
        a = one(f1, NU, force=FORCE)
        b = step(fs, NU, force=FORCE)
        for x, y in zip(a, b):
            assert torch.equal(x, y.gather())
        f1, fs = a[0], b[0]
    with pytest.raises(NotImplementedError, match="A13b"):
        make_sharded_hooked_fused_step(cfg, dom, cpu_plan((1, 2, 3)))


def test_sim_ibm_sharded_equals_unsharded(tmp_path):
    """sim_ibm res 1 --sharded on two CPU shards, 3 steps, with the kernels'
    plain versions and with the plain steps: the unsharded run's f and u,
    and its CG iteration counts."""
    for fused in (True, False):
        one = sim_ibm.build(1, final_time=0.002, results_parent=tmp_path / f"one{fused}",
                            device="cpu", use_fused=fused)
        one.run()
        two = sim_ibm.build(1, final_time=0.002, results_parent=tmp_path / f"two{fused}",
                            device="cpu", use_fused=fused, sharded=True, devices=["cpu", "cpu"])
        two.run()
        assert two.plan.counts == (2, 1, 1) and two.iterations == one.iterations == 3
        assert torch.equal(two.f.gather(), one.f) and torch.equal(two.u, one.u)
        assert two.ibm.last_cg_iters == one.ibm.last_cg_iters
        if fused:
            assert two._step.route == "pipeline" and two._step.plain_calls > 0


# ---------------------------------------------- the JAX Pallas kernels (slow)

@needs_8
@pytest.mark.slow
@pytest.mark.parametrize("streaming", ["AB", "AA"])
def test_sharded_hooked_step_matches_jax_pallas(streaming):
    """The port's sharded hooked pipeline (plain versions) against JAX
    ``make_sharded_hooked_fused_step`` in Pallas interpret mode on a 2-shard
    plan, two steps, the step bounds."""
    from tnl_lbm_tpu.kernels.hooked import make_sharded_hooked_fused_step as j_make

    cfg, dom, model, per = nn_config("duct", streaming, shape=(8, 16, 16))
    m = np.asarray(dom.map)
    jcfg, jdom = jax_nn_side(streaming, m, dom.periodic, model, per)
    jplan, plan = jax_plan((2, 1, 1))
    jstep = j_make(jcfg, jdom, jplan, single_kernel=False)
    step = make_sharded_hooked_fused_step(cfg, dom, plan, single_kernel=False)
    f0 = seeded(cfg, m.shape)
    fj = jplan.shard_field(jnp.asarray(f0.numpy()), like_f=True)
    mj = jplan.shard_field(jnp.asarray(m), like_f=False)
    fp = plan.shard_field(f0, like_f=True)
    for it in range(2):
        p = it % 2 if streaming == "AA" else 0
        fj, rj, uj = jstep(fj, mj, NU, force=jnp.asarray(FORCE, jnp.float32), parity=p)
        fp, rp, up = step(fp, NU, force=FORCE, parity=p)
    for a, b, tol in ((fp, fj, 1e-6), (rp, rj, 2e-6), (up, uj, 1e-6)):
        assert np.abs(a.gather().double().numpy() - np.asarray(b, np.float64)).max() < tol
