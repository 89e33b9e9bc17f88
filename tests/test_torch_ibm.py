"""The port's immersed-boundary slice on the CPU against the JAX package.

Seeded numpy inputs go through both: the dirac kernels (within 1e-7), the
point generators and the sparse builders (equal), the built ``IBM`` in each
operator space - point-space ELLPACK A ("modified"), node-space dense Gram
B, point-space ELLPACK G, the matrix-free Gram after clipped stencils or a
MemoryError of the neighbour search - with the same structure (``w``
within 1e-7: XLA's CPU cos and sqrt are not correctly rounded, torch's
differ in the last bit for a few per cent of the values; ``E_val``, ``B``
and ``diag`` within 1e-6 relative), ``interpolate``/``spread``, the
solve (``compute_forces``, compact and generic path, from the port's build
and from the JAX consts carried over by ``interop.ibm_consts_from_numpy``,
within 1e-5 of max |F|), ``integrate_force``, ``min_max_spacing``,
``write_points_vtk`` byte for byte, the ``auto`` method on both sides of
each threshold and sim_ibm at resolution 1 through the plain versions of
the hooked pipeline's kernels (B4 macro_only and force_field) against the
JAX app on its XLA step.

The solve comparisons pin the CG iteration count (a tolerance neither run
reaches, a fixed ``max_iters``, as tests/test_ibm.py:87,211,236 do): at the
default tolerance the two packages may stop one iteration apart on the same
inputs, a difference of order tol * |F| and not a fault.  The sub-grid
clouds' systems amplify float-order differences with every iteration, so
the pinned count is small (8).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.apps import sim_ibm as jsim_ibm
from tnl_lbm_tpu.ibm import IBM as JIBM
from tnl_lbm_tpu.ibm import dirac as jdirac
from tnl_lbm_tpu.ibm import generators as jgen
from tnl_lbm_tpu.ibm import lagrange as jlagrange
from tnl_lbm_tpu.ibm import sparse as jsparse
from tnl_lbm_tpu.io.vtk import write_points_vtk as j_write_points_vtk
from tnl_lbm_tpu.sim import initial_dfs as j_initial_dfs
from tnl_lbm_tpu.utils import Lattice as JLattice
from tnl_lbm_tpu_torch import ibm_tables, interop
from tnl_lbm_tpu_torch.apps import sim_ibm
from tnl_lbm_tpu_torch.ibm import IBM, dirac, generators, lagrange, sparse
from tnl_lbm_tpu_torch.io.vtk import write_points_vtk
from tnl_lbm_tpu_torch.models import D3Q27
from tnl_lbm_tpu_torch.ops import collision as col
from tnl_lbm_tpu_torch.ops import non_newtonian as pnn
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.state import Simulation
from tnl_lbm_tpu_torch.utils.units import Lattice

GRID = (24, 16, 16)
TOL_DIRAC = 1e-7
TOL_OP = 1e-6   # E_val, B, diag: relative to the largest entry
TOL_F = 1e-5    # forces: relative to max |F|
PINNED = 8      # CG iterations of the pinned solves
TOL_APP = 1e-5  # the apps' kernel-vs-plain bound, here port vs JAX


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def units(grid=GRID):
    kw = dict(global_size=grid, phys_origin=(0, 0, 0), phys_dl=1.0, phys_dt=1.0,
              phys_viscosity=0.05)
    return JLattice(**kw), Lattice(**kw)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


# ------------------------------------------------------------------ kernels

@pytest.mark.parametrize("name", ["phi1", "phi2", "phi3", "phi4"])
def test_dirac_matches_jax(name):
    rng = np.random.default_rng(1)
    r = np.concatenate([rng.uniform(-2.5, 2.5, 20_000), np.arange(-25, 26) / 10.0,
                        [-2.0, -1.5, -1.0, -0.5, 0.5, 1.0, 1.5, 2.0]]).astype(np.float32)
    got = dirac.dirac_delta(name, torch.from_numpy(r)).numpy()
    want = np.asarray(jdirac.dirac_delta(name, jnp.asarray(r)))
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= TOL_DIRAC
    assert np.array_equal(got == 0, want == 0)  # the same support
    assert dirac.dirac_support(name) == jdirac.dirac_support(name)
    d = torch.from_numpy(r[:300].reshape(3, 100))
    got3 = dirac.dirac_delta_3d(name, d[0], d[1], d[2]).numpy()
    want3 = np.asarray(jdirac.dirac_delta_3d(name, *jnp.asarray(r[:300].reshape(3, 100))))
    assert np.abs(got3 - want3).max() <= TOL_DIRAC


def test_generators_match_jax():
    cases = [("points_rectangle", ((12.0, 8.0, 8.0), 6.0, 5.0, 0.9)),
             ("points_sphere", ((10.0, 8.0, 8.0), 4.0, 1.2)),
             ("points_sphere", ((48.0, 48.0, 48.0), 19.2, 0.6))]
    cases += [("points_cylinder", ((0.5, 0.4, 0.3), 0.4, 0.5, 0.05, axis)) for axis in range(3)]
    for fn, args in cases:
        got, want = getattr(generators, fn)(*args), getattr(jgen, fn)(*args)
        assert got.dtype == want.dtype and np.array_equal(got, want), fn


def test_sparse_builders_match_jax():
    rng = np.random.default_rng(2)
    nodes = rng.integers(-3, 20, size=(300, 27, 3))
    for got, want in zip(sparse.unique_nodes(nodes, (16, 12, 10)),
                         jsparse.unique_nodes(nodes, (16, 12, 10))):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for extent, radius in (((20.0, 20.0, 20.0), 1.7), ((30.0, 4.0, 2.5), 1.7),
                           ((6.0, 6.0, 6.0), 4.0)):
        pts = rng.uniform(0, extent, (400, 3))
        want = jsparse.neighbor_pairs(pts, radius)
        # a small chunk, so the candidates are made in many pieces
        for chunk in (1 << 24, 997):
            got = sparse.neighbor_pairs(pts, radius, chunk=chunk)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w), (extent, chunk)
        ks, ls = want
        vals = rng.uniform(-1, 1, len(ks)).astype(np.float32)
        vals[::7] = 0.0
        for g, w in zip(sparse.pack_ellpack(ks, ls, vals, len(pts)),
                        jsparse.pack_ellpack(ks, ls, vals, len(pts))):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    # the raise where the JAX function raises: one candidate fewer than it counts
    pts = rng.uniform(0, 8.0, (300, 3))
    n_cand = 0
    while True:
        try:
            jsparse.neighbor_pairs(pts, 2.0, max_candidates=n_cand)
            break
        except MemoryError:
            n_cand = n_cand * 2 + 1000
    lo, hi = 0, n_cand
    while hi - lo > 1:  # the least budget the JAX search accepts
        mid = (lo + hi) // 2
        try:
            jsparse.neighbor_pairs(pts, 2.0, max_candidates=mid)
            hi = mid
        except MemoryError:
            lo = mid
    sparse.neighbor_pairs(pts, 2.0, max_candidates=hi)
    with pytest.raises(MemoryError, match="candidate pairs"):
        sparse.neighbor_pairs(pts, 2.0, max_candidates=hi - 1)


# ---------------------------------------------------------------- the solver

#: case -> (points, method, dirac, the operator space built): each of the
#: four spaces, and the kernels across them
CASES = {
    "A_phi2": (("sphere", 4.0, 1.2), "modified", "phi2", "ellpack_A"),
    "A_phi1": (("sphere", 4.0, 1.2), "modified", "phi1", "ellpack_A"),
    "B_phi2": (("sphere", 5.0, 0.35), "original", "phi2", "node"),
    "B_phi4": (("sphere", 5.0, 0.35), "original", "phi4", "node"),
    "G_phi3": (("sphere", 4.0, 1.2), "original", "phi3", "ellpack_G"),
    "G_phi2": (("sphere", 4.0, 1.2), "original", "phi2", "ellpack_G"),
    "free_clipped": (("clipped", 3.0, 1.2), "original", "phi2", "matrix_free"),
    "free_dense": (("sphere", 4.0, 1.2), "original", "phi1", "matrix_free"),
}


def case_points(kind):
    shape, radius, sigma = kind
    center = (10.0, 8.0, 1.0) if shape == "clipped" else (10.0, 8.0, 8.0)
    return jgen.points_sphere(center, radius, sigma)


@functools.lru_cache(maxsize=None)
def built(case):
    """(JAX IBM, port IBM) of a case, CG pinned; "free_dense" with a
    neighbour budget so small that the Gram's search raises on both sides."""
    kind, method, name, _ = CASES[case]
    pts = case_points(kind)
    ju, pu = units()
    kw = dict(dirac=name, method=method, max_iters=PINNED, tol=1e-30)
    if case != "free_dense":
        return JIBM(ju, pts, **kw), IBM(pu, pts, device="cpu", **kw)
    mp = pytest.MonkeyPatch()
    try:
        for mod, fn in ((jlagrange, jsparse.neighbor_pairs), (lagrange, sparse.neighbor_pairs)):
            mp.setattr(mod, "neighbor_pairs", functools.partial(fn, max_candidates=100))
        return JIBM(ju, pts, **kw), IBM(pu, pts, device="cpu", **kw)
    finally:
        mp.undo()


def space_of(ibm) -> str:
    if ibm.space == "node":
        return "node"
    if ibm.E_idx is None:
        return "matrix_free"
    return "ellpack_A" if ibm.method == "modified" else "ellpack_G"


def seeded_u(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3,) + GRID) * 0.01).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ibm_build_matches_jax(case):
    j, p = built(case)
    assert space_of(j) == space_of(p) == CASES[case][3]
    assert (p.space, p.method, p.u, p.m, p._clipped) == (j.space, j.method, j.u, j.m, j._clipped)
    assert np.array_equal(p.stencil_nodes, j.stencil_nodes)
    assert np.abs(p.weights.numpy() - np.asarray(j.weights)).max() <= TOL_DIRAC
    consts_j = j.hook_consts()
    for key, want in consts_j.items():
        got = p.hook_consts()[key]
        assert (got is None) == (want is None), key
        if want is None:
            continue
        want = np.asarray(want)
        if key in ("nodes", "uflat", "uid", "unodes", "E_idx"):
            assert np.array_equal(got.numpy(), want), key
        elif key != "w":
            assert rel(want, got.numpy()) <= TOL_OP, key
    if j.E_idx is not None:
        assert np.abs(p.dense_A() - j.dense_A()).max() <= TOL_OP * np.abs(j.dense_A()).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_compute_forces_matches_jax(case):
    """The compact solve and the generic-shape solve, from the port's own
    build and from the JAX consts carried over, CG pinned at PINNED."""
    j, p = built(case)
    u = seeded_u()
    rho = (1.0 + 0.01 * np.random.default_rng(4).standard_normal(GRID)).astype(np.float32)
    ju, jr, pu, pr = jnp.asarray(u), jnp.asarray(rho), torch.from_numpy(u), torch.from_numpy(rho)
    carried = interop.ibm_consts_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in j.hook_consts().items()}, "cpu")
    for generic in (False, True):
        cj, cp, cc = j.hook_consts(), p.hook_consts(), dict(carried)
        if generic:  # mask the compact keys: the generic gather/scatter path
            cj["uflat"] = cp["uflat"] = cc["uflat"] = None
        want = np.asarray(j.compute_forces(ju, jr, consts=cj))
        assert int(j.last_cg_iters) == PINNED
        for consts in (cp, cc):
            got = p.compute_forces(pu, pr, consts=consts).numpy()
            assert p.last_cg_iters == PINNED
            assert np.abs(got - want).max() <= TOL_F * np.abs(want).max(), (generic, consts is cc)


@pytest.mark.parametrize("case", ["A_phi2", "B_phi2"])
def test_prescribed_velocity_matches_jax(case):
    """``use_ll_velocity``: the target velocity at the points enters the
    right-hand side (point space: b; node space: W^T v_p, ``Wt_vp``, taken
    when the consts are made), CG pinned."""
    kind, method, name, _ = CASES[case]
    pts = case_points(kind)
    ju, pu = units()
    kw = dict(dirac=name, method=method, max_iters=PINNED, tol=1e-30, use_ll_velocity=True)
    j, p = JIBM(ju, pts, **kw), IBM(pu, pts, device="cpu", **kw)
    vp = np.random.default_rng(9).uniform(-0.01, 0.01, (j.m, 3))
    j.prescribed_velocity = p.prescribed_velocity = vp
    u, rho = seeded_u(10), np.ones(GRID, np.float32)
    want = np.asarray(j.compute_forces(jnp.asarray(u), jnp.asarray(rho)))
    got = p.compute_forces(torch.from_numpy(u), torch.from_numpy(rho)).numpy()
    assert (p.hook_consts()["Wt_vp"] is None) == (j.hook_consts()["Wt_vp"] is None)
    assert p.last_cg_iters == int(j.last_cg_iters) == PINNED
    assert np.abs(got - want).max() <= TOL_F * np.abs(want).max()


@pytest.mark.parametrize("case", ["A_phi2", "B_phi2", "free_clipped"])
def test_interpolate_spread_and_integrate_match_jax(case):
    j, p = built(case)
    u = seeded_u(5)
    got = p.interpolate(torch.from_numpy(u)).numpy()
    want = np.asarray(j.interpolate(jnp.asarray(u)))
    assert got.shape == want.shape == (j.m, 3)
    assert rel(want, got) <= 1e-6
    vals = np.random.default_rng(6).standard_normal((j.m, 3)).astype(np.float32)
    for shape in (GRID, (20, 12, 14)):
        got = p.spread(torch.from_numpy(vals), shape).numpy()
        want = np.asarray(j.spread(jnp.asarray(vals), shape))
        assert got.shape == want.shape and rel(want, got) <= 1e-6
        # float32 sums of ~6000 terms of either sign, in two orders
        assert rel(j.integrate_force(jnp.asarray(want)),
                   p.integrate_force(torch.from_numpy(got))) <= TOL_F


def test_cg_stops_where_the_jax_loop_stops():
    """At the default tolerance, unpinned: the loop stops at the JAX
    while_loop's iteration, with the same residual (a well-conditioned
    cloud, where float order cannot move the stop)."""
    ju, pu = units()
    pts = jgen.points_sphere((10.0, 8.0, 8.0), 4.0, 1.2)
    j = JIBM(ju, pts, dirac="phi2", method="modified")
    p = IBM(pu, pts, dirac="phi2", method="modified", device="cpu")
    u, rho = seeded_u(7), np.ones(GRID, np.float32)
    want = np.asarray(j.compute_forces(jnp.asarray(u), jnp.asarray(rho)))
    got = p.compute_forces(torch.from_numpy(u), torch.from_numpy(rho)).numpy()
    k = int(j.last_cg_iters)
    assert 0 < k < j.max_iters
    assert p.last_cg_iters == k
    assert abs(p.last_cg_residual - float(j.last_cg_residual)) <= 1e-3 * j.tol
    assert p.last_cg_residual <= p.tol
    assert np.abs(got - want).max() <= TOL_F * np.abs(want).max()


def test_min_max_spacing_matches_jax():
    ju, pu = units()
    rng = np.random.default_rng(8)
    pts = np.concatenate([jgen.points_cylinder((12.0, 8.0, 8.0), 6.0, 8.0, 0.7),
                          rng.uniform(2, 14, (50, 3))])
    j = JIBM(ju, pts, dirac="phi3", method="modified")
    p = IBM(pu, pts, dirac="phi3", method="modified", device="cpu")
    want = j.min_max_spacing()
    for block in (1 << 24, 1000):  # one block, and rows of 1000 // m = 1
        got = p.min_max_spacing(block=block)
        assert np.allclose(got, want, rtol=1e-12, atol=0), (got, want)


def test_write_points_vtk_matches_jax_byte_for_byte(tmp_path):
    pts = jgen.points_cylinder((0.5, 0.4, 0.3), 0.4, 0.2, 0.05, axis=2)
    for t in (None, 0.0123456789):
        write_points_vtk(tmp_path / "port" / "p.vtk", pts, time=t)
        j_write_points_vtk(tmp_path / "jax" / "p.vtk", pts, time=t)
        assert (tmp_path / "port" / "p.vtk").read_bytes() == (tmp_path / "jax" / "p.vtk").read_bytes()


def test_auto_method_matches_jax(monkeypatch):
    """'auto' picks what the JAX package picks on both sides of each
    threshold: DENSE_A_MAX_POINTS ("modified" up to it), then
    NODE_DENSE_CAP (node space up to it, when u <= m)."""
    ju, pu = units()
    pts = jgen.points_sphere((10.0, 8.0, 8.0), 5.0, 0.5)
    m = len(pts)
    probe = IBM(pu, pts, dirac="phi3", method="modified", device="cpu")
    assert probe.u <= m
    seen = set()
    for dense_a in (m, m - 1):
        for cap in (probe.u, probe.u - 1):
            for cls in (JIBM, IBM):
                monkeypatch.setattr(cls, "DENSE_A_MAX_POINTS", dense_a)
                monkeypatch.setattr(cls, "NODE_DENSE_CAP", cap)
            j = JIBM(ju, pts, dirac="phi3", method="auto", max_iters=5)
            p = IBM(pu, pts, dirac="phi3", method="auto", max_iters=5, device="cpu")
            assert (p.method, p.space) == (j.method, j.space), (dense_a, cap)
            seen.add((p.method, p.space))
    assert seen == {("modified", "point"), ("original", "node"), ("original", "point")}


def test_ibm_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal")
    _, pu = units()
    pts = jgen.points_sphere((10.0, 8.0, 8.0), 4.0, 1.2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IBM(pu, pts, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_ibm.build(1, device="cuda")


# ------------------------------------------------------------- the driver

class Box(Simulation):
    def update_inflow(self, phys_time):
        return np.array([0.02, 0.0, 0.0])


def hooked_box(tmp_path, tag, hook_kind, steps_per_dispatch=1):
    from tnl_lbm_tpu_torch.ops.boundary import GEO

    _, pu = units()
    m = np.zeros(GRID, np.uint8)
    m[0] = GEO.INFLOW
    m[-1] = GEO.OUTFLOW_EQ
    m[:, 0] = m[:, -1] = GEO.WALL
    m[:, :, 0] = m[:, :, -1] = GEO.WALL
    dom = Domain(lat=D3Q27, units=pu, map=m)
    if hook_kind == "ibm":
        ibm = IBM(pu, jgen.points_sphere((10.0, 8.0, 8.0), 3.0, 1.2), max_iters=PINNED,
                  tol=1e-30, device="cpu")
        hook = ibm.forcing_hook()
    else:
        hook = pnn.make_nn_forcing_hook(pnn.CarreauYasuda(0.1, 1.0, 2.0, 0.5))
    cfg = LBMConfig(lat=D3Q27, collision=col.collide_cum, forcing_hook=hook)
    return Box(cfg, dom, device="cpu", sim_id=tag, results_parent=tmp_path, use_fused=True,
               phys_final_time=19.5, steps_per_dispatch=steps_per_dispatch)


def test_host_reading_hook_runs_its_chunks_eagerly(tmp_path):
    """The IBM hook declares that it reads the host (its CG condition), so a
    chunk the gate admits runs eagerly (``_chunk``) where a CUDA graph
    would capture it; a hook without the declaration takes the graph.  The
    device is set to a CUDA one without a card: the gate only reads it.
    Then the IBM run in two 10-step chunks on the CPU equals the run per step."""
    routes = {}
    for kind in ("ibm", "nn"):
        sim = hooked_box(tmp_path, f"gate_{kind}", kind)
        sim.device = torch.device("cuda")
        calls = []
        sim._chunk = lambda *a, calls=calls: calls.append("eager")
        sim._graph_chunk = lambda *a, calls=calls: calls.append("graph")
        assert sim._scan_chunk_args(10) is not None  # the gate admits the chunk
        sim._advance_scan(10, 0.05, None, None)
        routes[kind] = calls
    assert routes == {"ibm": ["eager"], "nn": ["graph"]}

    per_step = hooked_box(tmp_path, "per_step", "ibm")
    chunked = hooked_box(tmp_path, "chunked", "ibm", steps_per_dispatch=10)
    assert per_step.run() and chunked.run()
    assert per_step.iterations == chunked.iterations == 20
    assert torch.equal(per_step.f, chunked.f) and torch.equal(per_step.u, chunked.u)


# ------------------------------------------------------------- the app

def flowing_start(sim, put):
    """Start ``sim`` from ``put`` (the state at the inflow velocity) instead
    of rest, so that the flow meets the cylinder from the first step."""

    class Flowing(type(sim)):
        def sim_init(self):
            super().sim_init()
            put(self)
            self._initial_macro()

    sim.__class__ = Flowing


def drag_lines(sim) -> list:
    import json
    import re

    text = (sim.results_dir / "log_ibm").read_text()
    return [json.loads(x) for x in re.findall(r'(\{"ibm": "integrateForce".*\})', text)]


def test_sim_ibm_res1_matches_jax(tmp_path):
    """sim_ibm res 1 (96x32x32, 1394 points, phi2 "modified") through the
    plain versions of B4 macro_only and force_field (the hooked pipeline on
    the CPU) against the JAX app on its XLA step, 10 steps (11 by the
    apps' stop rule) from the flow at the inflow velocity, CG pinned:
    |du| and |drho| <= 1e-5, the drag lines within 1e-5 of |F|, the
    points files byte for byte."""
    steps = 10
    j = jsim_ibm.build(1, results_parent=tmp_path / "jax", use_fused=False)
    p = sim_ibm.build(1, device="cpu", results_parent=tmp_path / "port")
    f0 = np.asarray(j_initial_dfs(j.cfg, j.domain, u0=(j.lbm_inflow_vx, 0.0, 0.0)))

    def put_j(s):
        s.f = jnp.asarray(f0)

    def put_p(s):
        s.f.copy_(torch.tensor(f0))

    flowing_start(j, put_j)
    flowing_start(p, put_p)
    for s in (j, p):
        s.ibm.max_iters, s.ibm.tol = PINNED, 1e-30
        s.phys_final_time = (steps + 0.5) * s.domain.units.phys_dt
        s.cnt["vtk2d"].period = s.domain.units.phys_dt * 5
    assert (p.ibm.m, p.ibm.u, p.ibm.space) == (j.ibm.m, j.ibm.u, j.ibm.space) == (1394, 3720,
                                                                                   "point")
    assert j.run() and p.run()
    assert p._step.route == "pipeline" and p.iterations == j.iterations == steps + 1
    assert [k.kernel.name for k in p._step.kernels] == ["ab_step_macro_only",
                                                        "ab_step_force_field"]
    assert np.abs(np.asarray(j.u) - p.u.numpy()).max() <= TOL_APP
    assert np.abs(np.asarray(j.rho) - p.rho.numpy()).max() <= TOL_APP
    dj, dp = drag_lines(j), drag_lines(p)
    assert [d["iteration"] for d in dj] == [d["iteration"] for d in dp] == [1, 11]
    for a, b in zip(dj, dp):
        scale = np.linalg.norm([a["fx"], a["fy"], a["fz"]])
        assert scale > 1.0  # the cylinder holds the flow back
        for c in ("fx", "fy", "fz"):
            assert abs(a[c] - b[c]) <= TOL_APP * scale, (a, b)
    files = sorted(x.name for x in (p.results_dir / "ibm_points").iterdir())
    assert files == sorted(x.name for x in (j.results_dir / "ibm_points").iterdir())
    assert len(files) == 3  # iterations 1, 6 and 11
    for name in files:
        assert ((p.results_dir / "ibm_points" / name).read_bytes()
                == (j.results_dir / "ibm_points" / name).read_bytes())
    log = (p.results_dir / "log_ibm").read_text()
    for line in ('"ibm": "setup"', '"ibm": "constructMatrices"', '"ibm": "computeForces"'):
        assert line in log


def test_sim_ibm_cli_and_its_refusals(tmp_path):
    sim = sim_ibm.main(["1", "--device", "cpu", "--final-time", "0.002", "--results-dir",
                        str(tmp_path), "--no-fused"])
    assert sim.iterations == 3
    assert bool(torch.isfinite(sim.u).all())
    with pytest.raises(NotImplementedError, match="A13"):
        sim_ibm.main(["1", "--device", "cpu", "--sharded", "--results-dir", str(tmp_path)])


def test_ibm_table_rows_on_the_cpu():
    """The port's table entry: one row per method on a small sphere, through
    the hooked kernel route (the plain versions on the CPU)."""
    rows = ibm_tables.main(["--n", "16", "--points", "150", "--steps", "2", "--diracs", "phi2",
                            "--device", "cpu"])
    assert [(r["method"], r["space"]) for r in rows] == [("modified", "point"),
                                                         ("original", "point")]
    for r in rows:
        assert r["points"] == 150 and r["build_s"] > 0 and r["step_ms"] > 0
        assert 0 < r["cg_iters"] <= ibm_tables.MAX_ITERS
