"""The 2D slice of the port on the CPU, held against the JAX package.

The D2Q9 collisions, the plain step with the Bouzidi pull and inflow
profiles, the D2Q9 step kernel's (B5) plain version against the JAX Pallas
kernel in interpret mode, the geometry loader, ``Simulation`` on D2Q9, and
the apps sim2d_1, sim2d_2 and sim2d_3, from the same seeded inputs.  Per-step
bounds are the JAX kernel suite's (tests/test_fused_kernel.py:65-67):
|df| < 1e-6, |drho| < 2e-6, |du| < 1e-6.  The Bouzidi thetas are seeded in
(0.05, 0.95) on the links that hit an obstacle and -1 on the others, so
both branches of the interpolation and plain streaming run at ring sites.
"""

import csv
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.apps import sim2d_1 as jsim2d_1
from tnl_lbm_tpu.apps import sim2d_2 as jsim2d_2
from tnl_lbm_tpu.apps import sim2d_3 as jsim2d_3
from tnl_lbm_tpu.io import native
from tnl_lbm_tpu.io.geometry import load_geometry_file as j_load_geometry_file
from tnl_lbm_tpu.kernels.fused_2d import make_fused_step_2d as j_make_fused_step_2d
from tnl_lbm_tpu.models import D2Q9 as JD2Q9
from tnl_lbm_tpu.ops import collision_2d as jcol2
from tnl_lbm_tpu.sim import Domain as JDomain
from tnl_lbm_tpu.sim import LBMConfig as JConfig
from tnl_lbm_tpu.sim import make_step as j_make_step
from tnl_lbm_tpu.utils import Lattice as JLattice
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.apps import sim2d_1, sim2d_2, sim2d_3
from tnl_lbm_tpu_torch.io.geometry import load_geometry_file
from tnl_lbm_tpu_torch.kernels.fused_2d import FusedStep2D, make_fused_step_2d, supports_2d
from tnl_lbm_tpu_torch.models import D2Q9
from tnl_lbm_tpu_torch.ops import collision_2d as col2
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim import make_step
from tnl_lbm_tpu_torch.sim.state import Simulation

from torch_cases import FORCE_2D, U_IN_2D, case_2d, compress_statistics, parabolic_2d

ROOT = Path(__file__).resolve().parents[1]
NU = 0.02
TOL_F, TOL_RHO, TOL_U = 1e-6, 2e-6, 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the 2D arrays are small, and beside the
    other test workers more threads only contend for the cores (the golden
    row takes 5.7 s on one thread and 9.9 s on eight, alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both_sides(kind, collision, shape=(16, 16)):
    """(JAX cfg, JAX domain, port cfg, port domain) of a ``case_2d`` geometry."""
    m, periodic, bz = case_2d(kind, shape)
    jcfg = JConfig(lat=JD2Q9, collision=jcol2.COLLISIONS_D2Q9[collision])
    jdom = JDomain(lat=JD2Q9, units=JLattice(shape, (0, 0), 1.0, 1.0), map=m.copy(),
                   periodic=periodic, bouzidi=bz)
    cfg = interop.config_2d_from_spec(collision)
    dom = interop.domain_from_numpy(m, periodic, lat=JD2Q9, bouzidi=bz)
    return jcfg, jdom, cfg, dom


def start_state(shape, seed=41):
    """A seeded near-equilibrium D2Q9 state (JAX tests/test_fused_2d.py:36-40)."""
    rng = np.random.default_rng(seed)
    rho = jnp.asarray((1 + 0.01 * rng.standard_normal(shape)).astype(np.float32))
    u = jnp.asarray((0.02 * rng.standard_normal((2,) + shape)).astype(np.float32))
    return np.array(jcol2.eqlib.eq_quadratic(JD2Q9, rho, u).astype(jnp.float32))


def inputs(kind, uin_kind, forced, Y):
    """(u_in, force) as numpy arrays: the parabolic profile or a vector, and
    the body force or None; the periodic channel is driven by the force alone."""
    if kind == "periodic":
        return None, np.asarray(FORCE_2D, np.float32)
    u_in = (parabolic_2d(Y).astype(np.float32) if uin_kind == "profile"
            else np.asarray(U_IN_2D, np.float32))
    return u_in, np.asarray(FORCE_2D, np.float32) if forced else None


def assert_close(j, p, tol, what):
    d = float(np.abs(np.asarray(j) - p.numpy()).max())
    assert d < tol, f"{what}: {d}"


def run_both(jstep, step, f0, u_in, force, steps=4):
    fj, fp = jnp.asarray(f0), torch.from_numpy(f0.copy())
    jkw = {"u_in": None if u_in is None else jnp.asarray(u_in),
           "force": None if force is None else jnp.asarray(force)}
    for it in range(steps):
        fj, rj, uj = jstep(fj, NU, **jkw)
        fp, rp, up = step(fp, NU, u_in=u_in, force=force)
        assert_close(fj, fp, TOL_F, f"f, step {it}")
        assert_close(rj, rp, TOL_RHO, f"rho, step {it}")
        assert_close(uj, up, TOL_U, f"u, step {it}")


# ------------------------------------------------------------- collisions

@pytest.mark.parametrize("collision", ["SRT", "CLBM"])
@pytest.mark.parametrize("forced", [False, True], ids=["noforce", "force"])
def test_collisions_2d_match_jax(collision, forced):
    rng = np.random.default_rng(5)
    shape = (6, 7)
    f = start_state(shape) + (1e-3 * rng.standard_normal((9,) + shape)).astype(np.float32)
    rho = (1 + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    u = (0.02 * rng.standard_normal((2,) + shape)).astype(np.float32)
    force = np.asarray(FORCE_2D, np.float32).reshape(2, 1, 1) if forced else None
    want = jcol2.COLLISIONS_D2Q9[collision](
        JD2Q9, jnp.asarray(f), jnp.asarray(rho), jnp.asarray(u), NU,
        force=None if force is None else jnp.asarray(force))
    got = col2.COLLISIONS_D2Q9[collision](
        D2Q9, torch.from_numpy(f), torch.from_numpy(rho), torch.from_numpy(u), NU,
        force=None if force is None else torch.from_numpy(force))
    assert_close(want, got, 1e-7, collision)
    assert sorted(col2.COLLISIONS_D2Q9) == sorted(jcol2.COLLISIONS_D2Q9)
    if forced:
        assert_close(jcol2.guo_forcing(JD2Q9, jnp.asarray(u), jnp.asarray(force)),
                     col2.guo_forcing(D2Q9, torch.from_numpy(u), torch.from_numpy(force)), 1e-9,
                     "guo_forcing")
    k = col2.central_moments_2d(D2Q9, torch.from_numpy(f), torch.from_numpy(u))
    back = col2.dfs_from_central_moments_2d(D2Q9, k, torch.from_numpy(u))
    assert_close(f, back, 1e-6, "central-moment round trip")


# ------------------------------------------------------------- plain step

STEP_MATRIX = ([(c, k, uk, True) for c in ("SRT", "CLBM") for k in ("channel", "bouzidi")
                for uk in ("profile", "vector")]
               + [(c, "periodic", "vector", True) for c in ("SRT", "CLBM")]
               + [("SRT", "box", "profile", False)])


@pytest.mark.parametrize("collision,kind,uin_kind,forced", STEP_MATRIX)
def test_plain_step_matches_jax(collision, kind, uin_kind, forced):
    """Four steps of ``make_step`` against JAX ``make_step``: SRT/CLBM x
    Bouzidi x profile/vector inflow, the periodic body-force channel, and
    the box of every code without a force (SRT then skips Guo's term)."""
    jcfg, jdom, cfg, dom = both_sides(kind, collision)
    u_in, force = inputs(kind, uin_kind, forced, dom.shape[1])
    run_both(j_make_step(jcfg, jdom), make_step(cfg, dom), start_state(dom.shape), u_in, force)


# ----------------------------------------------------------- B5, plain

@pytest.mark.parametrize("collision,kind,uin_kind,forced", [
    ("CLBM", "bouzidi", "profile", True), ("SRT", "box", "vector", True),
    ("SRT", "periodic", "vector", True), ("SRT", "bouzidi", "profile", False)])
def test_b5_plain_matches_jax_pallas_interpret(collision, kind, uin_kind, forced):
    """B5's plain version against the JAX Pallas kernel it replaces, in
    interpret mode as the JAX suite runs it on the CPU, 16x16, 4 steps."""
    jcfg, jdom, cfg, dom = both_sides(kind, collision)
    u_in, force = inputs(kind, uin_kind, forced, dom.shape[1])
    step = make_fused_step_2d(cfg, dom, "cpu")
    run_both(j_make_fused_step_2d(jcfg, jdom), step, start_state(dom.shape), u_in, force)
    assert step.plain_calls == 4 and step.kernel.launches == 0


def test_b5_refuses_what_it_does_not_take():
    m, periodic, bz = case_2d("channel")
    dom = interop.domain_from_numpy(m, periodic, lat=D2Q9)
    cfg = interop.config_2d_from_spec("CLBM")
    assert supports_2d(cfg, dom)
    sym = interop.domain_from_numpy(np.where(m == GEO.NOTHING, GEO.SYM_TOP, m), periodic, lat=D2Q9)
    for c, d, what in ((interop.config_2d_from_spec("CLBM", streaming="AA"), dom, "streaming"),
                       (cfg, sym, "SYM_TOP")):
        assert not supports_2d(c, d)
        with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP §C"):
            make_fused_step_2d(c, d, "cpu")
    assert make_fused_step_2d(cfg, dom, "cpu", force_field=True).kernel.name == \
        "d2q9_step_force_field"
    hooked = dataclasses.replace(cfg, forcing_hook=lambda lat, rho, u, nu, fluid: u)
    assert not supports_2d(hooked, dom)
    with pytest.raises(NotImplementedError, match="make_hooked_fused_step"):
        make_fused_step_2d(hooked, dom, "cpu")
    # the sharded step's haloed block (tests/test_torch_sharded_2d_ade.py): its
    # map comes with each call
    halo = make_fused_step_2d(cfg, dom, "cpu", local_shape=(8, 8))
    assert halo.prepadded and halo.kernel.name == "d2q9_step_halo"
    with pytest.raises(ValueError, match="map_arr_in"):
        halo(torch.zeros((9, 10, 10)), 0.02)
    step = make_fused_step_2d(cfg, dom, "cpu")
    f = torch.zeros((9, 16, 16))
    with pytest.raises(NotImplementedError, match="force_field"):
        step(f, NU, force=np.zeros((2, 16, 16), np.float32))
    with pytest.raises(ValueError, match="second contiguous state buffer"):
        step(f, NU, out=f)
    with pytest.raises(NotImplementedError, match="D2Q9 only"):
        interop.domain_from_numpy(np.zeros((4, 4, 4), np.uint8), (False,) * 3,
                                  bouzidi=np.zeros((26, 4, 4, 4)))
    with pytest.raises(ValueError, match="bouzidi shape"):
        interop.domain_from_numpy(m, periodic, lat=D2Q9, bouzidi=np.zeros((8, 4, 4)))


# --------------------------------------------------------- geometry files

def write_geometry(path, X, Y, seed=3):
    """A geometry file with a disk (type 2), its ring (type 1, seeded thetas
    in [-1, 1]) and fluid (type 0), in the reference's column order."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    r = np.hypot(xs - X / 3, ys - Y / 2)
    kind = np.where(r < 3, 2, np.where(r < 4.5, 1, 0))
    lines = []
    for x in range(X):
        for y in range(Y):
            th = rng.uniform(-1, 1, 8) if kind[x, y] == 1 else -np.ones(8)
            lines.append(f"{x} {y} {kind[x, y]} " + " ".join(f"{v:.6f}" for v in th))
    Path(path).write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("bouzidi", [True, False])
def test_load_geometry_file_matches_jax(tmp_path, bouzidi):
    p = tmp_path / "g.txt"
    write_geometry(p, 24, 12)
    m, bz = load_geometry_file(p, 24, 12, use_bouzidi_for_type1=bouzidi)
    jm, jbz = j_load_geometry_file(p, 24, 12, use_bouzidi_for_type1=bouzidi)
    assert m.dtype == jm.dtype and np.array_equal(m, jm)
    assert bz.dtype == jbz.dtype and np.array_equal(bz, jbz)
    assert (m == (GEO.FLUID_NEAR_WALL if bouzidi else GEO.FLUID)).any()


def test_load_geometry_file_refuses_bad_files(tmp_path):
    p = tmp_path / "g.txt"
    write_geometry(p, 8, 6)
    rows = p.read_text().splitlines()
    cases = {"11 columns": [r + " 0" for r in rows],
             "out of range": [rows[0].rsplit(" ", 1)[0] + " 1.5"] + rows[1:],
             "row count": rows[:-1]}
    for what, lines in cases.items():
        p.write_text("\n".join(lines) + "\n")
        with pytest.raises(ValueError, match=what):
            load_geometry_file(p, 8, 6)
    p.write_text("\n".join(rows) + "\n")
    with pytest.raises(ValueError, match="do not match"):
        load_geometry_file(p, 6, 8)


# ------------------------------------------------------------- Simulation

def test_simulation_builds_b5_and_raises_where_it_refuses(tmp_path):
    m, periodic, bz = case_2d("bouzidi")
    dom = interop.domain_from_numpy(m, periodic, lat=D2Q9, bouzidi=bz, phys_viscosity=NU)
    sim = Simulation(interop.config_2d_from_spec("SRT"), dom, device="cpu", sim_id="b5",
                     results_parent=tmp_path, phys_final_time=3.0, use_fused=True)
    assert sim.run() and sim.iterations == 3
    assert isinstance(sim._step, FusedStep2D) and sim._spare is not None
    assert sim._step.plain_calls == 3 and sim._step.kernel.launches == 0
    aa = Simulation(interop.config_2d_from_spec("SRT", streaming="AA"), dom, device="cpu",
                    sim_id="aa", results_parent=tmp_path, phys_final_time=2.0, use_fused=True)
    with pytest.raises(NotImplementedError, match="ROADMAP §C"):
        aa.sim_init()


# ------------------------------------------------------------------ apps

def make_golden_geometries(out):
    subprocess.run([sys.executable, str(ROOT / "scripts/make_golden_geometries.py"), str(out)],
                   check=True, capture_output=True)
    return out


@pytest.fixture(scope="module")
def geos(tmp_path_factory):
    return make_golden_geometries(tmp_path_factory.mktemp("geos"))


def seeded_run_state(ref, port, seed=3):
    """The same seeded near-equilibrium state in both apps' runs (after
    their own ``sim_init``)."""
    f0 = start_state(ref.domain.shape, seed)
    ref.f, port.f = jnp.asarray(f0), torch.from_numpy(f0.copy())


def advance_both(port, ref, steps):
    for sim in (port, ref):
        sim._advance(steps)
        sim._after_sim_update()


def test_sim2d_3_matches_jax(tmp_path, geos):
    """Build, then 40 steps of the B5 plain version against the JAX XLA step
    from one seeded state on geometry 1 with Bouzidi: fields, and the KE
    integral the app writes."""
    obj = str(geos / "1.txt")
    port = sim2d_3.build(1, obj, True, final_time=1.0, results_parent=tmp_path / "port",
                         values_dir=tmp_path / "vp", device="cpu")
    ref = jsim2d_3.build(1, obj, True, final_time=1.0, results_parent=tmp_path / "jax",
                         values_dir=tmp_path / "vj", use_fused=False)
    np.testing.assert_array_equal(port.domain.map, ref.domain.map)
    np.testing.assert_array_equal(port.domain.bouzidi, ref.domain.bouzidi)
    assert port.u_max_lbm == ref.u_max_lbm and port.steps_per_dispatch == ref.steps_per_dispatch
    assert port.value_path.name == ref.value_path.name == "value_1.txt"
    for name in ("phys_dl", "phys_dt", "phys_viscosity"):
        assert getattr(port.domain.units, name) == getattr(ref.domain.units, name)
    prof = port.update_inflow(0.0)
    assert prof is port.update_inflow(1.0)  # made once, on the run's device
    np.testing.assert_array_equal(prof.numpy(), np.asarray(ref.update_inflow(0.0), np.float32))
    for sim in (port, ref):
        sim.sim_init()
    seeded_run_state(ref, port)
    advance_both(port, ref, 40)
    assert port._step.plain_calls == 40
    assert_close(ref.rho, port.rho, 1e-5, "rho after 40 steps")
    assert_close(ref.u, port.u, 1e-6, "u after 40 steps")
    ke_p, ke_j = port.integrate_ke_roi(), ref.integrate_ke_roi()
    assert ke_p > 0 and abs(ke_p - ke_j) <= 1e-5 * ke_j


def test_sim2d_1_matches_jax(tmp_path):
    """Build, 30 steps of the plain step and of B5's plain version against
    the JAX XLA step, and the VTK2D cut's bytes for one state."""
    port = sim2d_1.build(1, results_parent=tmp_path / "port", device="cpu")
    kern = sim2d_1.build(1, results_parent=tmp_path / "kern", use_fused=True, device="cpu")
    ref = jsim2d_1.build(1, results_parent=tmp_path / "jax")
    np.testing.assert_array_equal(port.domain.map, ref.domain.map)
    assert port.lbm_inflow_vx == ref.lbm_inflow_vx > 0 and not port.use_fused
    assert {k: c.period for k, c in port.cnt.items()} == {k: ref.cnt[k].period for k in port.cnt}
    assert [(p.axis, p.name, p.position) for p in port.probes_2d] == \
        [(p.axis, p.name, p.position) for p in ref.probes_2d]
    for sim in (port, kern, ref):
        sim.sim_init()
    seeded_run_state(ref, port)
    kern.f = port.f.clone()
    for sim in (port, kern, ref):
        sim._advance(30)
    assert kern._step.plain_calls == 30
    for sim in (port, kern):
        assert_close(ref.rho, sim.rho, 1e-5, "rho after 30 steps")
        assert_close(ref.u, sim.u, 1e-6, "u after 30 steps")
    port.rho, port.u = torch.from_numpy(np.array(ref.rho)), torch.from_numpy(np.array(ref.u))
    for sim in (port, ref):
        sim._write_vtk_2d()
    native.flush()
    for name in ("vtk2D/cut_X.pvd", "vtk2D/cut_X_000000.vti"):
        assert (port.results_dir / name).read_bytes() == (ref.results_dir / name).read_bytes()


def test_sim2d_2_matches_jax(tmp_path, geos):
    """The compressed statistics run on geometry 1 with Bouzidi, from one
    seeded state, through B5's plain version against the JAX app on its XLA
    step (the loop of ``run`` without its lock and flags): the events, the
    sample counts, the accumulators, the TKE written, the CSV rows and the
    VTK bytes of the reference field set with the theta planes."""
    obj = str(geos / "1.txt")
    port = sim2d_2.build(1, obj, results_parent=tmp_path / "port",
                         value_path=str(tmp_path / "tke_port"), device="cpu")
    ref = jsim2d_2.build(1, obj, results_parent=tmp_path / "jax",
                         value_path=str(tmp_path / "tke_jax"), use_fused=False)
    for sim in (port, ref):
        compress_statistics(sim)
        sim.sim_init()
    seeded_run_state(ref, port)
    for sim in (port, ref):
        while not sim.terminate and sim.phys_time() < sim.phys_final_time:
            sim._advance(1)
            sim._after_sim_update()
    assert port.terminate and port.tke_value_written and port._step.plain_calls == port.iterations
    for name in ("iterations", "mean_samples", "fluc_samples", "means_frozen", "flucs_frozen",
                 "mean_freeze_time"):
        assert getattr(port, name) == getattr(ref, name), name
    assert [r["event"] for r in port.csv_rows] == [r["event"] for r in ref.csv_rows]
    for name in ("sum_v", "frozen_mean", "sum_up2", "sum_upmag"):
        assert_close(getattr(ref, name), getattr(port, name), 1e-5, name)
    tke_p, tke_j = (float((tmp_path / f"tke_{s}").read_text()) for s in ("port", "jax"))
    assert tke_p > 0 and abs(tke_p - tke_j) <= 1e-5 * tke_j
    # the checkpoint's extra arrays: the JAX app's names and values
    extra, ref_extra = port.checkpoint_arrays_extra(), ref.checkpoint_arrays_extra()
    assert sorted(extra) == sorted(ref_extra) == [f"s2d2_{n}" for n in
                                                  ("frozen_mean", "sum_up2", "sum_upmag", "sum_v")]
    for name, v in extra.items():
        assert v is getattr(port, name[5:]), name
        assert_close(ref_extra[name], v, 1e-5, name)
    # one state in both: the output fields, written as VTK, byte for byte
    for name in ("rho", "u", "sum_v", "frozen_mean", "sum_up2", "sum_upmag"):
        setattr(port, name, torch.from_numpy(np.array(getattr(ref, name))))
    for sim in (port, ref):
        sim._write_vtk_3d()
    native.flush()
    scalars, _ = port.output_data()
    assert {f"bouzidi_{n}" for n in sim2d_2.THETA_NAMES} <= set(scalars)
    name = "vtk3D/data_000000.vti"
    assert (port.results_dir / name).read_bytes() == (ref.results_dir / name).read_bytes()


def test_2d_apps_cli_and_options(tmp_path, geos):
    obj = str(geos / "4.txt")
    sim = sim2d_3.main(["1", obj, "--device", "cpu", "--final-time", "0.01",
                        "--results-dir", str(tmp_path), "--values-dir", str(tmp_path / "v")])
    assert sim.iterations == 40 and sim._step.plain_calls == 40
    # 40 steps move nothing into the ROI yet: the value is 0, the inflow moved
    assert float((tmp_path / "v" / "value_4.txt").read_text()) == sim.ke_value == 0
    assert torch.isfinite(sim.u).all() and float(sim.u[0].max()) > 0
    sim = sim2d_1.main(["1", "--device", "cpu", "--final-time", "0.002", "--use-fused",
                        "--results-dir", str(tmp_path)])
    assert sim.iterations > 0 and sim._step.plain_calls == sim.iterations
    # --sharded runs (on the CPU over the one device: one shard); a hook under
    # a plan builds the sharded hooked step (tests/test_torch_sharded_hooked.py
    # and tests/test_torch_sharded_2d_ade.py hold N shards)
    for app, args in ((sim2d_1, ["--use-fused", "--final-time", "0.002"]),
                      (sim2d_2, [obj, "--final-time", "0.0025"]),
                      (sim2d_3, [obj, "--final-time", "0.0025", "--values-dir",
                                 str(tmp_path / "sv")])):
        sim = app.main(["1", *args, "--device", "cpu", "--sharded", "--results-dir",
                        str(tmp_path / "sharded")])
        assert sim.plan is not None and sim.iterations > 0
        assert sim._step.local_step.plain_calls == sim.iterations
        hooked = sim._sharded_step(dataclasses.replace(sim.cfg,
                                                       forcing_hook=lambda *a, **k: None))
        assert getattr(hooked, "route", "pipeline") == "pipeline" and hooked.padded_shape
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sim2d_3.build(1, device="cuda", results_parent=tmp_path / "cuda")


def test_golden_row_through_the_plain_step(tmp_path, geos):
    """Geometry 1 with Bouzidi at the corpus' resolution and final time
    (1440 steps) through the port's plain step: the KE value within 1e-4
    relative of the TPU-measured corpus row (tests/golden/)."""
    golden = {(r["geometry"], r["bouzidi"]): float(r["value"])
              for r in csv.DictReader(open(ROOT / "tests/golden/geometry_ke_values_tpu.csv"))}
    sim = sim2d_3.build(1, str(geos / "1.txt"), True, final_time=0.4,
                        results_parent=tmp_path, values_dir=tmp_path / "v", use_fused=False,
                        device="cpu")
    assert sim.run() and sim.iterations == 1440
    ref = golden[("1.txt", "on")]
    assert abs(sim.ke_value - ref) <= 1e-4 * abs(ref), (sim.ke_value, ref)
