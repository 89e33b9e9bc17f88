"""The port's sim_1 and sim_3 on the CPU against the JAX package's.

The maps, units and output settings that ``build`` makes are equal; five
steps of the port's plain step and of the A-B step's plain version follow
the JAX XLA step from one seeded state (|df| < 1e-6, |drho| < 2e-6,
|du| < 1e-6 per step); the VTK2D, VTK3D and VTK3DCUT writers produce
byte-equal ``.vti`` and ``.pvd`` files for one state; the command lines
run on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.apps import sim_1 as jsim_1
from tnl_lbm_tpu.apps import sim_3 as jsim_3
from tnl_lbm_tpu.io import native
from tnl_lbm_tpu.io.series import VtiTimeSeries as JVtiTimeSeries
from tnl_lbm_tpu.sim import make_step as j_make_step
from tnl_lbm_tpu_torch.apps import sim2d_1, sim_1, sim_3, sim_ibm
from tnl_lbm_tpu_torch.io.series import VtiTimeSeries
from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
from tnl_lbm_tpu_torch.sim import make_step
from tnl_lbm_tpu_torch.sim.state import VTK3D, VTK3DCUT

APPS = {"sim_1": (sim_1, jsim_1), "sim_3": (sim_3, jsim_3)}


def build_both(app, tmp_path):
    port_mod, jax_mod = APPS[app]
    return (port_mod.build(1, device="cpu", results_parent=tmp_path / "port"),
            jax_mod.build(1, results_parent=tmp_path / "jax"))


@pytest.mark.parametrize("app", sorted(APPS))
def test_app_build_matches_jax(app, tmp_path):
    port, ref = build_both(app, tmp_path)
    np.testing.assert_array_equal(port.domain.map, ref.domain.map)
    assert port.domain.periodic == tuple(ref.domain.periodic)
    for name in ("phys_dl", "phys_dt", "phys_viscosity"):
        assert getattr(port.domain.units, name) == getattr(ref.domain.units, name)
    assert port.lbm_inflow_vx == ref.lbm_inflow_vx > 0
    assert port.cfg.collision.__name__ == ref.cfg.collision.__name__
    assert port.cfg.eq.__name__ == ref.cfg.eq.__name__ and port.cfg.well == ref.cfg.well
    assert {k: c.period for k, c in port.cnt.items()} == {k: ref.cnt[k].period for k in port.cnt}
    assert [(p.axis, p.name, p.position) for p in port.probes_2d] == \
        [(p.axis, p.name, p.position) for p in ref.probes_2d]
    assert [(p.origin, p.length, p.step, p.name) for p in port.probes_3d] == \
        [(p.origin, p.length, p.step, p.name) for p in ref.probes_3d]


@pytest.mark.parametrize("app", sorted(APPS))
def test_app_steps_match_jax(app, tmp_path):
    """Five steps from a seeded near-equilibrium state: the plain step and
    the A-B step (its plain version on CPU tensors) against JAX make_step."""
    port, ref = build_both(app, tmp_path)
    rng = np.random.default_rng(3)
    shape = ref.domain.shape
    rho = jnp.asarray((1 + 0.01 * rng.standard_normal(shape)).astype(np.float32))
    u = jnp.asarray((0.02 * rng.standard_normal((3,) + shape)).astype(np.float32))
    f0 = np.array(ref.cfg.eq(ref.cfg.lat, rho, u).astype(jnp.float32))
    nu = ref.domain.units.lbm_viscosity()
    u_in = ref.update_inflow(0.0)
    jstep = j_make_step(ref.cfg, ref.domain)
    ports = [make_step(port.cfg, port.domain), make_fused_step(port.cfg, port.domain, "cpu")]
    fj, fps = jnp.asarray(f0), [torch.from_numpy(f0.copy()) for _ in ports]
    for it in range(5):
        fj, rj, uj = jstep(fj, nu, u_in=jnp.asarray(u_in, jnp.float32))
        for i, step in enumerate(ports):
            fps[i], rp, up = step(fps[i], nu, u_in=port.update_inflow(0.0))
            assert np.abs(np.asarray(fj) - fps[i].numpy()).max() < 1e-6, f"f, port {i}, step {it}"
            assert np.abs(np.asarray(rj) - rp.numpy()).max() < 2e-6, f"rho, port {i}, step {it}"
            assert np.abs(np.asarray(uj) - up.numpy()).max() < 1e-6, f"u, port {i}, step {it}"
    assert ports[1].plain_calls == 5 and ports[1].kernel.launches == 0


def output_files(sim):
    root = sim.results_dir
    return {str(p.relative_to(root)): p.read_bytes()
            for sub in ("vtk2D", "vtk3D", "vtk3Dcut") for p in sorted((root / sub).glob("*"))}


def test_vtk_output_matches_jax_byte_for_byte(tmp_path):
    """Two cycles of every sim_1 output family from one state, with the
    ``.pvd`` indices; the NaN-guard dump too."""
    port, ref = build_both("sim_1", tmp_path)
    rng = np.random.default_rng(9)
    shape = ref.domain.shape
    rho = (1 + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    u = (0.02 * rng.standard_normal((3,) + shape)).astype(np.float32)
    port.rho, port.u = torch.from_numpy(rho), torch.from_numpy(u)
    ref.rho, ref.u = jnp.asarray(rho), jnp.asarray(u)
    for sim in (port, ref):
        for cycle, it in enumerate((7, 19)):
            sim.iterations = it
            sim.cnt[VTK3D].count = sim.cnt[VTK3DCUT].count = cycle
            sim._write_vtk_2d()
            sim._write_vtk_3d()
            sim._write_vtk_3dcut()
        sim._write_vtk_3d(suffix="_nan_dump")
    native.flush()
    got, want = output_files(port), output_files(ref)
    assert sorted(got) == sorted(want)
    # per series two .vti, the .pvd and its previous version (.pvd.tmp, kept by
    # rename_exchange): 3 cuts in 2D, the lattice, the box; plus the dump
    assert len(got) == 5 * 4 + 1
    for name in want:
        assert got[name] == want[name], name
    # a writer opened on an existing index adopts its entries (a rerun appends)
    for sub, name in (("vtk2D", "cut_X"), ("vtk3D", "data"), ("vtk3Dcut", "box")):
        entries = VtiTimeSeries(port.results_dir / sub, name).entries
        assert entries == JVtiTimeSeries(ref.results_dir / sub, name).entries
        assert len(entries) == 2


def test_sim_1_cli_runs_on_the_cpu(tmp_path):
    sim = sim_1.main(["1", "--device", "cpu", "--final-time", "0.001",
                      "--results-dir", str(tmp_path)])
    assert sim.iterations == 10 and (sim.results_dir / "flag.finished").exists()
    assert sim._step.plain_calls == 10 and sim._step.kernel.launches == 0
    for name in ("vtk2D/cut_X.pvd", "vtk2D/cut_Z_000000.vti", "vtk3D/data_000000.vti",
                 "vtk3Dcut/box.pvd"):
        assert (sim.results_dir / name).exists(), name
    assert torch.isfinite(sim.u).all() and float(sim.u[0].max()) > 0


def test_sim_3_cli_runs_on_the_cpu(tmp_path):
    sim = sim_3.main(["1", "--device", "cpu", "--re", "50", "--final-time", "0.01",
                      "--results-dir", str(tmp_path)])
    assert sim.iterations == 10 and (sim.results_dir / "flag.finished").exists()
    assert sim._step.plain_calls == 10 and sim._step.kernel.launches == 0
    assert (sim.results_dir / "vtk2D" / "cut_Z_000000.vti").exists()
    assert torch.isfinite(sim.u).all() and float(sim.u[0].max()) > 0


def test_app_options_that_raise(tmp_path):
    # --sharded runs on the 3D apps, in pairs too (tests/test_torch_sharded.py,
    # tests/test_torch_sharded_pair.py), on the 2D ones through B5 halo
    # (tests/test_torch_sharded_2d_ade.py) and on the IBM app through the
    # sharded hooked pipeline (tests/test_torch_sharded_hooked.py)
    sim = sim2d_1.main(["1", "--device", "cpu", "--sharded", "--use-fused", "--final-time",
                        "0.002", "--results-dir", str(tmp_path / "pair")])
    assert sim.plan.counts == (1, 1) and sim._step.local_step.kernel.name == "d2q9_step_halo"
    assert sim._step.local_step.plain_calls == sim.iterations > 0
    sim = sim_ibm.main(["1", "--device", "cpu", "--sharded", "--final-time", "0.002",
                        "--results-dir", str(tmp_path / "pair2")])
    assert sim.plan.counts == (1, 1, 1) and sim._step.route == "pipeline"
    assert sim.iterations == 3 and sim._step.base.local_step.kernel.name == \
        "ab_step_force_field_halo"
    # A-A with the kernels runs through the even/odd kernels' plain versions
    # here ("auto" is per step on the CPU); the plain A-A step runs too
    sim = sim_1.main(["1", "--device", "cpu", "--streaming", "AA", "--use-fused",
                      "--final-time", "0.001", "--results-dir", str(tmp_path / "aa")])
    assert sim.iterations == 10 and sim.pair_dispatch is False and sim._pair is None
    assert sim._step.plain_calls == 10 and sim._step.even.launches == sim._step.odd.launches == 0
    assert torch.isfinite(sim.u).all() and float(sim.u[0].max()) > 0
    sim = sim_1.main(["1", "--device", "cpu", "--streaming", "AA", "--no-fused",
                      "--final-time", "0.001", "--results-dir", str(tmp_path / "aa_plain")])
    assert sim.iterations == 10 and torch.isfinite(sim.u).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sim_1.build(1, device="cuda", results_parent=tmp_path / "cuda")
