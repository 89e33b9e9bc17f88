"""The slice end to end on the CPU: the port's sim_2 (A-A, kernel step) ==
the JAX sim_2 (A-A, XLA step) over the same steps, plus the analytic
start-up reference that the chip smoke test holds the res-2 run to."""

import numpy as np
import pytest
import torch

from tnl_lbm_tpu.apps import sim_2 as jsim_2
from tnl_lbm_tpu_torch.apps import sim_2

FINAL_TIME = 0.3


def test_sim2_slice_matches_jax(tmp_path):
    port = sim_2.build(1, device="cpu", streaming="AA", use_fused=True, final_time=FINAL_TIME,
                       results_parent=tmp_path / "port")
    ref = jsim_2.build(1, streaming="AA", final_time=FINAL_TIME, results_parent=tmp_path / "jax")
    assert port.run() and ref.run()
    assert port.iterations == ref.iterations > 0
    assert port.pair_dispatch is False
    assert port._step.plain_calls == port.iterations  # CPU tensors: the plain versions
    port.probe1()
    ref.probe1()
    np.testing.assert_allclose(port.last_errors, ref.last_errors, rtol=1e-5)
    assert np.abs(port.u.numpy() - np.asarray(ref.u)).max() < 1e-6
    assert np.abs(port.rho.numpy() - np.asarray(ref.rho)).max() < 2e-6
    # the flow started to develop: not a comparison of two states at rest
    assert port.u[0].max() > 1e-7


def test_sim2_startup_solution_predicts_the_run(tmp_path):
    """The analytic start-up solution with the bounce-back walls half-way to
    the first fluid site reproduces the run's L1 error (the reference the
    chip smoke test uses at res 2 after 1.8e5 steps)."""
    sim = sim_2.build(1, device="cpu", streaming="AA", use_fused=True, final_time=FINAL_TIME,
                      results_parent=tmp_path)
    assert sim.run()
    sim.probe1()
    X, Y, Z = sim.domain.shape
    u0 = sim_2.duct_startup_ux(Y, Z, sim.fx_lbm, sim.domain.units.lbm_viscosity(),
                               sim.iterations, wall_sites=2)
    l1_ref, _ = sim_2.duct_errors(np.broadcast_to(u0, (X, Y, Z)), sim.analytical, sim.domain.units)
    assert abs(sim.last_errors[0] / l1_ref - 1) < 1e-3


def test_duct_profiles_match_jax():
    np.testing.assert_array_equal(sim_2.duct_analytical_ux(34, 34, 1e-6, 0.01),
                                  jsim_2.duct_analytical_ux(34, 34, 1e-6, 0.01))
    # the start-up solution starts at rest and tends to the steady profile
    ua = sim_2.duct_analytical_ux(34, 34, 1e-6, 0.01)
    assert np.abs(sim_2.duct_startup_ux(34, 34, 1e-6, 0.01, 0)).max() == 0
    late = sim_2.duct_startup_ux(34, 34, 1e-6, 0.01, 1e9)
    assert np.abs(late - ua).max() < 1e-4 * ua.max()


def test_fused_ab_is_not_ported(tmp_path):
    """What of the A-B step (B4) is still not ported refuses in a run: a
    per-site inflow profile (ROADMAP A8) raises at the first step."""
    sim = sim_2.build(1, device="cpu", streaming="AB", use_fused=True, final_time=0.05,
                      results_parent=tmp_path)
    sim.update_inflow = lambda phys_time: np.zeros((3,) + sim.domain.shape, np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        sim.run()
    assert sim.iterations == 0


def test_fused_ab_runs_b4_plain_on_cpu(tmp_path):
    """A-B with the kernels runs the A-B step (B4): on CPU tensors its plain
    version, every step, and the result equals the JAX A-B sim_2's."""
    port = sim_2.build(1, device="cpu", streaming="AB", use_fused=True, final_time=0.05,
                       results_parent=tmp_path / "port")
    ref = jsim_2.build(1, streaming="AB", final_time=0.05, results_parent=tmp_path / "jax")
    assert port.run() and ref.run()
    assert port.iterations == ref.iterations > 0
    assert port._step.plain_calls == port.iterations and port._step.kernel.launches == 0
    assert np.abs(port.u.numpy() - np.asarray(ref.u)).max() < 1e-6
    assert np.abs(port.rho.numpy() - np.asarray(ref.rho)).max() < 2e-6


def test_cli_runs_on_the_device_given(tmp_path, capsys):
    sim = sim_2.main(["1", "--device", "cpu", "--streaming", "AA", "--use-fused",
                      "--pair-dispatch", "off", "--final-time", "0.05",
                      "--results-dir", str(tmp_path)])
    assert "final l1error_phys" in capsys.readouterr().out
    assert sim.iterations >= 10 and sim.f.device.type == "cpu"
    assert (sim.results_dir / "flag.finished").exists()


def test_cuda_without_card_raises_and_never_falls_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_2.build(1, device="cuda", results_parent=tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_2.main(["1", "--results-dir", str(tmp_path)])  # --device defaults to cuda
