"""sim_2's two options of this slice on the CPU, held to the JAX sim_2.

``--precision double`` through the kernels' plain versions (A-A per step,
A-A in pairs, A-B) and ``--velocity`` (the analytic profile at INFLOW_LEFT,
OUTFLOW_RIGHT_INTERP at the outlet; A-B through B4's profile instance) in
single and double: the port's ``sim_2.build(1, ..., device="cpu",
use_fused=True)`` against the JAX ``build(1, ...)`` (its XLA step) over the
same steps.  Bounds on u: 1e-11 in double, the repo's 1e-6 in single.  The
two combinations that raise where the JAX driver runs its XLA step raise
here (ROADMAP §C).
"""

import numpy as np
import pytest
import torch

from tnl_lbm_tpu.apps import sim_2 as jsim_2
from tnl_lbm_tpu_torch.apps import sim_2
from tnl_lbm_tpu_torch.kernels.fused import kernel_counters
from tnl_lbm_tpu_torch.ops.boundary import GEO

#: 10 steps at resolution 1 (phys_dt 2.31e-3 s)
FINAL_TIME = 0.025
TOL_U = {"double": 1e-11, "single": 1e-6}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_both(tmp_path, precision, streaming="AB", use_forcing=True, pair_dispatch=False):
    port = sim_2.build(1, device="cpu", precision=precision, streaming=streaming,
                       use_forcing=use_forcing, use_fused=True, pair_dispatch=pair_dispatch,
                       final_time=FINAL_TIME, results_parent=tmp_path / "port")
    ref = jsim_2.build(1, precision=precision, streaming=streaming, use_forcing=use_forcing,
                       final_time=FINAL_TIME, results_parent=tmp_path / "jax")
    assert port.id == ref.id
    assert port.run() and ref.run()
    assert port.iterations == ref.iterations > 0
    want = torch.float64 if precision == "double" else torch.float32
    assert port.f.dtype == port.u.dtype == want
    du = np.abs(port.u.double().numpy() - np.asarray(ref.u, np.float64)).max()
    assert du < TOL_U[precision], du
    drho = np.abs(port.rho.double().numpy() - np.asarray(ref.rho, np.float64)).max()
    assert drho < 2 * TOL_U[precision], drho
    assert float(port.u[0].abs().max()) > 1e-7  # the flow moved
    return port, ref


@pytest.mark.parametrize("route", ["AA_steps", "AA_pairs", "AB"])
def test_sim2_double_matches_jax(tmp_path, route):
    """``--precision double`` per step (B2/B3's float64 plain versions), in
    pairs (B1's) and A-B (B4's)."""
    streaming = route[:2]
    port, _ = run_both(tmp_path, "double", streaming, pair_dispatch=route == "AA_pairs")
    assert port.pair_dispatch is (route == "AA_pairs")
    kernel = port._pair if route == "AA_pairs" else port._step
    assert kernel.plain_calls > 0
    names = [k.name for k in kernel_counters(kernel)]
    assert names and all("f64" in n for n in names), names


@pytest.mark.parametrize("precision", ["single", "double"])
def test_sim2_velocity_matches_jax(tmp_path, precision):
    """``--velocity`` A-B: the 32^3 duct fed by the analytic profile, through
    B4's profile instance (its plain version), against the JAX app's XLA
    step; the inflow plane carries the profile."""
    port, ref = run_both(tmp_path, precision, use_forcing=False)
    X, Y, Z = port.domain.shape
    assert (X, Y, Z) == (32, 32, 32) and port.domain.periodic == (False, False, False)
    assert (port.domain.map[0, 2:-2, 2:-2] == GEO.INFLOW_LEFT).all()
    assert (port.domain.map[-1, 2:-2, 2:-2] == GEO.OUTFLOW_RIGHT_INTERP).all()
    assert port.fx_lbm == 0.0 and port.body_force(0.0) is None
    prof = port.update_inflow(0.0)
    assert prof.shape == (3, 1, Y, Z) and prof.dtype == np.float64
    np.testing.assert_array_equal(prof[0, 0], port.analytical)
    assert port._step.profile.launches == 0 and port._step.plain_calls == port.iterations
    inflow = port.domain.map[0] == GEO.INFLOW_LEFT
    ux0 = port.u[0, 0].double().numpy()
    np.testing.assert_allclose(ux0[inflow], port.analytical[inflow].astype(
        np.float64 if precision == "double" else np.float32), rtol=0, atol=0)
    port.probe1()
    ref.probe1()
    np.testing.assert_allclose(port.last_errors, ref.last_errors,
                               rtol=1e-9 if precision == "double" else 1e-5)


def test_sim2_refuses_what_the_kernels_do_not_take(tmp_path):
    """``--velocity --streaming AA --use-fused`` and ``--storage f16|bf16
    --precision double`` raise, naming ROADMAP §C, where the JAX driver runs
    its XLA step; ``--velocity`` parses and builds the velocity duct."""
    with pytest.raises(NotImplementedError, match="OUTFLOW_RIGHT_INTERP.*ROADMAP §C"):
        sim_2.build(1, device="cpu", use_forcing=False, streaming="AA", use_fused=True,
                    results_parent=tmp_path)
    for store in ("f16", "bf16"):
        with pytest.raises(NotImplementedError, match="ROADMAP Bh64.*ROADMAP §C"):
            sim_2.main(["1", "--device", "cpu", "--storage", store, "--precision", "double",
                        "--results-dir", str(tmp_path)])
    sim = sim_2.main(["1", "--device", "cpu", "--velocity", "--precision", "double",
                      "--use-fused", "--final-time", "0.006", "--results-dir", str(tmp_path)])
    assert sim.id == "sim_2_CUM_double_velocity_strong_res_1_nd_1"
    assert sim.iterations >= 1 and sim.f.dtype == torch.float64
