"""The port's driver on the CPU: the chunked dispatch, its gate, the two
statistics windows and the 1D probes, against the port's per-step loop and
the JAX ``Simulation``.

The chunk path (``Simulation._advance_scan``) runs eagerly on the CPU, the
same function a CUDA graph captures on the card; the per-step loop is the
chunk path turned off as the JAX tests turn theirs off, by replacing
``_scan_chunk_args`` (tests/test_scan_dispatch.py:49-58).  Bounds against
the JAX package are the per-step bounds of its kernel suite
(tests/test_fused_kernel.py:65-67: |df| < 1e-6, |drho| < 2e-6, |du| < 1e-6)
times the step count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.models import D2Q9 as JD2Q9
from tnl_lbm_tpu.ops import collision_2d as jcol2
from tnl_lbm_tpu.sim import Domain as JDomain
from tnl_lbm_tpu.sim import LBMConfig as JConfig
from tnl_lbm_tpu.sim import state as jstate
from tnl_lbm_tpu.utils import Lattice as JLattice
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.models import D2Q9
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim import state
from tnl_lbm_tpu_torch.sim.state import Simulation, needs_per_step_state

from test_torch_step import FORCE, NU, geometry, spec

TOL_F, TOL_RHO, TOL_U = 1e-6, 2e-6, 1e-6
CHANNEL = (32, 16)
DT = 0.001


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def channel_map():
    """The JAX driver tests' channel (tests/test_driver.py:17-26)."""
    m = np.zeros(CHANNEL, np.uint8)
    m[:, 0] = m[:, -1] = GEO.WALL
    m[0, 1:-1] = GEO.INFLOW
    m[-1, 1:-1] = GEO.OUTFLOW_EQ
    return m


class Channel(Simulation):
    def update_inflow(self, phys_time):
        return np.array([0.05, 0.0])


class JChannel(jstate.Simulation):
    def update_inflow(self, phys_time):
        return np.array([0.05, 0.0])


def port_channel(tmp_path, sim_id="port", cls=Channel, **kw):
    """The channel on the port: D2Q9 CLBM through B5's plain version."""
    dom = interop.domain_from_numpy(channel_map(), (False, False), lat=D2Q9, phys_dl=0.01,
                                    phys_dt=DT, phys_viscosity=1e-3)
    return cls(interop.config_2d_from_spec("CLBM"), dom, device="cpu", sim_id=sim_id,
               results_parent=tmp_path, use_fused=True, **kw)


def jax_channel(tmp_path, sim_id="jax", cls=JChannel, **kw):
    """The same channel on the JAX package's XLA step."""
    units = JLattice(global_size=CHANNEL, phys_origin=(0.0, 0.0), phys_dl=0.01, phys_dt=DT,
                     phys_viscosity=1e-3)
    dom = JDomain(lat=JD2Q9, units=units, map=channel_map())
    return cls(JConfig(lat=JD2Q9, collision=jcol2.collide_clbm_2d), dom, sim_id=sim_id,
               results_parent=tmp_path, **kw)


class Box(Simulation):
    """sim_2's duct at 8 x 16 x 8 (tests/test_torch_step.py) with a body force."""

    def body_force(self, phys_time):
        return FORCE


def port_box(tmp_path, sim_id, pair_dispatch=False, cls=Box, storage=None, **kw):
    m, periodic = geometry("duct")
    cfg = interop.config_from_spec(**spec("AA"), storage=storage)
    dom = interop.domain_from_numpy(m, periodic, phys_viscosity=NU)
    return cls(cfg, dom, device="cpu", sim_id=sim_id, results_parent=tmp_path,
               use_fused=True, pair_dispatch=pair_dispatch, **kw)


def spy_chunks(sim) -> list:
    """Record the length of every chunk ``_advance_scan`` runs."""
    used, orig = [], sim._advance_scan

    def spy(n, nu, u_in, force, pairs=False):
        used.append(n)
        return orig(n, nu, u_in, force, pairs=pairs)

    sim._advance_scan = spy
    return used


def per_step_only(sim):
    sim._scan_chunk_args = lambda n, uin0=None: None
    return sim


def seeded(shape, lat, seed=3):
    """A seeded near-equilibrium D2Q9 state (total DFs), as numpy."""
    from tnl_lbm_tpu_torch.ops import equilibrium as eqlib

    rng = np.random.default_rng(seed)
    rho = torch.from_numpy((1 + 0.01 * rng.standard_normal(shape)).astype(np.float32))
    u = torch.from_numpy((0.02 * rng.standard_normal((lat.D,) + shape)).astype(np.float32))
    return eqlib.eq_quadratic(lat, rho, u).numpy()


# ------------------------------------------------------ memory preflight

@pytest.mark.parametrize("free_bytes,fits", [(10 ** 12, True), (10 ** 3, False)],
                         ids=["fits", "refused"])
def test_memory_preflight_asks_the_card_for_every_state(tmp_path, monkeypatch, free_bytes,
                                                        fits):
    """The preflight (reference state.hpp:819-877) asks the card for its free
    memory whatever the state's size (a 32 x 16 channel here) and refuses a
    state above 0.9 of it with a MemoryError that names both."""
    sim = port_channel(tmp_path)
    asked = []
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: asked.append(dev) or (free_bytes, 2 * free_bytes))
    sim.device = torch.device("cuda", 0)
    if fits:
        info = sim.estimate_memory_demands()
        assert info["device_free"] == free_bytes and 0 < info["total_bytes"] < 10 ** 5
    else:
        with pytest.raises(MemoryError, match="would not fit"):
            sim.estimate_memory_demands()
    assert asked == [torch.device("cuda", 0)]


# ------------------------------------------------------ chunk vs per step

@pytest.mark.parametrize("case", ["d2q9_channel", "aa_box_force", "aa_box_pairs",
                                  "aa_box_pairs_f16"])
def test_chunk_matches_per_step_loop(tmp_path, case):
    """The chunked dispatch and the per-step loop of the port from one
    start, both statistics windows on: f, rho, u and the windows bit for
    bit, and the kernel wrappers called once per step (or pair) either
    way.  The fixed buffers stay the run's: rho, u and the windows are the
    tensors sim_init made."""
    sims = []
    for tag in ("chunk", "loop"):
        if case == "d2q9_channel":
            sim = port_channel(tmp_path / tag, steps_per_dispatch=8)
        else:
            sim = port_box(tmp_path / tag, tag, pair_dispatch=case != "aa_box_force",
                           storage="float16" if case.endswith("f16") else None,
                           steps_per_dispatch=8)
        sim.collect_stats = sim.collect_stats2 = True
        sims.append(sim if tag == "chunk" else per_step_only(sim))
    chunk, loop = sims
    used = spy_chunks(chunk)
    for sim in sims:
        sim.sim_init()
        fixed = [id(getattr(sim, n)) for n in ("rho", "u", "vm", "vm2", "vm_b", "vm2_b")]
        for _ in range(3):
            sim._advance(sim.steps_per_dispatch)
            sim._after_sim_update()
        assert [id(getattr(sim, n)) for n in ("rho", "u", "vm", "vm2", "vm_b", "vm2_b")] == fixed
    assert used == [8, 8, 8] and chunk.iterations == loop.iterations == 24
    samples = 12 if chunk._pair is not None else 24
    assert chunk.stat_counter == loop.stat_counter == chunk.stat2_counter == samples
    for name in ("f", "rho", "u", "vm", "vm2", "vm_b", "vm2_b"):
        assert torch.equal(getattr(chunk, name), getattr(loop, name)), name
    wrapper = chunk._pair if chunk._pair is not None else chunk._step
    assert wrapper.plain_calls == samples and loop.f.dtype == torch.float32
    assert float(chunk.vm2[0].abs().max()) > 0


def test_chunked_run_matches_jax_scan(tmp_path):
    """The port's chunked run and the JAX ``Simulation``'s ``lax.scan`` run
    (8-step chunks) from one seeded state, with both statistics windows:
    f, rho, u, vm and vm2 within the step bounds times the step count."""
    port = port_channel(tmp_path, steps_per_dispatch=8)
    ref = jax_channel(tmp_path, steps_per_dispatch=8)
    used, jused = spy_chunks(port), []
    orig = ref._advance_scan
    ref._advance_scan = lambda n, nu, u, f: (jused.append(n), orig(n, nu, u, f))[1]
    f0 = seeded(CHANNEL, D2Q9)
    for sim in (port, ref):
        sim.collect_stats = sim.collect_stats2 = True
        sim.sim_init()
    port.f.copy_(torch.from_numpy(f0))
    ref.f = jnp.asarray(f0)
    for _ in range(3):
        for sim in (port, ref):
            sim._advance(8)
            sim._after_sim_update()
    assert used == jused == [8, 8, 8] and port.iterations == ref.iterations == 24
    n = port.iterations
    for name, tol in (("f", TOL_F), ("rho", TOL_RHO), ("u", TOL_U), ("vm", TOL_U),
                      ("vm2", TOL_U), ("vm_b", TOL_U), ("vm2_b", TOL_U)):
        d = float(np.abs(np.asarray(getattr(ref, name), np.float64)
                         - getattr(port, name).double().numpy()).max())
        assert d < n * tol, (name, d)
    assert port.stat_counter == ref.stat_counter == port.stat2_counter == 24


# ------------------------------------------------------------- the gate

def test_gate_admits_a_steady_chunk_and_refuses_the_rest(tmp_path):
    """Admitted: 8 steps of a steady inflow.  Refused, as by the JAX gate: a
    ramped inflow, an overridden compute_after_step, a @needs_per_step_state
    hook, an A-A chunk from an odd iteration, fewer than 4 steps, and a
    window switched on after sim_init until its first per-step sample
    allocates it.  The gate evaluates the inflow at each step's time until
    two differ, as the JAX gate does."""

    class Ramp(Channel):
        calls = 0

        def update_inflow(self, phys_time):
            self.calls += 1
            return np.array([0.05 * min(1.0, phys_time / 0.1), 0.0])

    class AfterStep(Channel):
        def compute_after_step(self):
            pass

    class PerStepState(Channel):
        @needs_per_step_state
        def compute_before_step(self):
            pass

    steady = port_channel(tmp_path, "steady")
    steady.sim_init()
    assert steady._scan_chunk_args(8) is not None
    u_in, force = steady._scan_chunk_args(8)
    assert np.array_equal(u_in, [0.05, 0.0]) and force is None
    assert steady._scan_chunk_args(3) is None
    steady.collect_stats = True  # on, not allocated yet
    assert steady._scan_chunk_args(8) is None
    steady._advance(1)
    assert steady.vm is not None and steady._scan_chunk_args(8) is not None
    for cls in (Ramp, AfterStep, PerStepState):
        sim = port_channel(tmp_path, cls.__name__, cls=cls, steps_per_dispatch=8)
        used = spy_chunks(sim)
        sim.sim_init()
        sim._advance(8)
        assert used == [] and sim.iterations == 8, cls.__name__
    assert sim._step.plain_calls == 8
    ramp = port_channel(tmp_path, "ramp_calls", cls=Ramp)
    ramp.sim_init()
    ramp._advance(8)
    assert ramp.calls == 1 + 1 + 7  # the first step's, the gate's second, the loop's 7 more
    box = port_box(tmp_path, "odd", steps_per_dispatch=8)
    used = spy_chunks(box)
    box.sim_init()
    box._advance(1)
    box._advance(8)
    assert used == [] and box.iterations == 9
    box._advance(1)
    box._advance(8)
    assert used == [8] and box.iterations == 18


# ------------------------------------------------- statistics windows

def test_statistics_windows_and_resets_match_jax(tmp_path):
    """Two windows with their own reset counters (JAX
    tests/test_driver.py:151-175), 4-step chunks: window 1 resets at steps
    4, 8 and 16, window 2 at steps 4 and 12; counters, reset counts and
    both windows' mean and covariance against the JAX run of the same
    channel."""
    sims = []
    for make in (port_channel, jax_channel):
        sim = make(tmp_path, phys_final_time=0.02, steps_per_dispatch=4)
        sim.collect_stats = sim.collect_stats2 = True
        sim.cnt[state.STAT_RESET].period = 0.007
        sim.cnt[state.STAT2_RESET].period = 0.011
        assert sim.run()
        sims.append(sim)
    port, ref = sims
    assert port.iterations == ref.iterations == 20
    assert (port.stat_counter, port.stat2_counter) == (ref.stat_counter, ref.stat2_counter)
    assert (port.stat_counter, port.stat2_counter) == (4, 8)
    assert (port.cnt[state.STAT_RESET].count, port.cnt[state.STAT2_RESET].count) == (3, 2)
    for name in (state.STAT_RESET, state.STAT2_RESET):
        assert port.cnt[name].count == ref.cnt[name].count
    for name in ("vm", "vm2", "vm_b", "vm2_b"):
        d = float(np.abs(np.asarray(getattr(ref, name), np.float64)
                         - getattr(port, name).double().numpy()).max())
        assert d < port.iterations * TOL_U, (name, d)
    assert not torch.allclose(port.vm, port.vm_b)
    assert state.ALL_COUNTERS == jstate.ALL_COUNTERS


# -------------------------------------------------------------- 1D probes

def read_dat(path):
    lines = path.read_text().splitlines()
    return lines[0], np.array([[float(x) for x in ln.split()] for ln in lines[1:]])


def test_probe_1d_files_match_jax(tmp_path):
    """A ``Probe1DCut`` across the channel and a ``Probe1DLine`` along it,
    written at every VTK1D action: the same files as the JAX run's, the
    headers equal, the rows parsed equal in time and index and within the
    step bounds in value."""
    sims = []
    for make, mod in ((port_channel, state), (jax_channel, jstate)):
        sim = make(tmp_path, phys_final_time=0.02, steps_per_dispatch=5)
        sim.cnt[mod.VTK1D].period = 0.01
        sim.probes_1d.append(mod.Probe1DCut(axis=1, name="prof", pos=(16,)))
        sim.probes_1d_line.append(mod.Probe1DLine(name="line", start=(0.02, 0.08),
                                                  end=(0.30, 0.08), n_samples=17))
        assert sim.run()
        sims.append(sim)
    port, ref = sims
    for name, n_rows in (("prof", 3 * 16), ("line", 3 * 17)):
        head_p, rows_p = read_dat(port.results_dir / "probes" / f"{name}.dat")
        head_j, rows_j = read_dat(ref.results_dir / "probes" / f"{name}.dat")
        assert head_p == head_j and rows_p.shape == rows_j.shape == (n_rows, 2 + 3)
        np.testing.assert_array_equal(rows_p[:, :2], rows_j[:, :2])
        d = np.abs(rows_p[:, 2:] - rows_j[:, 2:]).max(axis=0)
        # lbm_density, then velocity_x/y in m/s (lattice units x dl/dt = 10)
        assert d[0] < 20 * TOL_RHO and (d[1:] < 20 * TOL_U * 10).all(), (name, d)
    assert [p.cycle for p in port.probes_1d + port.probes_1d_line] == [3, 3]
