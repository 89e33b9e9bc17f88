"""Checkpoints of the port on the CPU, held to the JAX package's.

``sim/checkpoint.py`` writes the JAX package's format (``checkpoint.npz``
with ``__meta__`` as uint8 JSON, published by rename), so a run
checkpointed by either package resumes in the other; a sharded JAX run's
per-device files load on one device.  ``Simulation.save_state`` and the
``loadstate`` resume, the walltime stop, the SAVESTATE counter through the
native background writer (``io/native.py``), and the extra arrays of
``CoupledSimulation`` and sim2d_2.  Bounds against the JAX package are the
per-step bounds of its kernel suite (tests/test_fused_kernel.py:65-67)
times the steps taken after the resume.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.sim import checkpoint as jckpt
from tnl_lbm_tpu_torch.apps import sim2d_2, sim_coupled
from tnl_lbm_tpu_torch.io import native
from tnl_lbm_tpu_torch.models import D2Q9
from tnl_lbm_tpu_torch.sim import checkpoint as ckpt
from tnl_lbm_tpu_torch.sim import state

from test_torch_driver import CHANNEL, TOL_F, TOL_RHO, TOL_U, jax_channel, port_channel, seeded
from torch_cases import compress_statistics

N_STEPS = M_STEPS = 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_np(x) -> np.ndarray:
    return x.double().cpu().numpy() if torch.is_tensor(x) else np.asarray(x, np.float64)


def start(sim, f0):
    """sim_init with both statistics windows, then the seeded state."""
    sim.collect_stats = sim.collect_stats2 = True
    sim.sim_init()
    if torch.is_tensor(sim.f):
        sim.f.copy_(torch.from_numpy(f0))
    else:
        sim.f = jnp.asarray(f0)
    return sim


def advance(sim, n):
    sim._advance(n)
    sim._after_sim_update()
    return sim


def assert_within(a, b, steps, what=""):
    for name, tol in (("f", TOL_F), ("rho", TOL_RHO), ("u", TOL_U), ("vm", TOL_U),
                      ("vm2", TOL_U), ("vm_b", TOL_U), ("vm2_b", TOL_U)):
        d = float(np.abs(as_np(getattr(a, name)) - as_np(getattr(b, name))).max())
        assert d < steps * tol, (what, name, d)
    assert (a.iterations, a.stat_counter, a.stat2_counter) == (
        b.iterations, b.stat_counter, b.stat2_counter), what


def test_checkpoints_resume_across_packages(tmp_path):
    """N steps in one package, ``save_state``, ``sim_init`` in the other
    package's run on the same directory (the loadstate flag), M more steps:
    the state, both statistics windows and the counters match the other
    package's uninterrupted N + M steps within the step bounds times M."""
    f0 = seeded(CHANNEL, D2Q9)
    whole = {name: advance(start(make(tmp_path / f"whole_{name}", steps_per_dispatch=8), f0),
                           N_STEPS + M_STEPS)
             for name, make in (("port", port_channel), ("jax", jax_channel))}
    for saver, resumer in ((jax_channel, port_channel), (port_channel, jax_channel)):
        where = tmp_path / f"{saver.__name__}_to_{resumer.__name__}"
        first = advance(start(saver(where, sim_id="run", steps_per_dispatch=8), f0), N_STEPS)
        first.save_state()
        assert first.flags.exists("loadstate") and (first.results_dir / "checkpoint.npz").exists()
        second = resumer(where, sim_id="run", steps_per_dispatch=8)
        second.collect_stats = second.collect_stats2 = True
        second.sim_init()
        assert (second.iterations, second.start_iterations, second.stat_counter) == (
            N_STEPS, N_STEPS, N_STEPS)
        np.testing.assert_array_equal(as_np(second.f), as_np(first.f))
        advance(second, M_STEPS)
        other = whole["jax" if resumer is port_channel else "port"]
        assert_within(second, other, M_STEPS, f"{saver.__name__} -> {resumer.__name__}")


def test_sharded_jax_checkpoint_resumes_on_one_device(tmp_path):
    """A JAX checkpoint written per device (8 CPU devices, as
    tests/test_driver.py:177 makes it) loads in the port and resumes a run:
    the reassembled arrays equal the sharded ones."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("x", "y"))
    f0 = seeded(CHANNEL, D2Q9)
    sharded = jax.device_put(jnp.asarray(f0), NamedSharding(mesh, P(None, "x", "y")))
    sim = port_channel(tmp_path, sim_id="sharded")
    jckpt.save_checkpoint(sim.results_dir, {"f": sharded},
                          {"iterations": 6, "stat_counter": 0, "stat2_counter": 0,
                           "counters": {state.PRINT: 3}, "probe_cycles": {}})
    assert len(list(sim.results_dir.glob("checkpoint_shard*.npz"))) == 8
    arrays, meta = ckpt.load_checkpoint(sim.results_dir)
    np.testing.assert_array_equal(arrays["f"], f0)
    assert meta["iterations"] == 6 and "__shards__" not in meta
    sim.flags.create("loadstate")
    sim.sim_init()
    assert sim.iterations == 6 and sim.cnt[state.PRINT].count == 3
    np.testing.assert_array_equal(sim.f.numpy(), f0)
    # the port's next save replaces it with one file and drops the shard files
    sim.save_state()
    assert not list(sim.results_dir.glob("checkpoint_shard*.npz"))
    np.testing.assert_array_equal(ckpt.load_checkpoint(sim.results_dir)[0]["f"], f0)


def test_torn_or_partial_sharded_checkpoint_raises(tmp_path):
    """A main file that expects another epoch than its shard files carry,
    or shard parts that do not cover an array, refuse to load."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("x",))
    big = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    jckpt.save_checkpoint(tmp_path, {"f": jax.device_put(jnp.asarray(big),
                                                         NamedSharding(mesh, P("x")))},
                          {"iterations": 1})
    np.testing.assert_array_equal(ckpt.load_checkpoint(tmp_path)[0]["f"], big)
    with np.load(tmp_path / "checkpoint.npz") as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
    epoch = meta["__epoch__"]

    def publish(m):
        np.savez(tmp_path / "checkpoint.npz",
                 __meta__=np.frombuffer(json.dumps(m).encode(), np.uint8))

    # the main file expects another epoch than the one its shard files carry
    renamed = [p.rename(p.with_name(p.name.replace(str(epoch), str(epoch - 7))))
               for p in tmp_path.glob(f"checkpoint_shard*_{epoch}.npz")]
    publish({**meta, "__epoch__": epoch - 7})
    with pytest.raises(RuntimeError, match="torn checkpoint"):
        ckpt.load_checkpoint(tmp_path)
    for p in renamed:
        p.rename(p.with_name(p.name.replace(str(epoch - 7), str(epoch))))
    # parts that miss a block of the array
    partial = json.loads(json.dumps(meta))
    partial["__shards__"]["f"]["parts"] = partial["__shards__"]["f"]["parts"][1:]
    publish(partial)
    with pytest.raises(RuntimeError, match="cover"):
        ckpt.load_checkpoint(tmp_path)
    publish(meta)
    np.testing.assert_array_equal(ckpt.load_checkpoint(tmp_path)[0]["f"], big)


def test_walltime_stop_saves_and_the_rerun_resumes(tmp_path):
    """A run past its wall-time limit saves and sets loadstate instead of
    finishing; run again, it resumes there and ends where an uninterrupted
    run ends, bit for bit."""
    whole = port_channel(tmp_path / "whole", phys_final_time=0.016, steps_per_dispatch=8)
    assert whole.run()
    cut = port_channel(tmp_path / "cut", phys_final_time=0.016, steps_per_dispatch=8,
                       wall_time_limit=0.0)
    assert cut.run() and cut.iterations == 8
    assert cut.flags.exists("loadstate") and not cut.flags.exists("finished")
    assert ckpt.load_checkpoint(cut.results_dir)[1]["iterations"] == 8
    rerun = port_channel(tmp_path / "cut", phys_final_time=0.016, steps_per_dispatch=8)
    assert rerun.run() and rerun.start_iterations == 8 and rerun.iterations == 16
    assert rerun.flags.exists("finished")
    for name in ("f", "rho", "u"):
        assert torch.equal(getattr(rerun, name), getattr(whole, name)), name


def test_savestate_counter_saves_in_the_background(tmp_path):
    """SAVESTATE (wall seconds) skips its first action and then saves
    through the native writer; the run's end flushes it: the last file
    holds the final state, and no write failed."""
    sim = port_channel(tmp_path, phys_final_time=0.012, steps_per_dispatch=4)
    sim.cnt[state.SAVESTATE].period = 1e-9
    saves = []
    orig = sim.save_state
    sim.save_state = lambda background=False: (saves.append(background), orig(background))
    assert sim.run()
    assert saves == [True, True] and native.loaded() and native.errors() == 0
    arrays, meta = ckpt.load_checkpoint(sim.results_dir)
    assert meta["iterations"] == 12 and meta["counters"][state.SAVESTATE] == 3
    np.testing.assert_array_equal(arrays["f"], sim.f.numpy())
    assert not list(sim.results_dir.glob("*.tmp"))


def test_native_writer_writes_and_flushes(tmp_path):
    """The port's bindings to native/lbm_io.cpp: a blob and a VTI payload
    (header, each blob after its uint64 length, footer), published by
    rename, on disk after ``flush``."""
    blob = bytes(range(256)) * 64
    native.write_blob_async(tmp_path / "a" / "blob.bin", blob)
    arr = np.arange(10, dtype=np.float32)
    native.write_vti_async(tmp_path / "v.vti", b"<head>", b"</foot>", [arr, b"xy"])
    native.flush()
    assert (tmp_path / "a" / "blob.bin").read_bytes() == blob
    want = (b"<head>" + np.uint64(40).tobytes() + arr.tobytes() + np.uint64(2).tobytes()
            + b"xy" + b"</foot>")
    assert (tmp_path / "v.vti").read_bytes() == want
    assert native.errors() == 0 and native.library_path().exists()


def test_coupled_run_resumes_with_g(tmp_path):
    """sim_coupled at resolution 1 (the coupled step's plain version): 2
    steps, a checkpoint with g beside f, a resumed run of 2 more, equal to
    4 uninterrupted steps in f, g, rho, u and phi, bit for bit."""
    def build(where):
        sim = sim_coupled.build(1, use_fused=True, results_parent=where, device="cpu")
        sim.cnt[state.PRINT].period = -1
        sim.cnt[state.VTK2D].period = -1
        sim.sim_init()
        return sim

    whole = advance(build(tmp_path / "whole"), 4)
    first = advance(build(tmp_path / "cut"), 2)
    first.save_state()
    assert set(ckpt.load_checkpoint(first.results_dir)[0]) == {"f", "g"}
    second = advance(build(tmp_path / "cut"), 2)
    assert second.start_iterations == 2 and second.iterations == 4
    for name in ("f", "g", "rho", "u", "phi"):
        assert torch.equal(getattr(second, name), getattr(whole, name)), name


def test_sim2d_2_resumes_with_its_accumulators(tmp_path, geometry_1):
    """sim2d_2 at resolution 1 with its statistics from step 2: 5 steps, a
    checkpoint with its accumulators under the JAX app's names, a resumed
    run of 3 more, the running sum equal to 8 uninterrupted steps', bit for
    bit."""
    def build(where):
        sim = sim2d_2.build(1, str(geometry_1), results_parent=where, device="cpu")
        compress_statistics(sim)
        sim.cnt[state.PRINT].period = sim.cnt[state.PROBE1].period = -1
        sim.sim_init()
        return sim

    whole = advance(build(tmp_path / "whole"), 8)
    first = advance(build(tmp_path / "cut"), 5)
    first.save_state()
    assert "s2d2_sum_v" in ckpt.load_checkpoint(first.results_dir)[0]
    second = build(tmp_path / "cut")
    assert torch.equal(second.sum_v, first.sum_v) and second.iterations == 5
    advance(second, 3)
    for name in ("f", "rho", "u", "sum_v"):
        assert torch.equal(getattr(second, name), getattr(whole, name)), name


def test_sim2d_2_frozen_mean_stays_under_the_shared_macro_buffers(tmp_path, geometry_1):
    """The kernel routes write rho and u into the same two tensors every
    step; sim2d_2's frozen mean, taken from its running sum, must not move
    with them once frozen."""
    sim = sim2d_2.build(1, str(geometry_1), results_parent=tmp_path, device="cpu")
    compress_statistics(sim)
    sim.sim_init()
    u_buffer = sim.u
    while not sim.means_frozen:
        advance(sim, 1)
    frozen, u_then = sim.frozen_mean.clone(), sim.u.clone()
    for _ in range(4):
        advance(sim, 1)
    assert sim.u is u_buffer and not torch.equal(sim.u, u_then)
    assert sim.frozen_mean is not sim.u and torch.equal(sim.frozen_mean, frozen)


@pytest.fixture(scope="module")
def geometry_1(tmp_path_factory):
    import subprocess
    import sys
    from pathlib import Path

    out = tmp_path_factory.mktemp("geos")
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, str(root / "scripts" / "make_golden_geometries.py"),
                    str(out)], check=True, capture_output=True)
    return out / "1.txt"
