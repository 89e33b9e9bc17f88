#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tnl_lbm_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It drives the port's main path - D3Q27 CUM_WELL in float32 with A-A
streaming on a square duct, through the even/odd CUDA kernels - in phases,
each printing one line of results; any failing phase raises and the script
exits non-zero without printing a result.

1. device: the card, ``nvidia-smi`` name and power limit, torch/CUDA versions;
2. build: compile the kernels from ``tnl_lbm_tpu_torch/csrc`` (registers,
   shared memory and spills from ``-Xptxas -v``);
3. kernel vs plain: sim_2's res-2 duct (32x64x64, WALL + NOTHING, periodic
   x), 4 alternating steps through the kernels and through their plain
   PyTorch versions on the card; max |df| <= 1e-6, |drho| <= 2e-6,
   |du| <= 1e-6 (the JAX suite's bounds, tests/test_fused_kernel.py:65-67);
   then one step of each kernel against its plain version at 256^3, timed;
4. main path: ``Simulation`` on the 256^3 bench duct, 200 per-step
   dispatches; ms/step, MLUPS (X*Y*Z*steps / compute time), peak memory,
   launch counts of both kernels (> 0) and plain calls (0), finite rho/u;
5. accuracy: sim_2 res 2 (``--streaming AA --use-fused --pair-dispatch off``)
   run to its stopping point (the stopping criterion, or the default final
   time t = 200 s, which comes first for this duct); its L1 error must lie
   within 5% of the L1 that the analytic start-up solution of the duct
   (``sim_2.duct_startup_ux``, bounce-back walls half-way to the first fluid
   site) has at the same iteration.  The JAX package's recorded 1.074e-4
   (docs/PERFORMANCE.md:58) is a reading of this transient near t = 5 s and
   is printed for comparison.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
NU, FORCE_SMALL, FORCE_BENCH = 0.02, 1e-5, 1e-6
TOL_F, TOL_RHO, TOL_U = 1e-6, 2e-6, 1e-6
L1_JAX_RECORDED = 1.074e-4  # docs/PERFORMANCE.md:58, a transient reading
BENCH_SHAPE = (256, 256, 256)
BENCH_STEPS = 200


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def rand_f(cfg, shape, device, seed=0):
    """Seeded near-equilibrium state (tests/test_fused_kernel.py:25-29)."""
    import torch

    rng = np.random.default_rng(seed)
    rho = torch.from_numpy((1 + 0.01 * rng.standard_normal(shape)).astype(np.float32))
    u = torch.from_numpy((0.02 * rng.standard_normal((3,) + shape)).astype(np.float32))
    return cfg.eq(cfg.lat, rho.to(device), u.to(device)).float().contiguous()


def flagship(shape):
    """The bench duct: walls on the y and z faces, periodic in x
    (__graft_entry__.py:17-44), with lattice viscosity NU."""
    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.ops.boundary import GEO

    m = np.zeros(shape, np.uint8)
    m[:, 0] = m[:, -1] = GEO.WALL
    m[:, :, 0] = m[:, :, -1] = GEO.WALL
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AA")
    dom = interop.domain_from_numpy(m, (True, False, False), phys_viscosity=NU)
    return cfg, dom


def max_diff(a, b) -> float:
    return float((a - b).abs().max())


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps calls, from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> dict:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    log("device", name=repr(info["kind"]), count=info["count"], nvidia_smi=repr(smi),
        torch=torch.__version__, cuda=torch.version.cuda)
    return info


def phase_build() -> None:
    from tnl_lbm_tpu_torch.kernels.build import build_library, kernel_resources, load_library

    t0 = time.perf_counter()
    _, ptxas = build_library()
    load_library()
    res = kernel_resources(ptxas)
    for name in ("aa_even_kernel", "aa_odd_kernel"):
        if name not in res:
            raise RuntimeError(f"no ptxas report for {name}:\n{ptxas}")
        log("build", kernel=name, **res[name])
    log("build", seconds=f"{time.perf_counter() - t0:.1f}")


def phase_compare() -> dict:
    """Kernels vs their plain versions on the card; returns per-kernel
    max |df| and times at 256^3."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim_2
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa

    dev = torch.device("cuda")
    sim = sim_2.build(2, device=dev, streaming="AA", use_fused=True,
                      results_parent=WORK / "compare")
    cfg, dom = sim.cfg, sim.domain
    step = make_fused_step_aa(cfg, dom, dev)
    force = (FORCE_SMALL, 0.0, 0.0)
    err = {"even": 0.0, "odd": 0.0}
    worst = [0.0, 0.0, 0.0]
    fk = rand_f(cfg, dom.shape, dev, seed=5)
    fp = fk.clone()
    for it in range(4):
        parity = it % 2
        fk, rk, uk = step(fk, NU, force=force, parity=parity)
        fp, rp, up = step.plain(fp, NU, force=force, parity=parity)
        torch.cuda.synchronize()
        d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
        worst = [max(a, b) for a, b in zip(worst, d)]
        name = ("even", "odd")[parity]
        err[name] = max(err[name], d[0])
    log("compare", shape="x".join(map(str, dom.shape)), steps=4, max_df=worst[0],
        max_drho=worst[1], max_du=worst[2], launches_even=step.even.launches,
        launches_odd=step.odd.launches)
    if not (worst[0] <= TOL_F and worst[1] <= TOL_RHO and worst[2] <= TOL_U):
        raise RuntimeError(f"kernel vs plain out of tolerance: {worst}")

    # one step of each kernel against its plain version at the bench shape
    cfg, dom = flagship(BENCH_SHAPE)
    step = make_fused_step_aa(cfg, dom, dev)
    bench_force = (FORCE_BENCH, 0.0, 0.0)
    f0 = rand_f(cfg, dom.shape, dev, seed=7)
    times = {}
    for parity, name in ((0, "even"), (1, "odd")):
        fk, rk, uk = step(f0.clone(), NU, force=bench_force, parity=parity)
        fp, rp, up = step.plain(f0, NU, force=bench_force, parity=parity)
        d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
        del fk, rk, uk, fp, rp, up
        if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
            raise RuntimeError(f"{name} kernel vs plain at 256^3 out of tolerance: {d}")
        err[name] = max(err[name], d[0])
        fw = f0.clone()
        ms = time_ms(lambda: step(fw, NU, force=bench_force, parity=parity), reps=20)
        plain_ms = time_ms(lambda: step.plain(f0, NU, force=bench_force, parity=parity), reps=3)
        del fw
        torch.cuda.empty_cache()
        sites = float(np.prod(BENCH_SHAPE))
        times[name] = (ms, plain_ms)
        log("compare", kernel=name, shape="256^3", max_df=d[0], max_drho=d[1], max_du=d[2],
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}",
            gbps_216B=f"{216 * sites / (ms * 1e-3) / 1e9:.1f}")
    return {"err": err, "times": times}


def phase_main_path() -> dict:
    """Simulation on the 256^3 bench duct: 200 per-step kernel dispatches."""
    import torch

    from tnl_lbm_tpu_torch.sim.state import Simulation

    class BenchDuct(Simulation):
        def body_force(self, phys_time):
            return np.array([FORCE_BENCH, 0.0, 0.0])

        def sim_init(self):
            super().sim_init()
            self._step.reset_counts()  # count only this run's launches
            torch.cuda.reset_peak_memory_stats()

    cfg, dom = flagship(BENCH_SHAPE)
    sim = BenchDuct(cfg, dom, device="cuda", sim_id="bench_duct", results_parent=WORK / "main",
                    phys_final_time=BENCH_STEPS * dom.units.phys_dt, steps_per_dispatch=10,
                    use_fused=True, pair_dispatch=False)
    if not sim.run():
        raise RuntimeError("main-path run failed (NaN or refused)")
    step = sim._step
    finite = bool(torch.isfinite(sim.rho).all()) and bool(torch.isfinite(sim.u).all())
    steps = sim.iterations
    ms_step = sim._compute_time / steps * 1e3
    mlups = float(np.prod(BENCH_SHAPE)) * steps / sim._compute_time / 1e6
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log("main", shape="256^3", steps=steps, ms_per_step=f"{ms_step:.4f}", mlups=f"{mlups:.1f}",
        max_memory_allocated_gb=f"{peak_gb:.3f}", launches_even=step.even.launches,
        launches_odd=step.odd.launches, plain_calls=step.plain_calls, finite=finite)
    if steps != BENCH_STEPS or step.even.launches <= 0 or step.odd.launches <= 0:
        raise RuntimeError("the main path did not run through both kernels")
    if step.plain_calls != 0 or not finite:
        raise RuntimeError("the main path called the plain version or produced non-finite output")
    return {"even": step.even, "odd": step.odd}


def phase_accuracy() -> None:
    from tnl_lbm_tpu_torch.apps import sim_2

    t0 = time.perf_counter()
    sim = sim_2.main(["2", "--device", "cuda", "--streaming", "AA", "--use-fused",
                      "--pair-dispatch", "off", "--results-dir", str(WORK / "accuracy")])
    wall = time.perf_counter() - t0
    l1, l2 = sim.last_errors
    X, Y, Z = sim.domain.shape
    startup = sim_2.duct_startup_ux(Y, Z, sim.fx_lbm, sim.domain.units.lbm_viscosity(),
                                    sim.iterations, wall_sites=2)
    l1_ref, _ = sim_2.duct_errors(np.broadcast_to(startup, (X, Y, Z)), sim.analytical,
                                  sim.domain.units)
    rel = abs(l1 / l1_ref - 1)
    log("accuracy", l1=f"{l1:.6e}", l2=f"{l2:.6e}", iterations=sim.iterations,
        stop=sim.terminate_reason or "final_time", wall_s=f"{wall:.1f}",
        l1_startup_solution=f"{l1_ref:.6e}", rel_to_startup=f"{rel:.2e}",
        l1_jax_recorded=L1_JAX_RECORDED, launches_even=sim._step.even.launches,
        launches_odd=sim._step.odd.launches)
    if sim.nan_detected or not rel <= 0.05 or sim._step.plain_calls:
        raise RuntimeError(f"sim_2 res 2: L1 {l1:e} not within 5% of the start-up "
                           f"solution's {l1_ref:e}")


def main() -> int:
    if not (ROOT / "tnl_lbm_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    shutil.rmtree(WORK, ignore_errors=True)
    device = phase_device()
    phase_build()
    cmp = phase_compare()
    kernels = phase_main_path()
    phase_accuracy()
    record = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": k.launches, "max_abs_err": cmp["err"][key],
         "ms": cmp["times"][key][0], "plain_ms": cmp["times"][key][1]}
        for key, k in kernels.items()
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
