#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tnl_lbm_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It drives the port's dispatch paths through the CUDA kernels: the A-A duct
(D3Q27 CUM_WELL on a square duct) per step (even/odd kernels) and in pairs
(the one-kernel pair, with the state in float32, float16 or bfloat16), and
the A-B step (B4) with the full 3D boundary set, on the bench duct and in
sim_1, sim_2 and sim_3.  Each phase prints result lines; any failing phase
raises and the script exits non-zero without printing a result.

1. device: the card, ``nvidia-smi`` name and power limit, torch/CUDA versions;
2. build: compile the kernels from ``tnl_lbm_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel; registers, shared memory and spills from
   ``-Xptxas -v``, and the pair's dynamic shared memory);
3. compare, kernels against their plain PyTorch versions on the card, with
   the JAX suite's bounds (tests/test_fused_kernel.py:65-67): |df| <= 1e-6
   (for a 16-bit state ``utils.dtypes.state_agrees``: one unit in its last
   place plus 2e-8, and at most 0.1% of the elements different at all),
   |drho| <= 2e-6, |du| <= 1e-6:
   a. even/odd: sim_2's res-2 duct (32x64x64, WALL + NOTHING, periodic x),
      4 alternating steps; then one step of each at 256^3, timed;
   b. pair, per store dtype: two pairs on the res-2 duct, each from the
      same input on both sides, and for a 16-bit state the float32 kernel's
      output on the widened input, narrowed, equal to the 16-bit kernel's
      bit for bit (the narrowing rounds to nearest even exactly); then one
      pair at 256^3, checked the same ways and timed beside one
      even plus one odd launch, with effective GB/s at 233 B/site per pair
      (125 B/site with 16-bit storage);
   c. the A-B step, after phase 4 so that it is timed beside P1: one step
      from a seeded random state on sim_2 res 2 A-B (CUM_WELL), sim_1 res 2
      (CUM, eq_inv_cum), sim_3 res 2 (CUM, eq_quadratic) and a box holding
      every code of the 3D set with a Z that the block's 128 z sites do
      not divide (CUM_WELL, then CUM); then one step at 256^3 on the bench
      duct, timed over 20 launches (plain: 3 calls) beside one even and one
      odd launch and the P1 floor, GB/s at 233 B/site;
4. probes: the copy floor P1 at 256^3 (GB/s at 232 B/site, share of the
   published 3.35 TB/s) and the pair's memory/compute split P2a/P2b at
   256^3 with 0, 20 and 60 passes, each held against its plain version;
5. main paths, each with the launch counts set to 0 just before it and read
   just after: ``Simulation`` on the 256^3 bench duct, 200 per-step A-A
   dispatches; ``pair_dispatch="auto"`` (the probe's choice and both
   times); 200 steps in pairs with the state in f32, f16 and bf16; 200
   A-B steps; sim_1 at resolution 8 (1024x256x256), 100 A-B steps, with
   one VTK2D cycle written and read back.  Each gives ms/step, MLUPS
   (X*Y*Z*steps / compute time), peak memory, kernel launches (> 0),
   plain calls (0) and finite rho/u.  Last, one A-B step from sim_1's
   final state at resolution 8, the kernel against its plain version
   with the step bounds (the launches of this compare are not counted);
6. accuracy: sim_2 res 2 run to its stopping point per step and in pairs
   (f32), and with A-B streaming through the A-B kernel; each L1 error must
   lie within 5% of the L1 that the analytic start-up solution of the duct
   (``sim_2.duct_startup_ux``) has at the same iteration.  Then
   ``--storage f16`` and ``--storage bf16``: their L1 beside the f32 pair
   run's at the same iteration; a non-finite result fails.  The JAX
   package's recorded 1.074e-4 (docs/PERFORMANCE.md:58) is a reading of
   this transient near t = 5 s and is printed for comparison.  Last, sim_1
   res 2 and sim_3 res 2, 100 steps each through ``Simulation`` with the
   A-B kernel and with the plain step on the card, from the same start:
   max |drho| and max |du| <= 1e-5.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
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
HBM_PEAK_GBPS = 3350.0  # H100 SXM data sheet
STORES = ("f32", "f16", "bf16")
PAIR_BYTES = {"f32": 233, "f16": 125, "bf16": 125}  # B/site per pair (f in + out, map, rho/u)
AB_BYTES = 233  # B/site per A-B step: 27 f32 in and out, the map, rho and u
AB_UIN = (0.03, 0.005, -0.004)  # inflow velocity of the box compare
SIM1_RES, APP_STEPS, TOL_APP = 8, 100, 1e-5
PROBE_PASSES = (0, 20, 60)
DEVICE = "cuda"


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def store_dtype(store: str):
    import torch

    return {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}[store]


def rand_f(cfg, shape, device, seed=0):
    """Seeded near-equilibrium state (tests/test_fused_kernel.py:25-29)."""
    import torch

    rng = np.random.default_rng(seed)
    rho = torch.from_numpy((1 + 0.01 * rng.standard_normal(shape)).astype(np.float32))
    u = torch.from_numpy((0.02 * rng.standard_normal((3,) + shape)).astype(np.float32))
    return cfg.eq(cfg.lat, rho.to(device), u.to(device)).float().contiguous()


def flagship(shape, storage=None, streaming="AA"):
    """The bench duct: walls on the y and z faces, periodic in x
    (__graft_entry__.py:17-44), with lattice viscosity NU."""
    import dataclasses

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.ops.boundary import GEO

    m = np.zeros(shape, np.uint8)
    m[:, 0] = m[:, -1] = GEO.WALL
    m[:, :, 0] = m[:, :, -1] = GEO.WALL
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, streaming)
    if storage not in (None, "f32"):
        cfg = dataclasses.replace(cfg, storage_dtype=store_dtype(storage))
    dom = interop.domain_from_numpy(m, (True, False, False), phys_viscosity=NU)
    return cfg, dom


def max_diff(a, b) -> float:
    """max |a - b| in float64; a [Q or 3, X, Y, Z] field one component at a
    time, so that no whole-state float64 temporary is made."""
    if a.ndim == 4:
        return max(max_diff(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max())


def bc_box(shape):
    """A closed box holding every GEO code of the 3D set: inflows (moment
    and equilibrium) on x = 0, the three outflows on x = X-1, symmetry
    planes on the y and z faces and on patches of x = 1 and x = X-2, a
    PERIODIC-coded block, walls and NOTHING sites inside."""
    from tnl_lbm_tpu_torch.ops.boundary import GEO

    X, Y, Z = shape
    m = np.zeros(shape, np.uint8)
    m[1:-1, 0], m[1:-1, -1] = GEO.SYM_BACK, GEO.SYM_FRONT
    m[1:-1, 1:-1, 0], m[1:-1, 1:-1, -1] = GEO.SYM_BOTTOM, GEO.SYM_TOP
    m[0, : Y // 2], m[0, Y // 2 :] = GEO.INFLOW_LEFT, GEO.INFLOW
    m[-1, : Y // 3], m[-1, Y // 3 : 2 * Y // 3] = GEO.OUTFLOW_EQ, GEO.OUTFLOW_RIGHT
    m[-1, 2 * Y // 3 :] = GEO.OUTFLOW_RIGHT_INTERP
    m[1, 1 : Y // 2, 1:-1], m[-2, Y // 2 : -1, 1:-1] = GEO.SYM_LEFT, GEO.SYM_RIGHT
    m[X // 2 - 1 : X // 2 + 1, 2:4, 1:-1] = GEO.PERIODIC
    m[X // 2, Y // 2 : Y // 2 + 2, Z // 3 : Z // 2] = GEO.WALL
    m[X // 2 + 1, -3, 1:3] = GEO.NOTHING
    return m


def read_vti(path) -> dict:
    """name -> float32 array [X, Y, Z] (scalars) or [3, X, Y, Z] (vectors)
    of a .vti written by ``io.vtk.write_vti`` (appended raw, uint64 sizes)."""
    import re

    raw = Path(path).read_bytes()
    head, body = raw.split(b"<AppendedData encoding=\"raw\">", 1)
    body = body[body.index(b"_") + 1 :]
    x0, x1, y0, y1, z0, z1 = map(int, re.search(rb'WholeExtent="([^"]+)"', head).group(1).split())
    shape = (z1 - z0 + 1, y1 - y0 + 1, x1 - x0 + 1)
    out = {}
    for name, comps, offset in re.findall(
            rb'Name="(\w+)" NumberOfComponents="(\d)" format="appended" offset="(\d+)"', head):
        n = int(np.frombuffer(body, "<u8", 1, int(offset))[0])
        a = np.frombuffer(body, "<f4", n // 4, int(offset) + 8)
        if int(comps) == 1:
            out[name.decode()] = a.reshape(shape).transpose(2, 1, 0)
        else:
            out[name.decode()] = a.reshape(shape + (3,)).transpose(3, 2, 1, 0)
    return out


def narrowing_exact(cfg, dom, f, fk, rk, uk, force) -> bool:
    """The 16-bit pair kernel's output (fk, rk, uk) on f equals the float32
    kernel's on the widened f, with the state narrowed: widening is exact,
    so the two instances differ only in the narrowing."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused_aa import from_storage, make_fused_pair2_aa, to_storage

    if f.dtype == torch.float32:
        return True
    fw, rw, uw = make_fused_pair2_aa(cfg, dom, f.device)(from_storage(f, torch.float32), NU,
                                                         force=force)
    return (torch.equal(to_storage(fw, f.dtype), fk) and torch.equal(rw, rk)
            and torch.equal(uw, uk))


def share_differing(a, b) -> float:
    return float((a != b).double().mean())


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


def gbps(bytes_per_site: float, ms: float) -> float:
    return bytes_per_site * float(np.prod(BENCH_SHAPE)) / (ms * 1e-3) / 1e9


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
    lib = load_library()
    res = kernel_resources(ptxas)
    for name in ("aa_even_kernel", "aa_odd_kernel", "aa_pair_f32_kernel", "aa_pair_f16_kernel",
                 "aa_pair_bf16_kernel", "ab_step_cum_well_kernel", "ab_step_cum_quad_kernel",
                 "ab_step_cum_invcum_kernel", "copy_permute_kernel", "pair_pipeline_kernel",
                 "pair_compute_only_kernel"):
        if name not in res:
            raise RuntimeError(f"no ptxas report for {name}:\n{ptxas}")
        log("build", kernel=name, **res[name])
    log("build", seconds=f"{time.perf_counter() - t0:.1f}",
        pair_dynamic_smem_bytes=lib.tnl_lbm_aa_pair_smem_bytes())


def phase_compare_steps() -> dict:
    """Even/odd kernels vs their plain versions; per-kernel max |df| and
    times at 256^3."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim_2
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa

    dev = torch.device(DEVICE)
    sim = sim_2.build(2, device=dev, streaming="AA", use_fused=True,
                      results_parent=WORK / "compare")
    cfg, dom = sim.cfg, sim.domain
    step = make_fused_step_aa(cfg, dom, dev)
    force = (FORCE_SMALL, 0.0, 0.0)
    err = {"aa_even": 0.0, "aa_odd": 0.0}
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
        name = ("aa_even", "aa_odd")[parity]
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
    for parity, name in ((0, "aa_even"), (1, "aa_odd")):
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
        times[name] = (ms, plain_ms)
        log("compare", kernel=name, shape="256^3", max_df=d[0], max_drho=d[1], max_du=d[2],
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}", gbps_216B=f"{gbps(216, ms):.1f}")
    return {"err": err, "times": times}


def phase_compare_pairs(step_times: dict) -> dict:
    """The pair kernel vs its plain version per store dtype, at res 2 and
    at 256^3; timed beside one even plus one odd launch."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim_2
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair2_aa, to_storage
    from tnl_lbm_tpu_torch.utils.dtypes import state_agrees

    dev = torch.device(DEVICE)
    two_steps_ms = step_times["aa_even"][0] + step_times["aa_odd"][0]
    err, times = {}, {}
    for store in STORES:
        dtype = store_dtype(store)
        name = f"aa_pair_{store}"
        sim = sim_2.build(2, device=dev, streaming="AA", use_fused=True,
                          results_parent=WORK / "compare" / store)
        pair = make_fused_pair2_aa(sim.cfg, sim.domain, dev, store_dtype=dtype)
        force = (FORCE_SMALL, 0.0, 0.0)
        f = to_storage(rand_f(sim.cfg, sim.domain.shape, dev, seed=5), dtype)
        worst = [0.0, 0.0, 0.0, 0.0]
        for it in range(2):
            fk, rk, uk = pair(f, NU, force=force)
            fp, rp, up = pair.plain(f, NU, force=force)
            torch.cuda.synchronize()
            d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up), share_differing(fk, fp))
            worst = [max(a, b) for a, b in zip(worst, d)]
            if not (state_agrees(fk, fp, dtype) and d[1] <= TOL_RHO and d[2] <= TOL_U):
                raise RuntimeError(f"{name} vs plain on the res-2 duct, pair {it}: {d}")
            if not narrowing_exact(sim.cfg, sim.domain, f, fk, rk, uk, force):
                raise RuntimeError(f"{name} on the res-2 duct, pair {it}: not the float32 "
                                   f"kernel's output narrowed to nearest even")
            f = fk
        log("compare", kernel=name, shape="x".join(map(str, sim.domain.shape)), pairs=2,
            max_df=worst[0], max_drho=worst[1], max_du=worst[2], share_f_differing=worst[3],
            narrowing_exact=True, launches=pair.kernel.launches)

        cfg, dom = flagship(BENCH_SHAPE)
        pair = make_fused_pair2_aa(cfg, dom, dev, store_dtype=dtype)
        bench_force = (FORCE_BENCH, 0.0, 0.0)
        f0 = to_storage(rand_f(cfg, dom.shape, dev, seed=7), dtype)
        fk, rk, uk = pair(f0, NU, force=bench_force)
        fp, rp, up = pair.plain(f0, NU, force=bench_force)
        ok = state_agrees(fk, fp, dtype)
        d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up), share_differing(fk, fp))
        del fp, rp, up
        torch.cuda.empty_cache()
        if not (ok and d[1] <= TOL_RHO and d[2] <= TOL_U):
            raise RuntimeError(f"{name} vs plain at 256^3 out of tolerance: {d}")
        if not narrowing_exact(cfg, dom, f0, fk, rk, uk, bench_force):
            raise RuntimeError(f"{name} at 256^3: not the float32 kernel's output narrowed "
                               f"to nearest even")
        del fk, rk, uk
        torch.cuda.empty_cache()
        err[name] = max(worst[0], d[0])
        out = torch.empty_like(f0)
        ms = time_ms(lambda: pair(f0, NU, force=bench_force, out=out), reps=20)
        plain_ms = time_ms(lambda: pair.plain(f0, NU, force=bench_force), reps=3)
        del f0, out
        torch.cuda.empty_cache()
        times[name] = (ms, plain_ms)
        log("compare", kernel=name, shape="256^3", max_df=d[0], max_drho=d[1], max_du=d[2],
            share_f_differing=d[3], narrowing_exact=True, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.2f}", even_plus_odd_ms=f"{two_steps_ms:.4f}",
            pair_over_two_launches=f"{ms / two_steps_ms:.3f}",
            **{f"gbps_{PAIR_BYTES[store]}B": f"{gbps(PAIR_BYTES[store], ms):.1f}"})
    return {"err": err, "times": times}


def phase_probes() -> dict:
    """P1 and P2 at 256^3 against their plain versions, then timed with the
    launch counts set to 0 just before."""
    import torch

    from tnl_lbm_tpu_torch.kernels import probes
    from tnl_lbm_tpu_torch.kernels.fused_aa import PAIR_TILE

    dev = torch.device(DEVICE)
    f = torch.randn((27,) + BENCH_SHAPE, device=dev, generator=torch.Generator(dev).manual_seed(3))
    err = {}
    got, want = probes.copy_permute(f), probes.copy_permute_plain(f)
    err["copy_permute"] = max(max_diff(g, w) for g, w in zip(got, want))
    del got, want
    for passes in PROBE_PASSES:
        d = max_diff(probes.pair_pipeline(f, passes), probes.pair_pipeline_plain(f, passes))
        err["pair_pipeline"] = max(err.get("pair_pipeline", 0.0), d)
        d = max_diff(probes.pair_compute_only(f, passes), probes.pair_compute_only_plain(f, passes))
        err["pair_compute_only"] = max(err.get("pair_compute_only", 0.0), d)
    torch.cuda.synchronize()
    log("probes", compare="kernel vs plain at 256^3", **{f"max_abs_err_{k}": v for k, v in err.items()})
    if any(v != 0.0 for v in err.values()):
        raise RuntimeError(f"probe kernels disagree with their plain versions: {err}")

    probes.reset_counts()
    times = {}
    ms = time_ms(lambda: probes.copy_permute(f), reps=20)
    plain_ms = time_ms(lambda: probes.copy_permute_plain(f), reps=3)
    times["copy_permute"] = (ms, plain_ms)
    floor = gbps(232, ms)
    log("probes", kernel="copy_permute", shape="256^3", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}",
        gbps_232B=f"{floor:.1f}", share_of_3350=f"{floor / HBM_PEAK_GBPS:.3f}")
    window_reads = np.prod([t + 2 for t in PAIR_TILE]) / np.prod(PAIR_TILE)  # sites read per site
    for passes in PROBE_PASSES:
        ms = time_ms(lambda: probes.pair_pipeline(f, passes), reps=20)
        plain_ms = time_ms(lambda: probes.pair_pipeline_plain(f, passes), reps=3)
        co_ms = time_ms(lambda: probes.pair_compute_only(f, passes), reps=20)
        co_plain_ms = time_ms(lambda: probes.pair_compute_only_plain(f, passes), reps=3)
        if passes == 20:
            times["pair_pipeline"] = (ms, plain_ms)
            times["pair_compute_only"] = (co_ms, co_plain_ms)
        log("probes", kernel="pair_pipeline", passes=passes, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.3f}", gbps_216B=f"{gbps(216, ms):.1f}",
            gbps_windows=f"{gbps(108 * (window_reads + 1), ms):.1f}")
        log("probes", kernel="pair_compute_only", passes=passes, ms=f"{co_ms:.4f}",
            plain_ms=f"{co_plain_ms:.3f}")
    del f
    torch.cuda.empty_cache()
    counts = {k: v.launches for k, v in probes.KERNELS.items()}
    log("probes", launches=counts)
    if min(counts.values()) <= 0:
        raise RuntimeError("a probe kernel was not launched")
    return {"err": err, "times": times, "kernels": dict(probes.KERNELS)}


def ab_cases():
    """(label, cfg, domain, u_in) of the A-B compare: the three apps at
    resolution 2 and the box under CUM_WELL and CUM."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.apps import sim_1, sim_2, sim_3

    dev = torch.device(DEVICE)
    where = WORK / "compare_ab"
    sim = sim_2.build(2, device=dev, streaming="AB", use_fused=True, results_parent=where)
    yield "sim_2_res2_AB", sim.cfg, sim.domain, None
    for app in (sim_1, sim_3):
        sim = app.build(2, device=dev, results_parent=where)
        yield f"{app.__name__.rsplit('.', 1)[1]}_res2", sim.cfg, sim.domain, sim.update_inflow(0.0)
    box = interop.domain_from_numpy(bc_box((24, 20, 150)), (False, False, True))
    for spec in (("CUM_WELL", "EQ_WELL", True), ("CUM", "EQ", False)):
        yield f"box_{spec[0]}", interop.config_from_spec(*spec, "AB"), box, AB_UIN


def phase_compare_ab(step_times: dict, floor_gbps: float) -> dict:
    """The A-B kernel against its plain version, one step from a seeded
    random state per geometry; then at 256^3, timed beside one even and
    one odd launch and the P1 floor of this call."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step

    dev = torch.device(DEVICE)
    force = (FORCE_SMALL, 0.0, 0.0)
    worst_f = 0.0
    for label, cfg, dom, u_in in ab_cases():
        step = make_fused_step(cfg, dom, dev)
        f = rand_f(cfg, dom.shape, dev, seed=11)
        fk, rk, uk = step(f, NU, u_in=u_in, force=force)
        fp, rp, up = step.plain(f, NU, u_in=u_in, force=force)
        torch.cuda.synchronize()
        d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
        log("compare_ab", case=label, shape="x".join(map(str, dom.shape)),
            codes="+".join(sorted(c.name for c in step.codes)), max_df=d[0], max_drho=d[1],
            max_du=d[2], launches=step.kernel.launches)
        if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
            raise RuntimeError(f"ab_step vs plain on {label} out of tolerance: {d}")
        worst_f = max(worst_f, d[0])

    cfg, dom = flagship(BENCH_SHAPE, streaming="AB")
    step = make_fused_step(cfg, dom, dev)
    bench_force = (FORCE_BENCH, 0.0, 0.0)
    f0 = rand_f(cfg, dom.shape, dev, seed=7)
    fk, rk, uk = step(f0, NU, force=bench_force)
    fp, rp, up = step.plain(f0, NU, force=bench_force)
    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
    del fk, rk, uk, fp, rp, up
    torch.cuda.empty_cache()
    if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
        raise RuntimeError(f"ab_step vs plain at 256^3 out of tolerance: {d}")
    out = torch.empty_like(f0)
    ms = time_ms(lambda: step(f0, NU, force=bench_force, out=out), reps=20)
    plain_ms = time_ms(lambda: step.plain(f0, NU, force=bench_force), reps=3)
    del f0, out
    torch.cuda.empty_cache()
    rate = gbps(AB_BYTES, ms)
    log("compare_ab", kernel="ab_step", shape="256^3", max_df=d[0], max_drho=d[1], max_du=d[2],
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}", even_ms=f"{step_times['aa_even'][0]:.4f}",
        odd_ms=f"{step_times['aa_odd'][0]:.4f}", gbps_233B=f"{rate:.1f}",
        share_of_p1_floor=f"{rate / floor_gbps:.3f}", mlups_kernel=f"{np.prod(BENCH_SHAPE) / ms / 1e3:.1f}")
    return {"err": {"ab_step": max(worst_f, d[0])}, "times": {"ab_step": (ms, plain_ms)}}


def counting_from_init(sim):
    """Set the launch and plain-call counts and the peak-memory mark to 0 at
    the end of ``sim_init``, just before the stepping loop.  A subclass and
    not a wrapped method: a closure over ``sim`` would be a reference cycle
    that keeps the run's device state alive after ``del``."""
    import torch

    class Counted(type(sim)):
        def sim_init(self):
            super().sim_init()
            for k in (self._step, self._pair):
                if k is not None:
                    k.reset_counts()
            torch.cuda.reset_peak_memory_stats()

    sim.__class__ = Counted
    return sim


def bench_sim(pair_dispatch, storage=None, steps: int | None = None, streaming="AA"):
    """Simulation on the 256^3 bench duct, counted from the end of sim_init."""
    from tnl_lbm_tpu_torch.sim.state import Simulation

    class BenchDuct(Simulation):
        def body_force(self, phys_time):
            return np.array([FORCE_BENCH, 0.0, 0.0])

    cfg, dom = flagship(BENCH_SHAPE, storage, streaming)
    steps = BENCH_STEPS if steps is None else steps
    tag = f"{streaming}_{pair_dispatch}_{storage or 'f32'}"
    sim = counting_from_init(BenchDuct(
        cfg, dom, device=DEVICE, sim_id=f"bench_duct_{tag}", results_parent=WORK / "main",
        phys_final_time=steps * dom.units.phys_dt, steps_per_dispatch=10, use_fused=True,
        pair_dispatch=pair_dispatch))
    if not sim.run():
        raise RuntimeError(f"main-path run {tag} failed (NaN or refused)")
    return sim


def kernel_launches(sim) -> dict:
    """Launch counts of the kernels a Simulation dispatched to."""
    step = sim._step
    if hasattr(step, "even"):
        launches = {"even": step.even.launches, "odd": step.odd.launches}
        launches["pair"] = sim._pair.kernel.launches if sim._pair else 0
        return launches
    return {"ab": step.kernel.launches}


def report_main(sim, label: str) -> dict:
    import torch

    steps = sim.iterations
    ms_step = sim._compute_time / steps * 1e3
    mlups = float(np.prod(sim.domain.shape)) * steps / sim._compute_time / 1e6
    finite = bool(torch.isfinite(sim.rho).all()) and bool(torch.isfinite(sim.u).all())
    plain = sim._step.plain_calls + (sim._pair.plain_calls if sim._pair else 0)
    launches = kernel_launches(sim)
    log("main", path=label, shape="x".join(map(str, sim.domain.shape)), steps=steps,
        ms_per_step=f"{ms_step:.4f}", mlups=f"{mlups:.1f}",
        max_memory_allocated_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        **{f"launches_{k}": v for k, v in launches.items()}, plain_calls=plain, finite=finite)
    if plain != 0 or not finite:
        raise RuntimeError(f"{label}: called the plain version or produced non-finite output")
    return launches


def phase_main_path() -> dict:
    """Per-step dispatch, the "auto" probe, then pair dispatch per store dtype."""
    import torch

    sim = bench_sim(False)
    launches = report_main(sim, "per_step")
    if sim.iterations != BENCH_STEPS or launches["even"] <= 0 or launches["odd"] <= 0:
        raise RuntimeError("the per-step path did not run through both kernels")
    kernels = {"aa_even": sim._step.even, "aa_odd": sim._step.odd}
    del sim
    torch.cuda.empty_cache()

    sim = bench_sim("auto", steps=20)
    t_pair, t_steps = sim.pair_probe_ms
    launches = report_main(sim, "auto")
    log("main", path="auto", chose="pair" if sim.pair_dispatch else "per_step",
        probe_pair_ms=f"{t_pair:.4f}", probe_per_step_ms=f"{t_steps:.4f}")
    if launches["pair" if sim.pair_dispatch else "even"] <= 0:
        raise RuntimeError("the auto path did not run through the dispatch it chose")
    del sim
    torch.cuda.empty_cache()

    for store in STORES:
        sim = bench_sim(True, storage=store)
        launches = report_main(sim, f"pair_{store}")
        if sim.iterations != BENCH_STEPS or launches["pair"] <= 0 or sim.f.dtype != torch.float32:
            raise RuntimeError(f"the pair path ({store}) did not run through the pair kernel")
        kernels[f"aa_pair_{store}"] = sim._pair.kernel
        del sim
        torch.cuda.empty_cache()

    sim = bench_sim(False, streaming="AB")
    launches = report_main(sim, "ab_step")
    if sim.iterations != BENCH_STEPS or launches["ab"] != BENCH_STEPS:
        raise RuntimeError("the A-B path did not run every step through the A-B kernel")
    ab = sim._step.kernel
    del sim
    torch.cuda.empty_cache()

    sim = sim1_main_path()
    launches = report_main(sim, f"sim_1_res{SIM1_RES}")
    if sim.iterations != APP_STEPS or launches["ab"] != APP_STEPS:
        raise RuntimeError("sim_1 did not run every step through the A-B kernel")
    # the JSON record counts the launches of both A-B main paths
    kernels["ab_step"] = dataclasses.replace(ab, launches=ab.launches + launches["ab"])
    err = {"ab_step": sim1_kernel_vs_plain(sim)}
    del sim
    torch.cuda.empty_cache()
    return {"kernels": kernels, "err": err}


def sim1_main_path():
    """sim_1 at SIM1_RES through its ``build``, APP_STEPS A-B steps with its
    own probes (VTK3D, the whole lattice, is switched off: one cycle is
    1.1 GB of files), then one more VTK2D cycle from the final state, read
    back and held against the fields on the card."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim_1
    from tnl_lbm_tpu_torch.sim.state import VTK3D

    sim = sim_1.build(SIM1_RES, device=DEVICE, results_parent=WORK / "main")
    sim.phys_final_time = APP_STEPS * sim.domain.units.phys_dt
    sim.cnt[VTK3D].period = -1.0
    if not counting_from_init(sim).run():
        raise RuntimeError(f"sim_1 res {SIM1_RES} failed (NaN or refused)")
    sim._write_vtk_2d()
    for p in sim.probes_2d:
        got = read_vti(sim.results_dir / "vtk2D" / f"{p.name}_{p.cycle - 1:06d}.vti")
        sl = [slice(None)] * 3
        sl[p.axis] = slice(p.position, p.position + 1)
        scalars, vectors = sim.output_data(tuple(sl))
        want_rho = scalars["lbm_density"].cpu().numpy()
        want_u = vectors["velocity"].cpu().numpy()
        if not (np.array_equal(got["lbm_density"], want_rho)
                and np.array_equal(got["velocity"], want_u)):
            raise RuntimeError(f"sim_1 VTK2D cut {p.name} read back differs from the card's")
        log("main", path=f"sim_1_res{SIM1_RES}", vtk2d=p.name, cycles=p.cycle,
            read_back="equal", plane="x".join(map(str, want_rho.shape)))
    return sim


def sim1_kernel_vs_plain(sim) -> float:
    """One A-B step of sim_1 at SIM1_RES from the main path's final state:
    a fresh A-B kernel wrapper against its plain version on the card, with
    the step bounds.  The run's spare state buffer and macro fields are
    freed first; the plain version's peak memory is reported.  Returns
    max |df|."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step

    t = sim.phys_time()
    u_in, force = sim.update_inflow(t), sim.body_force(t)
    f, nu = sim.f, sim.domain.units.lbm_viscosity()
    sim._spare = sim.rho = sim.u = None
    torch.cuda.empty_cache()
    step = make_fused_step(sim.cfg, sim.domain, DEVICE)
    fk, rk, uk = step(f, nu, u_in=u_in, force=force)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fp, rp, up = step.plain(f, nu, u_in=u_in, force=force)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated()
    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
    log("main", path=f"sim_1_res{SIM1_RES}", compare="kernel vs plain, one step from the "
        "final state", shape="x".join(map(str, sim.domain.shape)), max_df=d[0], max_drho=d[1],
        max_du=d[2], plain_peak_gb=f"{plain_peak / 1e9:.3f}",
        plain_temporaries_gb=f"{(plain_peak - base) / 1e9:.3f}")
    del fk, rk, uk, fp, rp, up
    torch.cuda.empty_cache()
    if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
        raise RuntimeError(f"ab_step vs plain on sim_1 res {SIM1_RES} out of tolerance: {d}")
    return d[0]


def startup_l1(sim, iterations: int) -> float:
    from tnl_lbm_tpu_torch.apps import sim_2

    X, Y, Z = sim.domain.shape
    u0 = sim_2.duct_startup_ux(Y, Z, sim.fx_lbm, sim.domain.units.lbm_viscosity(),
                               iterations, wall_sites=2)
    return sim_2.duct_errors(np.broadcast_to(u0, (X, Y, Z)), sim.analytical, sim.domain.units)[0]


def run_sim2(label: str, args: list):
    from tnl_lbm_tpu_torch.apps import sim_2

    t0 = time.perf_counter()
    sim = sim_2.main(["2", "--device", DEVICE, *args, "--results-dir", str(WORK / label)])
    return sim, time.perf_counter() - t0


def phase_accuracy() -> None:
    checked = {}
    for label, args in (("per_step", ["--streaming", "AA", "--use-fused", "--pair-dispatch", "off"]),
                        ("pair_f32", ["--streaming", "AA", "--use-fused", "--pair-dispatch", "on"])):
        sim, wall = run_sim2(label, args)
        it, l1, l2 = sim.error_history[-1]  # the last probe
        l1_ref = startup_l1(sim, it)
        rel = abs(l1 / l1_ref - 1)
        kernel = sim._pair.kernel if sim.pair_dispatch else sim._step.odd
        plain = sim._step.plain_calls + (sim._pair.plain_calls if sim._pair else 0)
        log("accuracy", path=label, l1=f"{l1:.6e}", l2=f"{l2:.6e}", iterations=it,
            stop=sim.terminate_reason or "final_time", wall_s=f"{wall:.1f}",
            l1_startup_solution=f"{l1_ref:.6e}", rel_to_startup=f"{rel:.2e}",
            l1_jax_recorded=L1_JAX_RECORDED, launches=kernel.launches, plain_calls=plain)
        if sim.nan_detected or not rel <= 0.05 or plain or kernel.launches <= 0:
            raise RuntimeError(f"sim_2 res 2 ({label}): L1 {l1:e} not within 5% of the "
                               f"start-up solution's {l1_ref:e}")
        checked[label] = sim
    f32 = {it: l1 for it, l1, _ in checked["pair_f32"].error_history}
    for store in ("f16", "bf16"):
        sim, wall = run_sim2(f"pair_{store}", ["--storage", store])
        it, l1, l2 = sim.error_history[-1]  # the last probe; the f32 run probed there too
        log("accuracy", path=f"pair_{store}", l1=f"{l1:.6e}", l2=f"{l2:.6e}", iterations=it,
            stop=sim.terminate_reason or "final_time", wall_s=f"{wall:.1f}",
            l1_f32_same_iteration=f"{f32[it]:.6e}" if it in f32 else "not probed",
            l1_over_f32=f"{l1 / f32[it]:.4f}" if it in f32 else "n/a",
            launches=sim._pair.kernel.launches, plain_calls=sim._pair.plain_calls)
        if sim.nan_detected or not np.isfinite([l1, l2]).all() or it not in f32:
            raise RuntimeError(f"sim_2 res 2 --storage {store}: non-finite L1/L2 or no f32 "
                               f"figure at iteration {it}")

    per_step = {it: l1 for it, l1, _ in checked["per_step"].error_history}
    sim, wall = run_sim2("ab_step", ["--streaming", "AB", "--use-fused"])
    it, l1, l2 = sim.error_history[-1]
    l1_ref = startup_l1(sim, it)
    rel = abs(l1 / l1_ref - 1)
    log("accuracy", path="ab_step", l1=f"{l1:.6e}", l2=f"{l2:.6e}", iterations=it,
        stop=sim.terminate_reason or "final_time", wall_s=f"{wall:.1f}",
        l1_startup_solution=f"{l1_ref:.6e}", rel_to_startup=f"{rel:.2e}",
        l1_aa_per_step_same_iteration=f"{per_step[it]:.6e}" if it in per_step else "not probed",
        launches=sim._step.kernel.launches, plain_calls=sim._step.plain_calls)
    if (sim.nan_detected or not rel <= 0.05 or sim._step.plain_calls
            or sim._step.kernel.launches <= 0):
        raise RuntimeError(f"sim_2 res 2 A-B: L1 {l1:e} not within 5% of the start-up "
                           f"solution's {l1_ref:e}")
    for app in ("sim_1", "sim_3"):
        app_kernel_vs_plain(app)


def app_kernel_vs_plain(name: str) -> None:
    """An app at resolution 2, APP_STEPS steps through the A-B kernel and
    through the plain step on the card, from the same initial state."""
    import importlib

    import torch

    app = importlib.import_module(f"tnl_lbm_tpu_torch.apps.{name}")
    runs = {}
    for fused in (True, False):
        sim = app.build(2, device=DEVICE, use_fused=fused,
                        results_parent=WORK / "accuracy" / f"{name}_{fused}")
        sim.phys_final_time = APP_STEPS * sim.domain.units.phys_dt
        if not sim.run() or sim.iterations != APP_STEPS:
            raise RuntimeError(f"{name} res 2 (use_fused={fused}) failed")
        runs[fused] = sim
    k, p = runs[True], runs[False]
    d_rho, d_u = max_diff(k.rho, p.rho), max_diff(k.u, p.u)
    moved = float(k.u.abs().max())
    log("accuracy", path=f"{name}_res2", steps=APP_STEPS, max_drho=d_rho, max_du=d_u,
        max_abs_u=moved, launches=k._step.kernel.launches, plain_calls=k._step.plain_calls)
    if not (d_rho <= TOL_APP and d_u <= TOL_APP and torch.isfinite(k.u).all() and moved > 0
            and k._step.kernel.launches == APP_STEPS and k._step.plain_calls == 0):
        raise RuntimeError(f"{name} res 2: kernel vs plain over {APP_STEPS} steps: "
                           f"drho {d_rho}, du {d_u}")


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
    steps = phase_compare_steps()
    pairs = phase_compare_pairs(steps["times"])
    probe = phase_probes()
    ab = phase_compare_ab(steps["times"], gbps(232, probe["times"]["copy_permute"][0]))
    main_path = phase_main_path()
    kernels = main_path["kernels"]
    phase_accuracy()
    err = {**steps["err"], **pairs["err"], **probe["err"], **ab["err"]}
    err["ab_step"] = max(err["ab_step"], main_path["err"]["ab_step"])
    times = {**steps["times"], **pairs["times"], **probe["times"], **ab["times"]}
    kernels.update(probe["kernels"])
    record = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": k.launches, "max_abs_err": err[key], "ms": times[key][0],
         "plain_ms": times[key][1]}
        for key, k in kernels.items()
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
