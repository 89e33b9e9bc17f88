#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tnl_lbm_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It drives the port's dispatch paths through the CUDA kernels: the A-A duct
(D3Q27 CUM_WELL on a square duct) per step (even/odd kernels) and in pairs
(the one-kernel pair, with the state in float32, float16 or bfloat16), and
the A-B step (B4) with the full 3D boundary set, on the bench duct and in
sim_1, sim_2 and sim_3; the A-A even/odd kernels (B2, B3) with the 3D set
and the three variants in sim_1 ``--streaming AA``; the coupled NSE+ADE
path - the ADE step (B6), the one-kernel coupled step (B7) and, with A-A
streaming, the A-A coupled pair (B8) - in sim_coupled.  Each phase prints
result lines; any failing phase raises and the script exits non-zero
without printing a result.

1. device: the card, ``nvidia-smi`` name and power limit, torch/CUDA versions;
2. build: compile the kernels from ``tnl_lbm_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel; registers, shared memory and spills from
   ``-Xptxas -v``, and the pair's dynamic shared memory; the FP32
   operations per thread of each kernel from ``cuobjdump -sass``, FFMA
   counted twice and every branch once, the upper bound of the operations
   a site takes that the bound of the JSON record uses);
3. compare, kernels against their plain PyTorch versions on the card, with
   the JAX suite's bounds (tests/test_fused_kernel.py:65-67): |df| <= 1e-6
   (for a 16-bit state ``utils.dtypes.state_agrees``: one unit in its last
   place plus 2e-8, and at most 0.1% of the elements different at all),
   |drho| <= 2e-6, |du| <= 1e-6:
   a. even/odd: sim_2's res-2 duct (32x64x64, WALL + NOTHING, periodic x),
      4 alternating steps; then one step of each at 256^3, timed, the odd
      step's lean CUM_WELL instance beside the full-set one; then a box of
      every A-A code with Z = 150, per variant (CUM_WELL; CUM with
      eq_quadratic or eq_inv_cum), 4 alternating steps each from the same
      input on both sides;
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
   d. the ADE step (B6): one step from a seeded state against its plain
      version (|dg| <= 1e-6, |dphi| <= 2e-6) on sim_coupled's res-2 ADE
      map, on a box holding every ADEGEO code with a transfer coefficient
      of 0.3, and on a periodic box with Z = 150, under the four
      collisions with a scalar and a per-site nu;
   e. the coupled step (B7): one step against its plain version and
      against the A-B kernel then the ADE kernel on the same inputs, on
      sim_coupled's res-2 maps and on the two boxes, per NSE variant and
      ADE collision (f, rho, u to the A-B bounds, g and phi to B6's),
      printing whether B7 equals B4 then B6 bit for bit; then B6, B7 and
      B4 followed by B6 timed at 256^3 (the bench duct, with WALL faces
      on the ADE lattice too) beside B4 and the P1 floor, GB/s at 73,
      294 and 306 B/site; then B8, even and odd parity from the same input,
      against its plain version and its NSE fields against B2/B3 run alone
      (bit-equality printed) on sim_coupled's res-2 A-A maps, a box whose
      NSE and ADE NOTHING sites differ and the periodic box, per NSE
      variant and ADE collision with a nu field; B8 even and odd timed at
      256^3 on the coupled bench duct under A-A beside B2 + B3, GB/s at 294
      B/site;
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
   with the step bounds (the launches of this compare are not counted).
   Then sim_coupled at resolution 8 (512x256x256), 100 steps with
   ``--use-fused``: ``coupled_kernel`` must be "one-kernel-AB" with 100
   coupled launches; phi finite; on the band of y more than 100 sites from
   the WALL_BODY walls (the JAX app's anti-bounce-back walls grow phi
   about 1.9x per step, and in 100 steps nothing from them reaches the
   band) rho, u and phi equal the plain steps' on a periodic X x 4 x 4
   slab within 1e-5, phi <= 1 + 1e-3 and above zero at x = 1; one step from
   its final state, kernel against plain (g and phi relative to the
   largest magnitude the site's update reads, at least 1); then the same
   run through the two-kernel path (B4 then B6, 100 launches each)
   against the one-kernel run's fields, then with ``--streaming AA``
   through B8 ("one-kernel-AA", 50 even and 50 odd launches, the band held
   to an A-A slab, one even and one odd parity from the final state kernel
   vs plain, ms/step, MLUPS and peak memory beside the A-B run's); after
   each run, torch.profiler over 10 more steps: device time per kernel
   and the device's busy share of the loop.  Also sim_1 at resolution 8
   with ``--streaming AA``, 100 steps through B2/B3, and the kernel vs
   plain check of one even and one odd step from a res-4 run's final
   state (the plain A-A step's temporaries at res 8 would not fit beside
   the run);
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
   max |drho| and max |du| <= 1e-5, and sim_1 res 2 A-A through B2/B3;
   sim_coupled res 2 likewise through the coupled kernel and the plain
   steps, A-B (B7) and A-A (B8), with |dphi| <= 1e-5 relative to the
   largest |phi| within a site's reach, at least 1.

The line before the last is the kernels' JSON record (bound_ms: the larger
of the bytes over the published 3.35 TB/s and the FP32 operations over
67 TFLOP/s, at 256^3); the last line is ``{"ok": true, "device": {...}}``.
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
SIM1_RES, APP_STEPS, TOL_APP = 8, 100, 1e-5
SIM1_AA_PLAIN_RES = 4  # sim_1 A-A kernel vs plain: the plain step's temporaries at res 8 exceed the card
FP32_PEAK_TFLOPS = 67.0  # H100 SXM data sheet, outside the tensor cores
TOL_G, TOL_PHI = 1e-6, 2e-6
NU_ADE = 0.02  # the ADE timing's diffusion
ADE_BYTES, COUPLED_BYTES, TWO_KERNEL_BYTES = 73, 294, 306  # B/site: B6, B7, B4 then B6
COUPLED_RES = 8
#: the y band of sim_coupled that the WALL_BODY walls cannot reach in APP_STEPS steps
WALL_REACH = APP_STEPS
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


ADE_KERNEL_NAMES = tuple(f"ade_step_{c}_kernel" for c in ("srt", "mrt", "clbm", "clbm_rs"))
NSE_VARIANTS = ("cum_well", "cum_quad", "cum_invcum")
COUPLED_KERNEL_NAMES = tuple(f"coupled_{n}_{c}_kernel" for n in NSE_VARIANTS
                             for c in ("srt", "mrt", "clbm", "clbm_rs"))
AA_KERNEL_NAMES = tuple(f"aa_{p}_{n}_kernel" for p in ("even", "odd") for n in NSE_VARIANTS)
COUPLED_AA_KERNEL_NAMES = tuple(f"coupled_aa_{p}_{n}_{c}_kernel" for p in ("even", "odd")
                                for n in NSE_VARIANTS for c in ("srt", "mrt", "clbm", "clbm_rs"))


def sass_fp32_ops(lib_path) -> dict:
    """FP32 arithmetic instructions per thread of each kernel of the built
    library (``cuobjdump -sass``): FADD, FMUL, MUFU and FMNMX once, FFMA
    twice.  Every branch counts once, so for a kernel without loops this
    bounds the operations one site takes from above."""
    import os
    import re

    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    exe = shutil.which("cuobjdump") or os.path.join(cuda_home, "bin", "cuobjdump")
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    weight = {"FADD": 1, "FADD32I": 1, "FMUL": 1, "FMUL32I": 1, "FFMA": 2, "FFMA32I": 2,
              "MUFU": 1, "FMNMX": 1}
    ops, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            current = m.group(1)
            ops[current] = 0
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)", line)
        if current is not None and m:
            ops[current] += weight.get(m.group(1), 0)
    return ops


def phase_build() -> dict:
    """Build the kernels; registers per kernel, and the FP32 operations
    per thread from the SASS."""
    from tnl_lbm_tpu_torch.kernels.build import build_library, kernel_resources, load_library

    t0 = time.perf_counter()
    path, ptxas = build_library()
    lib = load_library()
    res = kernel_resources(ptxas)
    ops = sass_fp32_ops(path)
    names = (("aa_odd_kernel", "aa_pair_f32_kernel", "aa_pair_f16_kernel",
              "aa_pair_bf16_kernel", "ab_step_cum_well_kernel", "ab_step_cum_quad_kernel",
              "ab_step_cum_invcum_kernel", "copy_permute_kernel", "pair_pipeline_kernel",
              "pair_compute_only_kernel") + AA_KERNEL_NAMES + ADE_KERNEL_NAMES
             + COUPLED_KERNEL_NAMES + COUPLED_AA_KERNEL_NAMES)
    for name in names:
        if name not in res or name not in ops:
            raise RuntimeError(f"no ptxas report or SASS for {name}:\n{ptxas}")
        log("build", kernel=name, **res[name], fp32_ops_per_thread=ops[name])
    log("build", seconds=f"{time.perf_counter() - t0:.1f}",
        pair_dynamic_smem_bytes=lib.tnl_lbm_aa_pair_smem_bytes())
    return ops


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

    # one step of each kernel against its plain version at the bench shape;
    # the odd step's lean CUM_WELL instance is timed beside the full-set one
    cfg, dom = flagship(BENCH_SHAPE)
    step, full = make_fused_step_aa(cfg, dom, dev), make_fused_step_aa(cfg, dom, dev, lean=False)
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
        lean = {}
        if parity == 1:  # the odd step's lean instance beside its full CUM_WELL one
            lean["full_cum_well_instance_ms"] = "%.4f" % time_ms(
                lambda: full(fw, NU, force=bench_force, parity=parity), reps=20)
        plain_ms = time_ms(lambda: step.plain(f0, NU, force=bench_force, parity=parity), reps=3)
        del fw
        torch.cuda.empty_cache()
        times[name] = (ms, plain_ms)
        log("compare", kernel=name, shape="256^3", variant=step.variant, max_df=d[0],
            max_drho=d[1], max_du=d[2], ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}",
            gbps_216B=f"{gbps(216, ms):.1f}", **lean)
    return {"err": err, "times": times}


def phase_compare_aa_codes() -> float:
    """The even/odd kernels on a box of every A-A code with a Z that the
    block's 128 z sites do not divide, per variant (CUM_WELL; CUM with
    eq_quadratic; CUM with eq_inv_cum): 4 alternating steps, each kernel
    step against the plain version on the same input.  Returns max |df|."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa
    from torch_cases import AB_SPECS, U_IN, aa_box

    dev = torch.device(DEVICE)
    dom = interop.domain_from_numpy(aa_box((24, 20, 150)), (False, False, True))
    force = (FORCE_SMALL, 0.0, 0.0)
    worst_f = 0.0
    for spec in AB_SPECS.values():
        cfg = interop.config_from_spec(*spec, "AA")
        step = make_fused_step_aa(cfg, dom, dev)
        f = rand_f(cfg, dom.shape, dev, seed=11)
        worst = [0.0, 0.0, 0.0]
        for it in range(4):
            fp, rp, up = step.plain(f, NU, u_in=U_IN, force=force, parity=it % 2)
            f, rk, uk = step(f.clone(), NU, u_in=U_IN, force=force, parity=it % 2)
            torch.cuda.synchronize()
            worst = [max(a, b) for a, b in zip(worst, (max_diff(f, fp), max_diff(rk, rp),
                                                       max_diff(uk, up)))]
        log("compare_aa_codes", variant=f"{spec[0]}/{spec[1]}", shape="x".join(map(str, dom.shape)),
            codes="+".join(sorted(c.name for c in step.codes)), steps=4, max_df=worst[0],
            max_drho=worst[1], max_du=worst[2], launches_even=step.even.launches,
            launches_odd=step.odd.launches)
        if not (worst[0] <= TOL_F and worst[1] <= TOL_RHO and worst[2] <= TOL_U):
            raise RuntimeError(f"A-A kernels vs plain on the every-code box, {spec}: {worst}")
        worst_f = max(worst_f, worst[0])
    return worst_f


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
    from torch_cases import U_IN, bc_box

    dev = torch.device(DEVICE)
    where = WORK / "compare_ab"
    sim = sim_2.build(2, device=dev, streaming="AB", use_fused=True, results_parent=where)
    yield "sim_2_res2_AB", sim.cfg, sim.domain, None
    for app in (sim_1, sim_3):
        sim = app.build(2, device=dev, results_parent=where)
        yield f"{app.__name__.rsplit('.', 1)[1]}_res2", sim.cfg, sim.domain, sim.update_inflow(0.0)
    box = interop.domain_from_numpy(bc_box((24, 20, 150)), (False, False, True))
    for spec in (("CUM_WELL", "EQ_WELL", True), ("CUM", "EQ", False)):
        yield f"box_{spec[0]}", interop.config_from_spec(*spec, "AB"), box, U_IN


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


def scaled_diff(a, b, scale) -> float:
    """max |a - b| / scale, one component at a time: the absolute
    difference where the operands are at most 1 in magnitude, the relative
    one where the WALL_BODY walls have grown them."""
    if a.ndim == 4:
        return max(scaled_diff(x, y, scale) for x, y in zip(a, b))
    return float(((a.double() - b.double()).abs() / scale).max())


def coupled_cases():
    """(label, NSE domain, ADE domain) of the B6 and B7 compares:
    sim_coupled's res-2 maps, the boxes of every code (NSE ``bc_box`` and
    ADE ``ade_box``, Z = 150) and a periodic box (FLUID with a
    PERIODIC-coded block, every axis periodic), the geometries of
    tests/torch_cases.py at these shapes."""
    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.apps import sim_coupled
    from tnl_lbm_tpu_torch.models import D3Q7
    from torch_cases import ade_case, channel

    sim = sim_coupled.build(2, device=DEVICE, use_fused=True, results_parent=WORK / "compare_ade")
    yield "sim_coupled_res2", sim.domain, sim.ade_domain
    shape = (16, 20, 150)
    yield ("box", interop.domain_from_numpy(*channel("box", shape)),
           interop.domain_from_numpy(*ade_case("box", shape), lat=D3Q7))
    m, periodic = ade_case("periodic", (24, 20, 150))
    yield ("periodic", interop.domain_from_numpy(np.zeros_like(m), periodic),
           interop.domain_from_numpy(m, periodic, lat=D3Q7))


def phase_compare_ade() -> dict:
    """B6 against its plain version, one step per geometry, collision and
    kind of nu."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.kernels.fused_ade import make_fused_ade_step
    from torch_cases import ADE_COLLISIONS, PHI_IN, TCOEF, seeded_ade

    dev = torch.device(DEVICE)
    worst_g = 0.0
    for label, _, adom in coupled_cases():
        worst = [0.0, 0.0]
        g, u, nu_field = seeded_ade(adom.shape, dev)
        for collision in ADE_COLLISIONS:
            step = make_fused_ade_step(interop.ade_config_from_spec(collision), adom, dev,
                                       variable_diffusion=True, transfer_coeff=TCOEF)
            for nu in (NU_ADE, nu_field):
                gk, pk = step(g, u, nu, phi_in=PHI_IN)
                gp, pp = step.plain(g, u, nu, phi_in=PHI_IN)
                torch.cuda.synchronize()
                d = (max_diff(gk, gp), max_diff(pk, pp))
                if not (d[0] <= TOL_G and d[1] <= TOL_PHI):
                    raise RuntimeError(f"ade_step vs plain on {label}, {collision}, "
                                       f"nu {'field' if torch.is_tensor(nu) else 'scalar'}: {d}")
                worst = [max(a, b) for a, b in zip(worst, d)]
        log("compare_ade", case=label, shape="x".join(map(str, adom.shape)),
            codes="+".join(sorted(c.name for c in step.codes)), collisions=len(ADE_COLLISIONS),
            nu="scalar+field", max_dg=worst[0], max_dphi=worst[1])
        worst_g = max(worst_g, worst[0])
    return {"ade_step": worst_g}


def phase_compare_coupled() -> dict:
    """B7 against its plain version and against B4 then B6, one step per
    geometry, NSE variant and ADE collision, with a nu field."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
    from tnl_lbm_tpu_torch.kernels.fused_ade import make_fused_ade_step
    from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step
    from torch_cases import AB_SPECS, ADE_COLLISIONS, PHI_IN, TCOEF, U_IN, seeded_ade

    dev = torch.device(DEVICE)
    worst_state, bit_equal = 0.0, True
    args = dict(u_in=U_IN, force=(FORCE_SMALL, 0.0, 0.0), phi_in=PHI_IN)
    for label, dom, adom in coupled_cases():
        worst = [0.0] * 5
        g, _, nu_field = seeded_ade(dom.shape, dev)
        for spec in AB_SPECS.values():
            cfg = interop.config_from_spec(*spec, "AB")
            f = rand_f(cfg, dom.shape, dev, seed=11)
            b4 = make_fused_step(cfg, dom, dev)
            for collision in ADE_COLLISIONS:
                acfg = interop.ade_config_from_spec(collision)
                one = make_fused_coupled_step(cfg, dom, acfg, adom, dev, variable_diffusion=True,
                                              transfer_coeff=TCOEF)
                b6 = make_fused_ade_step(acfg, adom, dev, variable_diffusion=True,
                                         transfer_coeff=TCOEF)
                k = one(f, g, NU, nu_field, **args)
                p = one.plain(f, g, NU, nu_field, **args)
                f2, r2, u2 = b4(f, NU, u_in=args["u_in"], force=args["force"])
                g2, p2 = b6(g, u2, nu_field, phi_in=PHI_IN)
                two = (f2, g2, r2, u2, p2)
                torch.cuda.synchronize()
                for ref in (p, two):
                    d = [max_diff(a, b) for a, b in zip(k, ref)]  # f, g, rho, u, phi
                    if not (d[0] <= TOL_F and d[1] <= TOL_G and d[2] <= TOL_RHO
                            and d[3] <= TOL_U and d[4] <= TOL_PHI):
                        raise RuntimeError(f"coupled_ab on {label}, {spec[0]}/{spec[1]}, "
                                           f"{collision}: {d}")
                    worst = [max(a, b) for a, b in zip(worst, d)]
                bit_equal &= all(torch.equal(a, b) for a, b in zip(k, two))
        log("compare_coupled", case=label, shape="x".join(map(str, dom.shape)),
            instances=len(AB_SPECS) * len(ADE_COLLISIONS), max_df=worst[0], max_dg=worst[1],
            max_drho=worst[2], max_du=worst[3], max_dphi=worst[4],
            b7_equals_b4_then_b6_bitwise=bit_equal)
        worst_state = max(worst_state, worst[0], worst[1])
    return {"coupled_ab": worst_state, "bit_equal": bit_equal}


def coupled_bench():
    """The bench duct with an ADE lattice: WALL on the y and z faces of
    both lattices, periodic x; CUM_WELL and CLBM."""
    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.models import D3Q7
    from tnl_lbm_tpu_torch.sim.step_ade import ADEGEO

    cfg, dom = flagship(BENCH_SHAPE, streaming="AB")
    m = np.zeros(BENCH_SHAPE, np.uint8)
    m[:, 0] = m[:, -1] = ADEGEO.WALL
    m[:, :, 0] = m[:, :, -1] = ADEGEO.WALL
    return cfg, dom, interop.ade_config_from_spec("CLBM"), interop.domain_from_numpy(
        m, (True, False, False), lat=D3Q7)


def phase_time_coupled(floor_gbps: float) -> dict:
    """B6, B7 and B4 then B6 at 256^3: one step of B6 and B7 against their
    plain versions, then timed beside B4 and the P1 floor of this call."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
    from tnl_lbm_tpu_torch.kernels.fused_ade import make_fused_ade_step
    from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step
    from torch_cases import seeded_ade

    dev = torch.device(DEVICE)
    cfg, dom, acfg, adom = coupled_bench()
    b4, b6 = make_fused_step(cfg, dom, dev), make_fused_ade_step(acfg, adom, dev)
    b7 = make_fused_coupled_step(cfg, dom, acfg, adom, dev)
    force = (FORCE_BENCH, 0.0, 0.0)
    f0 = rand_f(cfg, dom.shape, dev, seed=7)
    g0, u0, _ = seeded_ade(dom.shape, dev)
    d6 = [max_diff(a, b) for a, b in zip(b6(g0, u0, NU_ADE), b6.plain(g0, u0, NU_ADE))]
    d7 = [max_diff(a, b) for a, b in zip(b7(f0, g0, NU, NU_ADE, force=force),
                                         b7.plain(f0, g0, NU, NU_ADE, force=force))]
    torch.cuda.empty_cache()
    if not (d6[0] <= TOL_G and d6[1] <= TOL_PHI and d7[0] <= TOL_F and d7[1] <= TOL_G
            and d7[2] <= TOL_RHO and d7[3] <= TOL_U and d7[4] <= TOL_PHI):
        raise RuntimeError(f"B6 / B7 vs plain at 256^3 out of tolerance: {d6}, {d7}")
    fo, go = torch.empty_like(f0), torch.empty_like(g0)

    def two():
        _, _, u = b4(f0, NU, force=force, out=fo)
        b6(g0, u, NU_ADE, out=go)

    ms = {
        "ab_step": time_ms(lambda: b4(f0, NU, force=force, out=fo), reps=20),
        "ade_step": time_ms(lambda: b6(g0, u0, NU_ADE, out=go), reps=20),
        "coupled_ab": time_ms(lambda: b7(f0, g0, NU, NU_ADE, force=force, out_f=fo, out_g=go),
                              reps=20),
        "ab_then_ade": time_ms(two, reps=20),
    }
    plain = {"ade_step": time_ms(lambda: b6.plain(g0, u0, NU_ADE), reps=3),
             "coupled_ab": time_ms(lambda: b7.plain(f0, g0, NU, NU_ADE, force=force), reps=3)}
    del f0, g0, u0, fo, go
    torch.cuda.empty_cache()
    for name, nbytes in (("ab_step", AB_BYTES), ("ade_step", ADE_BYTES),
                         ("coupled_ab", COUPLED_BYTES), ("ab_then_ade", TWO_KERNEL_BYTES)):
        rate = gbps(nbytes, ms[name])
        log("time_coupled", kernel=name, shape="256^3", ms=f"{ms[name]:.4f}",
            plain_ms=f"{plain[name]:.2f}" if name in plain else "n/a",
            **{f"gbps_{nbytes}B": f"{rate:.1f}"}, share_of_p1_floor=f"{rate / floor_gbps:.3f}")
    log("time_coupled", b7_over_b4_then_b6=f"{ms['coupled_ab'] / ms['ab_then_ade']:.3f}",
        max_dg_b6=d6[0], max_dphi_b6=d6[1], max_df_b7=d7[0], max_dg_b7=d7[1])
    return {"times": {k: (ms[k], plain[k]) for k in plain},
            "err": {"ade_step": d6[0], "coupled_ab": max(d7[0], d7[1])}}


def coupled_aa_cases():
    """(label, NSE domain, ADE domain) of the B8 compare: sim_coupled's
    res-2 A-A maps, then tests/torch_cases.py's ``coupled_aa_cases`` with
    Z = 150, which the block's 128 z sites do not divide."""
    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.apps import sim_coupled
    from tnl_lbm_tpu_torch.models import D3Q7
    import torch_cases

    sim = sim_coupled.build(2, device=DEVICE, use_fused=True, streaming="AA",
                            results_parent=WORK / "compare_aa")
    yield "sim_coupled_res2_AA", sim.domain, sim.ade_domain
    for label, mn, pn, ma, pa in torch_cases.coupled_aa_cases((16, 20, 150)):
        yield (label, interop.domain_from_numpy(mn, pn),
               interop.domain_from_numpy(ma, pa, lat=D3Q7))


def phase_compare_coupled_aa() -> dict:
    """B8 against its plain version per geometry, NSE variant and ADE
    collision, with a nu field: the even then the odd parity, each from the
    same input on both sides; and its NSE fields against the A-A step
    kernels (B2, B3) run alone, bit-equality printed."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa
    from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step_aa
    from torch_cases import AB_SPECS, ADE_COLLISIONS, PHI_IN, U_IN, seeded_ade

    dev = torch.device(DEVICE)
    err, bit_equal = {"coupled_aa_even": 0.0, "coupled_aa_odd": 0.0}, True
    args = dict(u_in=U_IN, force=(FORCE_SMALL, 0.0, 0.0))
    for label, dom, adom in coupled_aa_cases():
        worst = [0.0] * 5
        g0, _, nu_field = seeded_ade(dom.shape, dev)
        for spec in AB_SPECS.values():
            cfg = interop.config_from_spec(*spec, "AA")
            f0 = rand_f(cfg, dom.shape, dev, seed=11)
            alone = make_fused_step_aa(cfg, dom, dev, lean=False)  # B8's NSE instance
            for collision in ADE_COLLISIONS:
                pair = make_fused_coupled_step_aa(cfg, dom, interop.ade_config_from_spec(
                    collision, "AA"), adom, dev, variable_diffusion=True)
                f, g = f0, g0
                for parity, name in ((0, "coupled_aa_even"), (1, "coupled_aa_odd")):
                    p = pair.plain(f, g, NU, nu_field, phi_in=PHI_IN, parity=parity, **args)
                    a = alone(f.clone(), NU, parity=parity, **args)
                    k = pair(f.clone(), g.clone(), NU, nu_field, phi_in=PHI_IN, parity=parity,
                             **args)
                    torch.cuda.synchronize()
                    d = [max_diff(x, y) for x, y in zip(k, p)]  # f, g, rho, u, phi
                    if not (d[0] <= TOL_F and d[1] <= TOL_G and d[2] <= TOL_RHO
                            and d[3] <= TOL_U and d[4] <= TOL_PHI):
                        raise RuntimeError(f"{name} on {label}, {spec[0]}/{spec[1]}, "
                                           f"{collision}: {d}")
                    da = [max_diff(x, y) for x, y in zip((k[0], k[2], k[3]), a)]
                    if not (da[0] <= TOL_F and da[1] <= TOL_RHO and da[2] <= TOL_U):
                        raise RuntimeError(f"{name} NSE fields vs B2/B3 on {label}: {da}")
                    bit_equal &= all(torch.equal(x, y) for x, y in zip((k[0], k[2], k[3]), a))
                    worst = [max(x, y) for x, y in zip(worst, d)]
                    err[name] = max(err[name], d[0], d[1])
                    f, g = k[0], k[1]
        log("compare_coupled_aa", case=label, shape="x".join(map(str, dom.shape)),
            instances=len(AB_SPECS) * len(ADE_COLLISIONS), parities="even+odd",
            nse_codes="+".join(sorted(c.name for c in dom.codes_present())),
            ade_codes="+".join(sorted(c.name for c in adom.codes_present())), max_df=worst[0],
            max_dg=worst[1], max_drho=worst[2], max_du=worst[3], max_dphi=worst[4],
            b8_nse_equals_b2_b3_bitwise=bit_equal)
    return {"err": err, "bit_equal": bit_equal}


def phase_time_coupled_aa(step_times: dict, floor_gbps: float) -> dict:
    """B8 even and odd at 256^3 (the coupled bench duct under A-A, scalar
    nu): one launch of each against its plain version, then timed beside
    B2 + B3 of this call and the P1 floor, GB/s at 294 B/site."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step_aa
    from torch_cases import seeded_ade

    dev = torch.device(DEVICE)
    cfg, dom, acfg, adom = coupled_bench()
    cfg, acfg = (dataclasses.replace(c, streaming="AA") for c in (cfg, acfg))
    pair = make_fused_coupled_step_aa(cfg, dom, acfg, adom, dev)
    force = (FORCE_BENCH, 0.0, 0.0)
    f0 = rand_f(cfg, dom.shape, dev, seed=7)
    g0, _, _ = seeded_ade(dom.shape, dev)
    fo, go = torch.empty_like(f0), torch.empty_like(g0)
    times, err = {}, {}
    for parity, name in ((0, "coupled_aa_even"), (1, "coupled_aa_odd")):
        k = pair(f0.clone(), g0.clone(), NU, NU_ADE, force=force, parity=parity)
        p = pair.plain(f0, g0, NU, NU_ADE, force=force, parity=parity)
        d = [max_diff(a, b) for a, b in zip(k, p)]
        del k, p
        torch.cuda.empty_cache()
        if not (d[0] <= TOL_F and d[1] <= TOL_G and d[2] <= TOL_RHO and d[3] <= TOL_U
                and d[4] <= TOL_PHI):
            raise RuntimeError(f"{name} vs plain at 256^3 out of tolerance: {d}")
        fw, gw = f0.clone(), g0.clone()
        ms = time_ms(lambda: pair(fw, gw, NU, NU_ADE, force=force, parity=parity, out_f=fo,
                                  out_g=go), reps=20)
        plain_ms = time_ms(lambda: pair.plain(f0, g0, NU, NU_ADE, force=force, parity=parity),
                           reps=3)
        del fw, gw
        torch.cuda.empty_cache()
        times[name], err[name] = (ms, plain_ms), max(d[0], d[1])
        rate = gbps(COUPLED_BYTES, ms)
        log("time_coupled_aa", kernel=name, shape="256^3", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.2f}", **{f"gbps_{COUPLED_BYTES}B": f"{rate:.1f}"},
            share_of_p1_floor=f"{rate / floor_gbps:.3f}",
            step_kernel_ms=f"{step_times['aa_even' if parity == 0 else 'aa_odd'][0]:.4f}",
            max_df=d[0], max_dg=d[1], max_drho=d[2], max_du=d[3], max_dphi=d[4])
    del f0, g0, fo, go
    torch.cuda.empty_cache()
    pair_ms = times["coupled_aa_even"][0] + times["coupled_aa_odd"][0]
    steps_ms = step_times["aa_even"][0] + step_times["aa_odd"][0]
    log("time_coupled_aa", b8_pair_ms=f"{pair_ms:.4f}", b2_plus_b3_ms=f"{steps_ms:.4f}",
        b8_over_b2_b3=f"{pair_ms / steps_ms:.3f}")
    return {"times": times, "err": err}


def counting_from_init(sim):
    """Set the launch and plain-call counts and the peak-memory mark to 0 at
    the end of ``sim_init``, just before the stepping loop.  A subclass and
    not a wrapped method: a closure over ``sim`` would be a reference cycle
    that keeps the run's device state alive after ``del``."""
    import torch

    class Counted(type(sim)):
        def sim_init(self):
            super().sim_init()
            for k in (self._step, self._pair, getattr(self, "_ade_step", None),
                      getattr(self, "_coupled_step", None)):
                if hasattr(k, "reset_counts"):
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
    if hasattr(sim, "coupled_kernel") and sim.cfg.streaming == "AA":
        pair = sim._coupled_step
        return {"even": step.even.launches, "odd": step.odd.launches,
                "coupled_even": pair.even.launches, "coupled_odd": pair.odd.launches}
    if hasattr(sim, "coupled_kernel"):
        return {"ab": step.kernel.launches, "ade": sim._ade_step.kernel.launches,
                "coupled": sim._coupled_step.kernel.launches if sim._coupled_step else 0}
    if hasattr(step, "even"):
        launches = {"even": step.even.launches, "odd": step.odd.launches}
        launches["pair"] = sim._pair.kernel.launches if sim._pair else 0
        return launches
    return {"ab": step.kernel.launches}


def run_figures(sim) -> tuple[float, float, float]:
    """(ms/step, MLUPS, peak GB) of a Simulation's counted run."""
    import torch

    steps = sim.iterations
    return (sim._compute_time / steps * 1e3,
            float(np.prod(sim.domain.shape)) * steps / sim._compute_time / 1e6,
            torch.cuda.max_memory_allocated() / 1e9)


def report_main(sim, label: str) -> dict:
    import torch

    steps = sim.iterations
    finite = bool(torch.isfinite(sim.rho).all()) and bool(torch.isfinite(sim.u).all())
    plain = sum(getattr(k, "plain_calls", 0) for k in (
        sim._step, sim._pair, getattr(sim, "_ade_step", None), getattr(sim, "_coupled_step", None)))
    ms_step, mlups, peak_gb = run_figures(sim)
    launches = kernel_launches(sim)
    log("main", path=label, shape="x".join(map(str, sim.domain.shape)), steps=steps,
        ms_per_step=f"{ms_step:.4f}", mlups=f"{mlups:.1f}", max_memory_allocated_gb=f"{peak_gb:.3f}",
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
    sim1_launches = launches["ab"]
    err = {"ab_step": sim1_kernel_vs_plain(sim)}
    del sim
    torch.cuda.empty_cache()

    sim = sim1_main_path("AA")
    launches = report_main(sim, f"sim_1_res{SIM1_RES}_AA")
    half = APP_STEPS // 2
    if (sim.iterations != APP_STEPS or sim._pair is not None
            or launches != {"even": half, "odd": APP_STEPS - half, "pair": 0}):
        raise RuntimeError(f"sim_1 A-A did not run every step through B2/B3: {launches}")
    log("main", path=f"sim_1_res{SIM1_RES}_AA", variant=sim._step.variant,
        codes="+".join(sorted(c.name for c in sim._step.codes)))
    for name in ("aa_even", "aa_odd"):
        kernels[name] = dataclasses.replace(kernels[name], launches=kernels[name].launches
                                            + launches[name[3:]])
    del sim
    torch.cuda.empty_cache()
    err.update(sim1_aa_kernel_vs_plain())

    coupled = coupled_main_path()
    kernels.update(coupled["kernels"])
    err.update(coupled["err"])
    # the JSON record counts the launches of every A-B main path
    kernels["ab_step"] = dataclasses.replace(
        ab, launches=ab.launches + sim1_launches + coupled["ab_launches"])
    return {"kernels": kernels, "err": err}


def two_kernel(sim):
    """Drop the coupled kernel at the end of ``sim_init``: ``_advance`` then
    runs the A-B step (B4) and the ADE step (B6) that ``sim_init`` built -
    the JAX package's "two-kernel" path, which the port's own rules never
    pick.  A subclass, as in ``counting_from_init``."""

    class TwoKernel(type(sim)):
        def sim_init(self):
            super().sim_init()
            self._coupled_step, self.coupled_kernel = None, "two-kernel"

    sim.__class__ = TwoKernel
    return sim


def coupled_main_path() -> dict:
    """sim_coupled at COUPLED_RES through its ``build`` with ``--use-fused``,
    APP_STEPS steps through the coupled kernel, then through the two-kernel
    path (B4 then B6), then with ``--streaming AA`` through the A-A coupled
    pair (B8), each counted from the end of sim_init."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim_coupled
    from torch_cases import local_scale

    out, final, slabs, figures = {"kernels": {}, "err": {}}, None, {}, {}
    half = APP_STEPS // 2
    for dispatch in ("one-kernel-AB", "two-kernel", "one-kernel-AA"):
        label = f"sim_coupled_res{COUPLED_RES}_{dispatch}"
        streaming = "AA" if dispatch == "one-kernel-AA" else "AB"
        sim = sim_coupled.build(COUPLED_RES, device=DEVICE, use_fused=True, streaming=streaming,
                                results_parent=WORK / "main" / dispatch)
        if dispatch == "two-kernel":
            two_kernel(sim)
        sim.phys_final_time = APP_STEPS * sim.domain.units.phys_dt
        if not counting_from_init(sim).run():
            raise RuntimeError(f"{label} failed (NaN or refused)")
        launches = report_main(sim, label)
        figures[dispatch] = run_figures(sim)
        want = {"one-kernel-AB": {"coupled": APP_STEPS, "ab": 0, "ade": 0},
                "two-kernel": {"coupled": 0, "ab": APP_STEPS, "ade": APP_STEPS},
                "one-kernel-AA": {"even": 0, "odd": 0, "coupled_even": half,
                                  "coupled_odd": APP_STEPS - half}}[dispatch]
        if (sim.coupled_kernel != dispatch or launches != want
                or sim.iterations != APP_STEPS):
            raise RuntimeError(f"{label}: coupled_kernel {sim.coupled_kernel!r}, launches "
                               f"{launches} after {sim.iterations} steps")
        if streaming not in slabs:
            slabs[streaming] = plume_slab(sim)
        check_plume(sim, label, slabs[streaming])
        if dispatch == "one-kernel-AB":
            out["kernels"]["coupled_ab"] = dataclasses.replace(sim._coupled_step.kernel)
            out["err"]["coupled_ab"] = coupled_kernel_vs_plain_at(sim)
            final = (sim.rho.clone(), sim.u.clone(), sim.phi.clone())
            sim._spare, sim._g_spare = torch.empty_like(sim.f), torch.empty_like(sim.g)
        elif dispatch == "two-kernel":
            out["kernels"]["ade_step"] = dataclasses.replace(sim._ade_step.kernel)
            out["ab_launches"] = launches["ab"]
            same = all(torch.equal(a, b) for a, b in zip(final, (sim.rho, sim.u, sim.phi)))
            d = (max_diff(final[0], sim.rho), max_diff(final[1], sim.u),
                 scaled_diff(sim.phi, final[2], local_scale(final[2])))
            log("main", path=label, compare="two-kernel vs one-kernel final fields",
                max_drho=d[0], max_du=d[1], max_dphi_scaled=d[2], bit_equal=same)
            if not (d[0] <= TOL_APP and d[1] <= TOL_APP and d[2] <= TOL_APP):
                raise RuntimeError(f"{label}: the two coupled paths disagree: {d}")
        else:
            for parity in ("even", "odd"):
                out["kernels"][f"coupled_aa_{parity}"] = dataclasses.replace(
                    getattr(sim._coupled_step, parity))
            out["err"].update(coupled_aa_kernel_vs_plain_at(sim))
            ab, aa = figures["one-kernel-AB"], figures[dispatch]
            log("main", path=label, beside="one-kernel-AB of this call",
                ms_per_step_aa=f"{aa[0]:.4f}", ms_per_step_ab=f"{ab[0]:.4f}",
                mlups_aa=f"{aa[1]:.1f}", mlups_ab=f"{ab[1]:.1f}", peak_gb_aa=f"{aa[2]:.3f}",
                peak_gb_ab=f"{ab[2]:.3f}", aa_over_ab_time=f"{aa[0] / ab[0]:.3f}")
            sim._spare, sim._g_spare = torch.empty_like(sim.f), torch.empty_like(sim.g)
        profile_loop(sim, label)
        del sim
        torch.cuda.empty_cache()
    return out


def plume_slab(sim):
    """The reference of sim_coupled's middle: the same units, collisions,
    streaming, inflow and outflow (A-A: OUTFLOW_RIGHT for the A-B-only
    OUTFLOW_PE, as the app) on an X x 4 x 4 slab periodic in y and z,
    APP_STEPS plain steps on the card.  A site more than APP_STEPS sites
    from the walls takes, in APP_STEPS steps, only what the slab's sites
    take."""
    from tnl_lbm_tpu_torch.apps.sim_coupled import SimCoupled
    from tnl_lbm_tpu_torch.models import D3Q7, D3Q27
    from tnl_lbm_tpu_torch.ops.boundary import GEO
    from tnl_lbm_tpu_torch.sim.config import Domain
    from tnl_lbm_tpu_torch.sim.step_ade import ADEGEO
    from tnl_lbm_tpu_torch.utils.units import Lattice

    X = sim.domain.shape[0]
    u0 = sim.domain.units
    units = Lattice(global_size=(X, 4, 4), phys_origin=(0.0, 0.0, 0.0), phys_dl=u0.phys_dl,
                    phys_dt=u0.phys_dt, phys_viscosity=u0.phys_viscosity)
    m = np.zeros((X, 4, 4), np.uint8)
    m[0], m[-1] = GEO.INFLOW, GEO.OUTFLOW_EQ
    ma = np.zeros((X, 4, 4), np.uint8)
    streaming = sim.ade_cfg.streaming
    ma[0], ma[-1] = ADEGEO.INFLOW, ADEGEO.OUTFLOW_RIGHT if streaming == "AA" else ADEGEO.OUTFLOW_PE
    per = (False, True, True)
    slab = SimCoupled(sim.cfg, Domain(lat=D3Q27, units=units, map=m, periodic=per), sim.ade_cfg,
                      Domain(lat=D3Q7, units=units, map=ma, periodic=per),
                      ade_diffusion=sim.ade_diffusion, phi_inflow=sim.phi_inflow, device=DEVICE,
                      sim_id=f"plume_slab_{streaming}", results_parent=WORK / "main" / "slab",
                      phys_final_time=APP_STEPS * units.phys_dt, use_fused=False)
    slab.lbm_inflow_vx = sim.lbm_inflow_vx
    if not slab.run() or slab.iterations != APP_STEPS or slab.coupled_kernel != "plain":
        raise RuntimeError("the plume slab reference failed")
    return slab


def profile_loop(sim, label: str, steps: int = 10) -> None:
    """Where the time of a Simulation's loop goes: after 5 warm-up steps,
    ``steps`` steps unprofiled (host clock, ending in a synchronize), then
    ``steps`` under torch.profiler - device time per kernel, and the share
    of the profiled host time the device was busy.  Runs past the checked
    state; a run's own checks come first."""
    from torch.profiler import ProfilerActivity, profile

    sim._advance(5)
    t0 = time.perf_counter()
    sim._advance(steps)
    unprofiled = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim._advance(steps)
        wall = (time.perf_counter() - t0) * 1e3
    device = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            device[e.key] = us / 1e3
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:4]
    log("profile", path=label, steps=steps, unprofiled_ms_per_step=f"{unprofiled / steps:.4f}",
        profiled_ms_per_step=f"{wall / steps:.4f}", device_ms_per_step=f"{busy / steps:.4f}",
        device_busy_share=f"{busy / wall:.4f}" if wall else "n/a",
        **{f"device_ms_{k[:40]}": f"{v / steps:.4f}" for k, v in top})


def check_plume(sim, label: str, slab) -> None:
    """phi finite everywhere.  On the y band more than WALL_REACH sites from
    the WALL_BODY walls (whose anti-bounce-back grows phi; a site moves
    information one site per step), rho, u and phi equal, within TOL_APP,
    the plain steps' on a periodic slab (``plume_slab``), phi <= 1 + 1e-3,
    and phi has risen above zero at x = 1.  The step front at the inlet
    undershoots below zero (CLBM at omega 1.92); its minimum is printed."""
    import torch

    Y, Z = sim.ade_domain.shape[1:]
    band = sim.phi[:, WALL_REACH + 1 : Y - WALL_REACH - 1]
    lo, hi = float(band.min()), float(band.max())
    inlet = float(band[1].max())
    finite = bool(torch.isfinite(sim.phi).all())
    mid = (slice(None), Y // 2, Z // 2)
    d = (max_diff(sim.rho[mid], slab.rho[:, 0, 0]), max_diff(sim.u[(slice(None),) + mid],
                                                             slab.u[:, :, 0, 0]),
         max_diff(sim.phi[mid], slab.phi[:, 0, 0]))
    spread = max_diff(band, band[:, :1].expand_as(band))
    log("main", path=label, phi_finite=finite, max_abs_phi=float(sim.phi.abs().max()),
        band_y=f"{WALL_REACH + 1}..{Y - WALL_REACH - 2}", band_phi_min=lo, band_phi_max=hi,
        band_phi_max_x1=inlet, band_spread_in_y=spread, slab_max_drho=d[0], slab_max_du=d[1],
        slab_max_dphi=d[2], max_abs_u=float(sim.u.abs().max()))
    if not (finite and hi <= 1 + 1e-3 and inlet > 0 and all(x <= TOL_APP for x in d)):
        raise RuntimeError(f"{label}: phi not finite, out of range on the band, or the band "
                           f"differs from the slab reference: {d}")


def coupled_kernel_vs_plain_at(sim) -> float:
    """One coupled step from the main path's final state: a fresh coupled
    kernel wrapper against its plain version on the card; f, rho, u to the
    step bounds, g and phi relative to ``local_scale`` of the state (the
    walls have grown phi).  The spare buffers are freed first; the plain version's
    peak memory is reported.  Returns max |df|."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step
    from torch_cases import local_scale

    t = sim.phys_time()
    u_in, force = sim.update_inflow(t), sim.body_force(t)
    nu, phi_in = sim.domain.units.lbm_viscosity(), float(sim.phi_inflow)
    sim._spare = sim._g_spare = None
    torch.cuda.empty_cache()
    step = make_fused_coupled_step(sim.cfg, sim.domain, sim.ade_cfg, sim.ade_domain, DEVICE)
    k = step(sim.f, sim.g, nu, sim._nu_ade, u_in=u_in, force=force, phi_in=phi_in)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    p = step.plain(sim.f, sim.g, nu, sim._nu_ade, u_in=u_in, force=force, phi_in=phi_in)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated()
    scale = local_scale(sim.g)
    d = (max_diff(k[0], p[0]), max_diff(k[2], p[2]), max_diff(k[3], p[3]),
         scaled_diff(k[1], p[1], scale), scaled_diff(k[4], p[4], scale))
    log("main", path=f"sim_coupled_res{COUPLED_RES}", compare="kernel vs plain, one step from "
        "the final state", shape="x".join(map(str, sim.domain.shape)), max_df=d[0],
        max_drho=d[1], max_du=d[2], max_dg_scaled=d[3], max_dphi_scaled=d[4],
        plain_peak_gb=f"{plain_peak / 1e9:.3f}",
        plain_temporaries_gb=f"{(plain_peak - base) / 1e9:.3f}")
    del k, p
    torch.cuda.empty_cache()
    if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U and d[3] <= TOL_G
            and d[4] <= TOL_PHI):
        raise RuntimeError(f"coupled_ab vs plain on sim_coupled res {COUPLED_RES}: {d}")
    return d[0]


def coupled_aa_kernel_vs_plain_at(sim) -> dict:
    """From the A-A main path's final state (an even parity next), one even
    and then one odd parity of a fresh B8 wrapper against its plain version
    on the card, each from the same input on both sides: f, rho, u to the
    step bounds, g and phi relative to ``local_scale`` of the input g.  The
    spare buffers are freed first; the plain versions' peak memory is
    reported.  Returns max(|df|, |dg|) per kernel."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step_aa
    from torch_cases import local_scale

    t = sim.phys_time()
    u_in, force = sim.update_inflow(t), sim.body_force(t)
    nu, phi_in = sim.domain.units.lbm_viscosity(), float(sim.phi_inflow)
    sim._spare = sim._g_spare = None
    torch.cuda.empty_cache()
    step = make_fused_coupled_step_aa(sim.cfg, sim.domain, sim.ade_cfg, sim.ade_domain, DEVICE)
    f, g, err = sim.f, sim.g, {}
    for parity, name in ((sim.iterations % 2, "coupled_aa_even"),
                         (1 - sim.iterations % 2, "coupled_aa_odd")):
        args = dict(u_in=u_in, force=force, phi_in=phi_in, parity=parity)
        k = step(f.clone(), g.clone(), nu, sim._nu_ade, **args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        p = step.plain(f, g, nu, sim._nu_ade, **args)
        torch.cuda.synchronize()
        plain_peak = torch.cuda.max_memory_allocated()
        scale = local_scale(g)
        d = (max_diff(k[0], p[0]), max_diff(k[2], p[2]), max_diff(k[3], p[3]),
             scaled_diff(k[1], p[1], scale), scaled_diff(k[4], p[4], scale))
        log("main", path=f"sim_coupled_res{COUPLED_RES}_AA", compare="kernel vs plain, from "
            "the final state", kernel=name, shape="x".join(map(str, sim.domain.shape)),
            max_df=d[0], max_drho=d[1], max_du=d[2], max_dg_scaled=d[3], max_dphi_scaled=d[4],
            plain_peak_gb=f"{plain_peak / 1e9:.3f}",
            plain_temporaries_gb=f"{(plain_peak - base) / 1e9:.3f}")
        del p, scale
        torch.cuda.empty_cache()
        if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U and d[3] <= TOL_G
                and d[4] <= TOL_PHI):
            raise RuntimeError(f"{name} vs plain on sim_coupled res {COUPLED_RES}: {d}")
        err[name] = max(d[0], d[3])
        f, g = k[0], k[1]
        del k
    return err


def sim1_main_path(streaming: str = "AB", resolution: int = SIM1_RES, counted: bool = True):
    """sim_1 at ``resolution`` through its ``build`` with ``streaming`` (A-B:
    the A-B kernel; A-A: the even and odd kernels), APP_STEPS steps with
    its own probes (VTK3D, the whole lattice, is switched off: one cycle is
    1.1 GB of files at res 8), then one more VTK2D cycle from the final
    state, read back and held against the fields on the card."""
    from tnl_lbm_tpu_torch.apps import sim_1
    from tnl_lbm_tpu_torch.sim.state import VTK3D

    where = WORK / "main" if streaming == "AB" else WORK / "main" / f"sim_1_{streaming}"
    sim = sim_1.build(resolution, device=DEVICE, streaming=streaming,
                      results_parent=where / f"res{resolution}")
    sim.phys_final_time = APP_STEPS * sim.domain.units.phys_dt
    sim.cnt[VTK3D].period = -1.0
    if counted:
        counting_from_init(sim)
    if not sim.run():
        raise RuntimeError(f"sim_1 res {resolution} {streaming} failed (NaN or refused)")
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
        log("main", path=f"sim_1_res{resolution}_{streaming}", vtk2d=p.name, cycles=p.cycle,
            read_back="equal", plane="x".join(map(str, want_rho.shape)))
    return sim


def sim1_aa_kernel_vs_plain(resolution: int = SIM1_AA_PLAIN_RES) -> dict:
    """sim_1 with A-A streaming at ``resolution``, APP_STEPS steps through
    the even and odd kernels, then from its final state one even and then
    one odd step of a fresh A-A step wrapper against its plain version on
    the card, each from the same input, with the step bounds.  At res 8 the
    plain A-A step's whole-array temporaries would not fit beside the run
    (the plain A-B step peaked at 73.3 GB there), so this runs at res 4.
    Returns max |df| per kernel."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa

    sim = sim1_main_path("AA", resolution, counted=False)
    t = sim.phys_time()
    u_in, force = sim.update_inflow(t), sim.body_force(t)
    f, nu = sim.f, sim.domain.units.lbm_viscosity()
    step = make_fused_step_aa(sim.cfg, sim.domain, DEVICE)
    err = {}
    for parity, name in ((sim.iterations % 2, "aa_even"), (1 - sim.iterations % 2, "aa_odd")):
        fk, rk, uk = step(f.clone(), nu, u_in=u_in, force=force, parity=parity)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fp, rp, up = step.plain(f, nu, u_in=u_in, force=force, parity=parity)
        torch.cuda.synchronize()
        plain_peak = torch.cuda.max_memory_allocated()
        d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
        log("main", path=f"sim_1_res{resolution}_AA", compare="kernel vs plain, from the final "
            f"state (res {resolution})", kernel=name, shape="x".join(map(str, sim.domain.shape)),
            max_df=d[0], max_drho=d[1], max_du=d[2], plain_peak_gb=f"{plain_peak / 1e9:.3f}",
            plain_temporaries_gb=f"{(plain_peak - base) / 1e9:.3f}", variant=step.variant)
        del fp, rp, up
        torch.cuda.empty_cache()
        if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
            raise RuntimeError(f"{name} vs plain on sim_1 res {resolution} A-A: {d}")
        err[name], f = d[0], fk
    return err


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
    for app, streaming in (("sim_1", "AB"), ("sim_3", "AB"), ("sim_1", "AA")):
        app_kernel_vs_plain(app, streaming)
    for streaming in ("AB", "AA"):
        coupled_app_kernel_vs_plain(streaming)


def coupled_app_kernel_vs_plain(streaming: str) -> None:
    """sim_coupled at resolution 2 with ``streaming``, APP_STEPS steps
    through the coupled kernel (B7; A-A: B8) and through the plain steps on
    the card, from the same start; phi is held relative to ``local_scale``
    of the plain run's phi, since the A-B walls grow it."""
    from tnl_lbm_tpu_torch.apps import sim_coupled
    from torch_cases import local_scale

    runs = {}
    for fused in (True, False):
        sim = sim_coupled.build(2, device=DEVICE, use_fused=fused, streaming=streaming,
                                results_parent=WORK / "accuracy" / f"sim_coupled_{streaming}_{fused}")
        sim.phys_final_time = APP_STEPS * sim.domain.units.phys_dt
        if not sim.run() or sim.iterations != APP_STEPS:
            raise RuntimeError(f"sim_coupled res 2 {streaming} (use_fused={fused}) failed")
        runs[fused] = sim
    k, p = runs[True], runs[False]
    d = (max_diff(k.rho, p.rho), max_diff(k.u, p.u),
         scaled_diff(k.phi, p.phi, local_scale(p.phi)))
    step, launches = k._coupled_step, sum(kernel_launches(k).values())
    log("accuracy", path=f"sim_coupled_res2_{streaming}", steps=APP_STEPS,
        coupled_kernel=k.coupled_kernel, max_drho=d[0], max_du=d[1], max_dphi_scaled=d[2],
        max_abs_phi=float(p.phi.abs().max()), launches=launches, plain_calls=step.plain_calls)
    if not (all(x <= TOL_APP for x in d) and launches == APP_STEPS
            and k.coupled_kernel == f"one-kernel-{streaming}"
            and step.plain_calls == 0 and p.coupled_kernel == "plain"):
        raise RuntimeError(f"sim_coupled res 2 {streaming}: kernel vs plain over {APP_STEPS} "
                           f"steps: {d}")


def app_kernel_vs_plain(name: str, streaming: str) -> None:
    """An app at resolution 2 with ``streaming``, APP_STEPS steps through the
    kernels (A-B: B4; A-A: B2 and B3) and through the plain step on the
    card, from the same initial state."""
    import importlib

    import torch

    app = importlib.import_module(f"tnl_lbm_tpu_torch.apps.{name}")
    runs = {}
    kw = {"streaming": streaming} if streaming == "AA" else {}  # sim_3 is A-B only
    for fused in (True, False):
        sim = app.build(2, device=DEVICE, use_fused=fused,
                        results_parent=WORK / "accuracy" / f"{name}_{streaming}_{fused}", **kw)
        sim.phys_final_time = APP_STEPS * sim.domain.units.phys_dt
        if not sim.run() or sim.iterations != APP_STEPS:
            raise RuntimeError(f"{name} res 2 {streaming} (use_fused={fused}) failed")
        runs[fused] = sim
    k, p = runs[True], runs[False]
    d_rho, d_u = max_diff(k.rho, p.rho), max_diff(k.u, p.u)
    moved = float(k.u.abs().max())
    launches = sum(kernel_launches(k).values())
    log("accuracy", path=f"{name}_res2_{streaming}", steps=APP_STEPS, max_drho=d_rho,
        max_du=d_u, max_abs_u=moved, launches=launches, plain_calls=k._step.plain_calls)
    if not (d_rho <= TOL_APP and d_u <= TOL_APP and torch.isfinite(k.u).all() and moved > 0
            and launches == APP_STEPS and k._step.plain_calls == 0):
        raise RuntimeError(f"{name} res 2 {streaming}: kernel vs plain over {APP_STEPS} "
                           f"steps: drho {d_rho}, du {d_u}")


def kernel_footprints(ops: dict) -> dict:
    """(bytes per site, FP32 operations per site) of each kernel at its
    timed 256^3 inputs: the bytes it must move (each input read once, each
    output written once) and the SASS count of ``phase_build`` (the pair:
    two of the lean CUM_WELL site updates it shares with the odd kernel's
    FLUID/WALL/NOTHING instance, per site; P2: the affine passes, 2
    operations per DF)."""
    from tnl_lbm_tpu_torch.kernels.fused_aa import PAIR_TILE

    even, odd = ops["aa_even_cum_well_kernel"], ops["aa_odd_kernel"]
    pair = 2 * odd
    affine = 2 * 27 * 20  # PROBE_PASSES' timed entry: 20 passes
    sites = float(np.prod(BENCH_SHAPE))
    block0 = 27 * 4 * (np.prod([t + 2 for t in PAIR_TILE]) + np.prod(PAIR_TILE))
    return {
        "aa_even": (233, even), "aa_odd": (233, odd),
        "aa_pair_f32": (PAIR_BYTES["f32"], pair),
        "aa_pair_f16": (PAIR_BYTES["f16"], pair),
        "aa_pair_bf16": (PAIR_BYTES["bf16"], pair),
        "ab_step": (AB_BYTES, ops["ab_step_cum_well_kernel"]),
        "copy_permute": (232, ops["copy_permute_kernel"]),
        "pair_pipeline": (216, affine),
        "pair_compute_only": (block0 / sites, affine),
        "ade_step": (ADE_BYTES, ops["ade_step_clbm_kernel"]),
        "coupled_ab": (COUPLED_BYTES, ops["coupled_cum_well_clbm_kernel"]),
        "coupled_aa_even": (COUPLED_BYTES, ops["coupled_aa_even_cum_well_clbm_kernel"]),
        "coupled_aa_odd": (COUPLED_BYTES, ops["coupled_aa_odd_cum_well_clbm_kernel"]),
    }


def bound(bytes_per_site: float, ops_per_site: float) -> tuple[float, str]:
    """The least time in ms at 256^3: bytes over the published HBM rate or
    FP32 operations over the published FP32 rate, whichever is larger."""
    sites = float(np.prod(BENCH_SHAPE))
    t_bytes = bytes_per_site * sites / (HBM_PEAK_GBPS * 1e9) * 1e3
    t_ops = ops_per_site * sites / (FP32_PEAK_TFLOPS * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    if not (ROOT / "tnl_lbm_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    # the package, and the geometries shared with the tests (tests/torch_cases.py)
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    shutil.rmtree(WORK, ignore_errors=True)
    device = phase_device()
    ops = phase_build()
    steps = phase_compare_steps()
    aa_codes_err = phase_compare_aa_codes()
    pairs = phase_compare_pairs(steps["times"])
    probe = phase_probes()
    floor = gbps(232, probe["times"]["copy_permute"][0])
    ab = phase_compare_ab(steps["times"], floor)
    ade_err = phase_compare_ade()
    coupled_err = phase_compare_coupled()
    timed = phase_time_coupled(floor)
    coupled_aa = phase_compare_coupled_aa()
    timed_aa = phase_time_coupled_aa(steps["times"], floor)
    main_path = phase_main_path()
    kernels = main_path["kernels"]
    phase_accuracy()
    err = {**steps["err"], **pairs["err"], **probe["err"], **ab["err"]}
    for key in ("aa_even", "aa_odd"):
        err[key] = max(err[key], aa_codes_err, main_path["err"][key])
    for key in ("ab_step", "ade_step", "coupled_ab", "coupled_aa_even", "coupled_aa_odd"):
        err[key] = max(err.get(key, 0.0), main_path["err"].get(key, 0.0),
                       timed["err"].get(key, 0.0), ade_err.get(key, 0.0),
                       coupled_err.get(key, 0.0), coupled_aa["err"].get(key, 0.0),
                       timed_aa["err"].get(key, 0.0))
    times = {**steps["times"], **pairs["times"], **probe["times"], **ab["times"],
             **timed["times"], **timed_aa["times"]}
    kernels.update(probe["kernels"])
    footprint = kernel_footprints(ops)
    record = {"kernels": []}
    for key, k in kernels.items():
        bound_ms, bound_by = bound(*footprint[key])
        record["kernels"].append(
            {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
             "launches": k.launches, "max_abs_err": err[key], "ms": times[key][0],
             "plain_ms": times[key][1], "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": None})
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
