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
streaming, the A-A coupled pair (B8) - in sim_coupled; the D2Q9 step (B5)
with the Bouzidi curved walls in sim2d_1, sim2d_2 and sim2d_3, held to the
TPU-measured golden KE corpus; the forcing-hook path - the non-Newtonian
force through the one-kernel NN step (B10) or the pipeline of the u* pass
(the macro_only variants of B4, B2/B3), the NN force kernel (B9) and the
force_field variants (B4, B2/B3, B5) - in ``Simulation`` and
``CoupledSimulation``; the port's benchmark entry (``python -m
tnl_lbm_tpu_torch.bench``) through the one-kernel pair (B1) and the
two-kernel pair (B1b); the site-major A-B step (B4s) and the window probes
(P3, P4).  Each phase prints result lines; any failing phase raises and the
script exits non-zero without printing a result.

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
   the element pipeline P3 (scripts/probe_element_pipeline.py's four
   (tile, passes) variants) and the window copy P4 (the six covering
   windows of scripts/probe_dma_align.py, each through 4-byte loads,
   16-byte loads and TMA) on a padded [27, 260, 272, 256] state, their
   interiors bit-equal to the plain versions', and P4's seventh window,
   which does not cover its tile, raising; then all timed;
   layouts (after 3c): the two-kernel A-A pair B1b on sim_2's res-2 duct
   and on the box of every A-A code per variant, two pairs from the same
   input on both sides, each kernel on its own too and the even kernel's
   ring equal to ``pad_halo`` bit for bit; at 256^3 against its plain
   version and timed (pair, even, odd) beside B1 and B2 + B3; the
   site-major A-B step B4s on 3c's cases (dummy components zero), then at
   256^3 against its plain version and timed beside B4;
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
   the run); then the benchmark entry (``tnl_lbm_tpu_torch.bench``'s
   ``main``, its JSON line parsed): pair2 in f32, f16 and bf16 and pair
   (B1b), 50 timed pairs each from the rest state at 256^3, every kernel's
   launch count > 0 and no plain call;
6. the 2D slice (after the main paths; the D2Q9 kernel's bounds as the
   step compares'):
   a. compare_2d: B5 against its plain version at 37 x 150 (neither a
      multiple of the block) on sim2d_2's channel, the channel with a WALL
      block in a Bouzidi ring (seeded thetas in (0.05, 0.95) on the links
      that hit it, -1 on the others), the periodic-x channel and a box of
      every code B5 takes with ring sites on the domain edge; SRT and CLBM,
      force absent and present, the inflow as a vector and as a [2, 1, Y]
      profile on the card; one step from the same input, then 4 chained
      steps on each side compared at the end;
   b. golden_2d: sim2d_3 at resolution 1 to t = 0.4 (1440 steps) through
      B5 on all 108 rows of tests/golden/geometry_ke_values_tpu.csv, the
      geometries written by scripts/make_golden_geometries.py; the 12 rows
      the JAX suite samples within 1e-4 relative; the worst row over the
      108 and the count beyond 1e-4 printed; 1440 launches and 0 plain
      calls per row;
   c. apps_2d: sim2d_3 res 2 (geometry 1's disk scaled by 2 in a seeded
      ring), sim2d_1 res 4 with ``--use-fused`` (its VTK2D cut read back)
      and sim2d_2 res 1 on geometry 1 with Bouzidi (the statistics state
      machine compressed, from step 150), each through B5 and through the
      plain step on the card from the same start: rho and u within 1e-5,
      sim2d_2's accumulators, counts, events and TKE too;
   d. time_2d: sim2d_3's channel at resolution 64 (8192 x 2048, the site
      count of 256^3) with geometry 1's disk scaled by 64 in a seeded
      ring: 200 steps through ``Simulation`` (MLUPS, peak memory), the
      profiler's busy share over 10 more; on the state after the 200, B5
      timed in three windows of 20 launches (the median; the card's clocks
      beside them) and against its plain version (one step; plain: 3
      calls, its peak memory), GB/s at the 85 B/site this data needs
      (plus the ring's thetas and the profile) against P1;
7. the forcing-hook slice (``phase_compare_hooked`` right after the build,
   the rest after the 3D main paths; the 2D run after the 2D slice):
   a. compare_hooked: B9 (Carreau-Yasuda and Casson, the hook wrapped as
      the domain and not; |dF| <= 1e-6 of max |F|), B10 (A-B, A-A even and
      odd, 4 chained steps; the hook wrapping z where the domain does not)
      on a wall duct, a periodic box with a ragged Z and a closed box with
      an obstacle; the force_field and macro_only variants of B4 and B2/B3
      on those and on the boxes of every code; B5's force_field variant on
      the 2D channels - each against its plain version with the step bounds;
   b. main_hooked: the 256^3 bench duct with ``CarreauYasuda(0.1, 1, 2,
      0.5)`` (scripts/bench_hooked.py), an evolved state (100 one-kernel
      A-B steps from rest), then 100 steps each through ``Simulation``: A-B
      and A-A on the one-kernel route (the hook wrapped as the domain) and
      on the pipeline (the hook without ``periodic``), each with ms/step,
      MLUPS, peak memory, launches (every step through its route, 0 plain
      calls), the sampled phase times, the profiler's busy share over 10
      more steps, one step from the final state against the plain hooked
      step, the route's kernels timed (20
      launches; plain: 3 calls) with GB/s and registers, and on the
      one-kernel routes the pipeline with the same hook held to B10;
   c. blunt: the Carreau-Yasuda channel of JAX
      tests/test_non_newtonian.py:42-78 (4 x 4 x 21, CUM_WELL f32) through
      B10 and its Newtonian twin through B4, 3000 + 1 steps: the shape
      factor must drop by more than 0.01, and each lie within 1e-3 of the
      JAX XLA step's value;
   d. coupled_hooked: sim_coupled res 2 with the hook ("two-kernel": the
      hooked A-B step, then B6), 100 steps against the plain coupled run,
      and one step against the plain steps;
   e. hooked_2d: sim2d_3's res-64 channel with the hook, 100 steps (the
      plain u* pass and hook, then B5's force_field variant), one step
      against the plain hooked step, B5's force_field variant timed;
8. accuracy: sim_2 res 2 run to its stopping point per step and in pairs
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
67 TFLOP/s, at 256^3 sites; B5's launches: the golden sweep, the three 2D
apps' kernel runs and the res-64 run; B1b's: the bench entry's; B4s's and
the probes': their timings'; library_ms: P4's function as one PyTorch
call, ``interior(fpad).contiguous()``, and null where no single PyTorch
call computes a kernel's function; B1b's two entries also give the pair's
time, ``pair_ms``, and its least-work bound, ``pair_bound_ms``: B1's 233
B/site); the last line is ``{"ok": true, "device": {...}}``.  The
script's total time and that of the P3/P4, layouts and bench-entry phases
are logged before them.
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
SITEMAJOR_BYTES = 253  # B4s: 27 f32 in, 32 out (the zero dummies), the map, rho and u
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
#: the P3 variant and the P4 window of the JSON record: 20 passes as P2's,
#: and the script's status-quo window (y_off 0, ty + 16 rows, dst_off 0)
ELEMENT_TIMED, WINDOW_TIMED = (8, 32, 20), (0, 48, 0)
DEVICE = "cuda"
#: the D2Q9 step (B5): 9 f32 in and out, the map, rho and u (B/site); the
#: thetas and the profile are added per run, at the sites that read them
B5_BYTES = 85
D2Q9_KERNEL_NAMES = ("d2q9_srt_kernel", "d2q9_srt_force_kernel", "d2q9_clbm_kernel")
#: sim2d_3's channel at resolution 64: 8192 x 2048, the site count of 256^3
TIME_2D_RES = 64
#: the rows of the golden corpus that the JAX suite samples
#: (tests/test_geometry_pipeline.py:138-143), (geometry, Bouzidi)
GOLDEN_SAMPLED = ((1, True), (4, True), (4, False), (6, True), (9, False), (14, True),
                  (18, False), (23, True), (29, False), (33, True), (41, True), (54, False))
TOL_GOLDEN = 1e-4  # relative (tests/test_geometry_pipeline.py:151-154)
GOLDEN_STEPS = 1440  # resolution 1 to the corpus' final time 0.4


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
    """The bench duct of the port's benchmark entry (``bench.flagship``:
    walls on the y and z faces, periodic in x, lattice viscosity NU), with
    ``streaming`` and, for "f16" / "bf16", half storage."""
    from tnl_lbm_tpu_torch import bench

    cfg, dom = bench.flagship(shape)
    cfg = dataclasses.replace(cfg, streaming=streaming)
    if storage not in (None, "f32"):
        cfg = dataclasses.replace(cfg, storage_dtype=store_dtype(storage))
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
LAYOUT_KERNEL_NAMES = (("aa_pair_pad_odd_kernel",)
                       + tuple(f"aa_pair_pad_{p}_{n}_kernel" for p in ("even", "odd")
                               for n in NSE_VARIANTS)
                       + tuple(f"ab_step_sitemajor_{n}_kernel" for n in NSE_VARIANTS))
WINDOW_KERNEL_NAMES = tuple(f"window_copy_{load}_kernel" for load in ("ld4", "ld16", "tma"))


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
              "pair_compute_only_kernel", "element_pipeline_kernel") + LAYOUT_KERNEL_NAMES
             + WINDOW_KERNEL_NAMES + AA_KERNEL_NAMES + ADE_KERNEL_NAMES
             + COUPLED_KERNEL_NAMES + COUPLED_AA_KERNEL_NAMES + D2Q9_KERNEL_NAMES
             + NN_KERNEL_NAMES)
    for name in names:
        if name not in res or name not in ops:
            raise RuntimeError(f"no ptxas report or SASS for {name}:\n{ptxas}")
        log("build", kernel=name, **res[name], fp32_ops_per_thread=ops[name])
    log("build", seconds=f"{time.perf_counter() - t0:.1f}",
        pair_dynamic_smem_bytes=lib.tnl_lbm_aa_pair_smem_bytes(),
        nn_step_dynamic_smem_bytes=lib.tnl_lbm_nn_step_smem_bytes())
    return {"ops": ops, "res": res}


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
    """P1-P4 at 256^3 against their plain versions (P4's uncovering window
    must raise), then timed with the launch counts set to 0 just before."""
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
    X, Y, Z = BENCH_SHAPE
    t_window = time.perf_counter()
    fpad = torch.randn((27, X + 4, Y + 16, Z), device=dev,
                       generator=torch.Generator(dev).manual_seed(4))
    for tx, ty, passes in probes.ELEMENT_VARIANTS:  # the interiors, bit for bit
        got = probes.element_pipeline(fpad, tx, ty, passes)
        want = probes.element_pipeline_plain(fpad, tx, ty, passes)
        if not torch.equal(probes.interior(got), probes.interior(want)):
            raise RuntimeError(f"element_pipeline ({tx}, {ty}, {passes}) is not its plain "
                               f"version's interior bit for bit")
        del got, want
    covering = [v for v in probes.DMA_VARIANTS if probes.window_covers(v[0], v[1], v[3])]
    for y_off, wy, label, dst_off in probes.DMA_VARIANTS:
        if (y_off, wy, label, dst_off) not in covering:
            try:
                probes.window_copy(fpad, y_off, wy, dst_off)
            except ValueError as exc:
                log("probes", window=repr(label), covers=False, raises=repr(str(exc)[:60]))
                continue
            raise RuntimeError(f"window_copy {label!r} does not cover its tile and did not raise")
        for load in probes.LOADS:
            if not torch.equal(probes.window_copy(fpad, y_off, wy, dst_off, load),
                               probes.window_copy_plain(fpad, y_off, wy, dst_off)):
                raise RuntimeError(f"window_copy {label!r} ({load}) is not the interior")
    for name in ("element_pipeline",) + tuple(name for _, name in probes.LOADS.values()):
        err[name] = 0.0  # bit-equal interiors, checked above
    t_window = time.perf_counter() - t_window
    torch.cuda.synchronize()
    log("probes", compare="kernel vs plain at 256^3", covering_windows=len(covering),
        **{f"max_abs_err_{k}": v for k, v in err.items()})
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
    t_start = time.perf_counter()
    for tx, ty, passes in probes.ELEMENT_VARIANTS:
        ms = time_ms(lambda: probes.element_pipeline(fpad, tx, ty, passes), reps=20)
        plain_ms = time_ms(lambda: probes.element_pipeline_plain(fpad, tx, ty, passes), reps=3)
        if (tx, ty, passes) == ELEMENT_TIMED:
            times["element_pipeline"] = (ms, plain_ms)
        script_bytes = 27 * 4 * ((tx + 4) * (ty + 16) / (tx * ty) + 1)  # the script's GB count
        log("probes", kernel="element_pipeline", tile=f"{tx}x{ty}", passes=passes,
            zchunk=probes.element_zchunk(tx, ty, Z), ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}",
            gbps_216B=f"{gbps(216, ms):.1f}", gbps_script=f"{gbps(script_bytes, ms):.1f}")
    library = {}  # P4's function as one PyTorch call: the interior, made contiguous
    for y_off, wy, label, dst_off in covering:
        line = {}
        timed = (y_off, wy, dst_off) == WINDOW_TIMED
        if timed:
            library_ms = time_ms(lambda: probes.interior(fpad).contiguous(), reps=20)
            line["library_ms"] = f"{library_ms:.4f}"
        for load, (_, name) in probes.LOADS.items():
            ms = time_ms(lambda: probes.window_copy(fpad, y_off, wy, dst_off, load), reps=20)
            line[f"{load}_ms"] = f"{ms:.4f}"
            if timed:
                plain_ms = time_ms(lambda: probes.window_copy_plain(fpad, y_off, wy, dst_off),
                                   reps=3)
                times[name] = (ms, plain_ms)
                library[name] = library_ms
        script_bytes = 27 * 4 * (20 * wy / (16 * 32) + 1)
        log("probes", kernel="window_copy", window=repr(label), y_off=y_off, wy=wy,
            dst_off=dst_off, **line, gbps_216B_tma=f"{gbps(216, float(line['tma_ms'])):.1f}",
            gbps_script_tma=f"{gbps(script_bytes, float(line['tma_ms'])):.1f}")
    del fpad
    torch.cuda.empty_cache()
    t_window += time.perf_counter() - t_start
    counts = {k: v.launches for k, v in probes.KERNELS.items()}
    log("probes", launches=counts)
    if min(counts.values()) <= 0:
        raise RuntimeError("a probe kernel was not launched")
    return {"err": err, "times": times, "library": library, "kernels": dict(probes.KERNELS),
            "window_seconds": t_window}


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


def b1b_bytes(shape) -> tuple[float, float]:
    """Bytes per site the two-kernel pair's kernels must move at ``shape``:
    even (f in, the map, the padded buffer out) and odd (the buffer and the
    map in, f2, rho and u out)."""
    X, Y, _ = shape
    ring = (X + 2) * (Y + 2) / (X * Y)
    return 108 + 1 + 108 * ring, 108 * ring + 1 + 108 + 16


def pad_pair_cases():
    """(label, cfg, domain, u_in) of the two-kernel pair's compare: sim_2's
    res-2 duct and the box of every A-A code per variant."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.apps import sim_2
    from torch_cases import AB_SPECS, U_IN, aa_box

    sim = sim_2.build(2, device=torch.device(DEVICE), streaming="AA", use_fused=True,
                      results_parent=WORK / "compare_layouts")
    yield "sim_2_res2", sim.cfg, sim.domain, None
    box = interop.domain_from_numpy(aa_box((24, 20, 150)), (False, False, True))
    for name, spec in AB_SPECS.items():
        yield f"aa_box_{name}", interop.config_from_spec(*spec, "AA"), box, U_IN


def pad_pair_vs_plain(pair, f, force, u_in=None) -> tuple:
    """One two-kernel pair from f against its plain version on the same
    input, each kernel on its own too (the odd kernel and its plain version
    on the even kernel's buffer); raises when the ring is not ``pad_halo``
    of the buffer's interior bit for bit.  Returns (the pair's max |df|,
    |drho|, |du|, the even kernel's |df|, the odd kernel's |df|, the pair's
    output)."""
    import torch

    from tnl_lbm_tpu_torch.ops.streaming import pad_halo

    fpad = pair.even_step(f, NU, u_in, force)
    if not torch.equal(fpad, pad_halo(fpad[:, 1:-1, 1:-1], pair.periodic[:2])):
        raise RuntimeError("the even kernel's ring is not pad_halo of its output")
    d_even = max_diff(fpad, pair.plain_even_step(f, NU, u_in, force))
    f2, rho, u = pair.odd_step(fpad, NU, u_in, force)
    d_odd = max_diff(f2, pair.plain_odd_step(fpad, NU, u_in, force)[0])
    del fpad
    fp, rp, up = pair.plain(f, NU, u_in, force)
    d = (max_diff(f2, fp), max_diff(rho, rp), max_diff(u, up))
    return d + (d_even, d_odd, f2)


def phase_layouts(times: dict, floor_gbps: float) -> dict:
    """The layout variants: the two-kernel A-A pair (B1b) and the site-major
    A-B step (B4s) against their plain versions on small cases, then at
    256^3 against their plain versions and timed beside the one-kernel
    pair (B1) and one even plus one odd launch (B2 + B3), and beside the
    A-B step (B4).  B4s's launch count is its timing's."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused import (
        from_sitemajor,
        make_fused_step_sitemajor,
        to_sitemajor,
    )
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair_aa

    dev = torch.device(DEVICE)
    force = (FORCE_SMALL, 0.0, 0.0)
    err = {"aa_pair_pad_even": 0.0, "aa_pair_pad_odd": 0.0, "ab_step_sitemajor": 0.0}
    out_times = {}
    for label, cfg, dom, u_in in pad_pair_cases():
        pair = make_fused_pair_aa(cfg, dom, dev)
        f = rand_f(cfg, dom.shape, dev, seed=5)
        worst = [0.0] * 5
        for _ in range(2):
            *d, f = pad_pair_vs_plain(pair, f, force, u_in)
            worst = [max(a, b) for a, b in zip(worst, d)]
        log("layouts", kernel="aa_pair_pad", case=label, shape="x".join(map(str, dom.shape)),
            variant=pair.variant, pairs=2, max_df=worst[0], max_drho=worst[1],
            max_du=worst[2], max_df_even=worst[3], max_df_odd=worst[4], ring_exact=True)
        if not (max(worst[0], worst[3], worst[4]) <= TOL_F and worst[1] <= TOL_RHO
                and worst[2] <= TOL_U):
            raise RuntimeError(f"aa_pair_pad vs plain on {label} out of tolerance: {worst}")
        err["aa_pair_pad_even"] = max(err["aa_pair_pad_even"], worst[3], worst[0])
        err["aa_pair_pad_odd"] = max(err["aa_pair_pad_odd"], worst[4], worst[0])

    cfg, dom = flagship(BENCH_SHAPE)
    pair = make_fused_pair_aa(cfg, dom, dev)
    bench_force = (FORCE_BENCH, 0.0, 0.0)
    f0 = rand_f(cfg, dom.shape, dev, seed=7)
    d = pad_pair_vs_plain(pair, f0, bench_force)[:5]
    torch.cuda.empty_cache()
    if not (max(d[0], d[3], d[4]) <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
        raise RuntimeError(f"aa_pair_pad vs plain at 256^3 out of tolerance: {d}")
    err["aa_pair_pad_even"] = max(err["aa_pair_pad_even"], d[3], d[0])
    err["aa_pair_pad_odd"] = max(err["aa_pair_pad_odd"], d[4], d[0])
    fpad = pair.even_step(f0, NU, force=bench_force)
    pair_ms = time_ms(lambda: pair(f0, NU, force=bench_force), reps=20)
    even_ms = time_ms(lambda: pair.even_step(f0, NU, force=bench_force), reps=20)
    odd_ms = time_ms(lambda: pair.odd_step(fpad, NU, force=bench_force), reps=20)
    even_plain = time_ms(lambda: pair.plain_even_step(f0, NU, force=bench_force), reps=3)
    odd_plain = time_ms(lambda: pair.plain_odd_step(fpad, NU, force=bench_force), reps=3)
    del f0, fpad
    torch.cuda.empty_cache()
    out_times["aa_pair_pad_even"] = (even_ms, even_plain)
    out_times["aa_pair_pad_odd"] = (odd_ms, odd_plain)
    b_even, b_odd = b1b_bytes(BENCH_SHAPE)
    two_steps = times["aa_even"][0] + times["aa_odd"][0]
    log("layouts", kernel="aa_pair_pad", shape="256^3", variant=pair.variant, max_df=d[0],
        max_drho=d[1], max_du=d[2], max_df_even=d[3], max_df_odd=d[4], pair_ms=f"{pair_ms:.4f}",
        even_ms=f"{even_ms:.4f}", odd_ms=f"{odd_ms:.4f}", even_plain_ms=f"{even_plain:.2f}",
        odd_plain_ms=f"{odd_plain:.2f}", b1_pair_ms=f"{times['aa_pair_f32'][0]:.4f}",
        b2_plus_b3_ms=f"{two_steps:.4f}",
        over_b1=f"{pair_ms / times['aa_pair_f32'][0]:.3f}",
        over_b2_b3=f"{pair_ms / two_steps:.3f}",
        gbps_even=f"{gbps(b_even, even_ms):.1f}", gbps_odd=f"{gbps(b_odd, odd_ms):.1f}",
        gbps_233B_pair=f"{gbps(233, pair_ms):.1f}",
        share_of_233B_bound=f"{gbps(233, pair_ms) / HBM_PEAK_GBPS:.3f}",
        share_of_p1_floor=f"{gbps(b_even + b_odd, pair_ms) / floor_gbps:.3f}")

    for label, cfg, dom, u_in in ab_cases():
        step = make_fused_step_sitemajor(cfg, dom, dev)
        fs = to_sitemajor(rand_f(cfg, dom.shape, dev, seed=11))
        fk, rk, uk = step(fs, NU, u_in=u_in, force=force)
        fp, rp, up = step.plain(fs, NU, u_in=u_in, force=force)
        torch.cuda.synchronize()
        d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
        zero = bool((fk[:, :, 27:] == 0).all())
        log("layouts", kernel="ab_step_sitemajor", case=label, shape="x".join(map(str, dom.shape)),
            max_df=d[0], max_drho=d[1], max_du=d[2], dummies_zero=zero)
        if not (zero and d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
            raise RuntimeError(f"ab_step_sitemajor vs plain on {label}: {d}, dummies zero {zero}")
        err["ab_step_sitemajor"] = max(err["ab_step_sitemajor"], d[0])

    cfg, dom = flagship(BENCH_SHAPE, streaming="AB")
    step = make_fused_step_sitemajor(cfg, dom, dev)
    fs = to_sitemajor(rand_f(cfg, dom.shape, dev, seed=7))
    fk, rk, uk = step(fs, NU, force=bench_force)
    fp, rp, up = step.plain(fs, NU, force=bench_force)
    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
    zero = bool((fk[:, :, 27:] == 0).all())
    del fk, rk, uk, fp, rp, up
    torch.cuda.empty_cache()
    if not (zero and d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
        raise RuntimeError(f"ab_step_sitemajor vs plain at 256^3: {d}, dummies zero {zero}")
    err["ab_step_sitemajor"] = max(err["ab_step_sitemajor"], d[0])
    step.reset_counts()
    ms = time_ms(lambda: step(fs, NU, force=bench_force), reps=20)
    plain_ms = time_ms(lambda: step.plain(fs, NU, force=bench_force), reps=3)
    del fs
    torch.cuda.empty_cache()
    out_times["ab_step_sitemajor"] = (ms, plain_ms)
    log("layouts", kernel="ab_step_sitemajor", shape="256^3", max_df=d[0], max_drho=d[1],
        max_du=d[2], ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}",
        ab_step_ms=f"{times['ab_step'][0]:.4f}", over_b4=f"{ms / times['ab_step'][0]:.3f}",
        gbps_253B=f"{gbps(SITEMAJOR_BYTES, ms):.1f}",
        share_of_p1_floor=f"{gbps(SITEMAJOR_BYTES, ms) / floor_gbps:.3f}",
        launches=step.kernel.launches)
    if step.kernel.launches <= 0:
        raise RuntimeError("ab_step_sitemajor was not launched")
    return {"err": err, "times": out_times, "pair_ms": pair_ms,
            "kernels": {"aa_pair_pad_even": pair.even, "aa_pair_pad_odd": pair.odd,
                        "ab_step_sitemajor": step.kernel}}


def phase_bench() -> dict:
    """The port's benchmark entry (``python -m tnl_lbm_tpu_torch.bench``),
    run in this process through its ``main`` and read from the JSON line it
    prints: the one-kernel pair (B1) per store dtype and the two-kernel
    pair (B1b).  Each run counts its kernels' launches from 0; every one
    must be > 0.  Returns kernel name -> launches."""
    import contextlib
    import io

    from tnl_lbm_tpu_torch import bench

    launches = {}
    for kernel, storage in (("pair2", "f32"), ("pair2", "f16"), ("pair2", "bf16"),
                            ("pair", "f32")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench.main(["--kernel", kernel, "--storage", storage])
        lines = buf.getvalue().strip().splitlines()
        rec = json.loads(lines[-1])
        log("bench", kernel=kernel, storage=storage, mlups=rec["value"],
            bound_mlups=rec["bound_mlups"], share_of_bound=rec["share_of_bound"],
            launches=rec["launches"], plain_calls=rec["plain_calls"], seconds=rec["seconds"],
            device=repr(rec["device"]), nvidia_smi=repr(rec["nvidia_smi"]))
        if (len(lines) != 1 or min(rec["launches"].values()) <= 0 or rec["plain_calls"] != 0
                or not rec["value"] > 0):
            raise RuntimeError(f"bench {kernel} {storage}: {lines}")
        for name, n in rec["launches"].items():
            launches[name] = launches.get(name, 0) + n
    return launches


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
    if hasattr(step, "route"):  # a hooked step: every kernel of its routes, by name
        launches = {k.name: k.launches for w in step.kernels for k in cuda_kernels(w)}
        if hasattr(sim, "coupled_kernel"):
            launches["ade"] = sim._ade_step.kernel.launches
        return launches
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
    return {"d2q9" if sim.cfg.lat.D == 2 else "ab": step.kernel.launches}


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
    of the profiled host time the device was busy.  The kernel events the
    profiler recorded are printed beside the launches the wrappers counted
    in the window: where it recorded fewer, its device time and busy share
    read low.  Runs past the checked state; a run's own checks come first."""
    from torch.profiler import ProfilerActivity, profile

    sim._advance(5)
    t0 = time.perf_counter()
    sim._advance(steps)
    unprofiled = (time.perf_counter() - t0) * 1e3
    launched = sum(kernel_launches(sim).values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim._advance(steps)
        wall = (time.perf_counter() - t0) * 1e3
    launched = sum(kernel_launches(sim).values()) - launched
    device, count = {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            device[e.key], count[e.key] = us / 1e3, e.count
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:4]
    log("profile", path=label, steps=steps, unprofiled_ms_per_step=f"{unprofiled / steps:.4f}",
        profiled_ms_per_step=f"{wall / steps:.4f}", device_ms_per_step=f"{busy / steps:.4f}",
        device_busy_share=f"{busy / wall:.4f}" if wall else "n/a",
        kernel_events=sum(count[k] for k in count if k.endswith("_kernel")),
        launches_in_window=launched,
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

# ------------------------------------------------------------------ 2D slice

def golden_geometries() -> Path:
    """The golden corpus' 54 geometry files (scripts/make_golden_geometries.py),
    written once per call of the script."""
    out = WORK / "golden_geos"
    if not (out / "54.txt").exists():
        subprocess.run([sys.executable, str(ROOT / "scripts" / "make_golden_geometries.py"),
                        str(out)], check=True, capture_output=True)
    return out


def check_2d(label: str, d) -> None:
    if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
        raise RuntimeError(f"d2q9_step vs plain on {label} out of tolerance: {d}")


def phase_compare_2d() -> float:
    """B5 against its plain version on the card: each ``case_2d`` geometry at
    37 x 150 (neither a multiple of the block: the channel, the channel with
    a WALL block in a Bouzidi ring of seeded thetas in (0.05, 0.95) and -1
    links, the periodic-x channel, the box of every code with ring sites on
    the y = 0 edge), SRT and CLBM, force absent and present, the inflow as
    a vector and as a [2, 1, Y] profile on the card: one step from a seeded
    state on both sides, then 4 chained steps on each side, compared at the
    end.  Returns max |df|."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.kernels.fused_2d import make_fused_step_2d
    from torch_cases import (D2_COLLISIONS, D2_KINDS, FORCE_2D, U_IN_2D, case_2d,
                             parabolic_2d, seeded_2d)

    shape = (37, 150)
    prof = torch.tensor(parabolic_2d(shape[1]), dtype=torch.float32, device=DEVICE)
    worst = 0.0
    for kind in D2_KINDS:
        m, periodic, bz = case_2d(kind, shape)
        for collision in D2_COLLISIONS:
            cfg = interop.config_2d_from_spec(collision)
            dom = interop.domain_from_numpy(m, periodic, lat=cfg.lat, bouzidi=bz)
            step = make_fused_step_2d(cfg, dom, DEVICE)
            d1, d4 = [0.0] * 3, [0.0] * 3
            for force in (None, FORCE_2D):
                for u_in in (U_IN_2D, prof):
                    fk = fp = seeded_2d(cfg, shape, DEVICE, seed=11)
                    for it in range(4):
                        fk, rk, uk = step(fk, NU, u_in=u_in, force=force)
                        fp, rp, up = step.plain(fp, NU, u_in=u_in, force=force)
                        d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
                        check_2d(f"{kind} {collision} step {it}", d)
                        acc = d1 if it == 0 else d4
                        acc[:] = [max(a, b) for a, b in zip(acc, d)]
            torch.cuda.synchronize()
            log("compare_2d", case=kind, collision=collision, shape="x".join(map(str, shape)),
                codes="+".join(sorted(c.name for c in step.codes)),
                ring_links=0 if bz is None else int((bz >= 0).sum()),
                max_df_1=d1[0], max_drho_1=d1[1], max_du_1=d1[2],
                max_df_4=d4[0], max_drho_4=d4[1], max_du_4=d4[2], launches=step.kernel.launches)
            worst = max(worst, d1[0], d4[0])
    return worst


def phase_golden_2d() -> dict:
    """sim2d_3 at resolution 1 to the final time 0.4 through B5 on all 108
    rows of the TPU-measured golden corpus (tests/golden/): the 12 rows the
    JAX suite samples must lie within 1e-4 relative; the worst deviation
    over the 108 and the count beyond 1e-4 are printed.  Each row runs with
    its counts set to 0 at the end of sim_init: 1440 launches, 0 plain
    calls."""
    import csv

    from tnl_lbm_tpu_torch.apps import sim2d_3

    geos = golden_geometries()
    with open(ROOT / "tests" / "golden" / "geometry_ke_values_tpu.csv") as fh:
        golden = {(r["geometry"], r["bouzidi"]): float(r["value"]) for r in csv.DictReader(fh)}
    rel, launches, kernel, rel_launch = {}, 0, None, {}
    t0 = time.perf_counter()
    for (name, bouzidi), want in golden.items():
        where = WORK / "golden" / bouzidi
        sim = counting_from_init(sim2d_3.build(
            1, str(geos / name), bouzidi == "on", final_time=0.4, results_parent=where,
            values_dir=where / "values", use_fused=True, device=DEVICE))
        if not sim.run():
            raise RuntimeError(f"sim2d_3 on {name} (Bouzidi {bouzidi}) failed")
        step = sim._step
        if (sim.iterations != GOLDEN_STEPS or step.kernel.launches != GOLDEN_STEPS
                or step.plain_calls):
            raise RuntimeError(f"sim2d_3 on {name}: {sim.iterations} steps, "
                               f"{step.kernel.launches} launches, {step.plain_calls} plain calls")
        value = float(sim.value_path.read_text())
        rel[(name, bouzidi)] = abs(value - want) / abs(want)
        launches += step.kernel.launches
        kernel = step.kernel
        if not rel_launch:
            rel_launch = golden_launch_ms(sim)
        del sim
    wall = time.perf_counter() - t0 - rel_launch["seconds"]
    worst_row = max(rel, key=rel.get)
    sampled = {f"{g}_{'on' if b else 'off'}": rel[(f"{g}.txt", "on" if b else "off")]
               for g, b in GOLDEN_SAMPLED}
    beyond = sorted(k for k, v in rel.items() if v > TOL_GOLDEN)
    log("golden_2d", rows=len(rel), steps_per_row=GOLDEN_STEPS, launches=launches, plain_calls=0,
        wall_s=f"{wall:.1f}", worst_rel=rel[worst_row], worst_row="_".join(worst_row),
        rows_beyond_tol=len(beyond), beyond=beyond or "none",
        sampled_worst_rel=max(sampled.values()))
    log("golden_2d", **{f"rel_{k}": f"{v:.3e}" for k, v in sampled.items()})
    log("golden_2d", kernel="d2q9_step", shape="128x32", **{k: f"{v:.5f}" for k, v in
                                                          rel_launch.items()})
    if max(sampled.values()) > TOL_GOLDEN:
        raise RuntimeError(f"golden rows beyond 1e-4 relative: {sampled}")
    return {"kernel": dataclasses.replace(kernel, launches=launches)}


def golden_launch_ms(sim) -> dict:
    """B5 at the golden sweep's 128 x 32 on a finished row's state: ms per
    launch from CUDA events over 200 back-to-back launches (the host's
    dispatch included, as the sweep pays it), the device time per kernel
    event of torch.profiler over 50 more, and the bound (85 B/site over
    3.35 TB/s).  The launches are another step's, not the row's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tnl_lbm_tpu_torch.kernels.fused_2d import make_fused_step_2d

    t0 = time.perf_counter()
    step = make_fused_step_2d(sim.cfg, sim.domain, DEVICE)
    f, nu = sim.f.clone(), sim.domain.units.lbm_viscosity()
    u_in, out = sim.update_inflow(sim.phys_time()), torch.empty_like(f)
    event_ms = time_ms(lambda: step(f, nu, u_in=u_in, out=out), reps=200)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            step(f, nu, u_in=u_in, out=out)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.key.startswith("d2q9_")]
    us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
             for e in events)
    count = sum(e.count for e in events)
    sites = float(np.prod(sim.domain.shape))
    return {"event_ms_per_launch": event_ms, "device_ms_per_event": us / 1e3 / max(count, 1),
            "kernel_events": count, "bound_ms": B5_BYTES * sites / (HBM_PEAK_GBPS * 1e9) * 1e3,
            "seconds": time.perf_counter() - t0}


def app_2d_runs(build, label: str, prepare):
    """(kernel run, plain run) of a 2D app's ``build(use_fused, where)``
    on the card from the same start (``prepare`` edits the built run before
    it starts: its geometry, its final time); the kernel run counted from
    sim_init."""
    runs = []
    for fused in (True, False):
        sim = build(fused, WORK / "apps_2d" / f"{label}_{'kernel' if fused else 'plain'}")
        prepare(sim)
        if fused:
            counting_from_init(sim)
        if not sim.run():
            raise RuntimeError(f"{label} (use_fused={fused}) failed")
        runs.append(sim)
    return runs


def compare_app_2d(label: str, k, p, **extra) -> float:
    """max |drho| and |du| of the kernel and plain runs within TOL_APP, B5's
    launches one per step, no plain call; returns max |du|."""
    import torch

    d_rho, d_u = max_diff(k.rho, p.rho), max_diff(k.u, p.u)
    launches, plain = k._step.kernel.launches, k._step.plain_calls
    log("apps_2d", path=label, shape="x".join(map(str, k.domain.shape)), steps=k.iterations,
        max_drho=d_rho, max_du=d_u, max_abs_u=float(k.u.abs().max()), launches=launches,
        plain_calls=plain, **extra)
    if not (d_rho <= TOL_APP and d_u <= TOL_APP and bool(torch.isfinite(k.u).all())
            and launches == k.iterations == p.iterations and plain == 0):
        raise RuntimeError(f"{label}: kernel vs plain run: drho {d_rho}, du {d_u}, "
                           f"{launches} launches, {plain} plain calls")
    return d_u


def phase_apps_2d() -> dict:
    """The three 2D apps through B5, each against the plain step's run on
    the card from the same start: sim2d_3 at resolution 2 (256 x 64) with
    geometry 1's disk scaled by 2 in a ring of seeded thetas, 100 steps;
    sim2d_1 at resolution 4 with ``--use-fused``, 100 steps, then one VTK2D
    cycle of its cut at X/2 read back and held against the card's fields;
    sim2d_2 at resolution 1 on geometry 1 with Bouzidi, the statistics state
    machine compressed as tests/test_sim2d_2.py:24-33 compresses it, with
    the window moved to step 150 so that the inflow has reached the ROI:
    the accumulators, the counts and the exported TKE against the plain
    run's (TKE within 1e-5 relative).  Returns B5's launches and max |du|."""
    from tnl_lbm_tpu_torch.apps import sim2d_1, sim2d_2, sim2d_3
    from tnl_lbm_tpu_torch.sim.state import VTK2D
    from torch_cases import compress_statistics, timing_disk_2d

    def app_steps(sim):
        sim.phys_final_time = APP_STEPS * sim.domain.units.phys_dt

    def disk_and_steps(sim):
        timing_disk_2d(sim.domain)
        app_steps(sim)

    k, p = app_2d_runs(lambda fused, where: sim2d_3.build(
        2, None, results_parent=where, values_dir=where / "values", use_fused=fused,
        device=DEVICE), "sim2d_3_res2", disk_and_steps)
    err = compare_app_2d("sim2d_3_res2_disk", k, p, ke_kernel=k.ke_value, ke_plain=p.ke_value,
                         codes="+".join(sorted(c.name for c in k._step.codes)))
    launches = k._step.kernel.launches

    k, p = app_2d_runs(lambda fused, where: sim2d_1.build(
        4, results_parent=where, use_fused=fused, device=DEVICE), "sim2d_1_res4", app_steps)
    k._write_vtk_2d()
    probe = k.probes_2d[0]
    got = read_vti(k.results_dir / "vtk2D" / f"{probe.name}_{probe.cycle - 1:06d}.vti")
    scalars, vectors = k.output_data((slice(probe.position, probe.position + 1), slice(None)))
    same = (np.array_equal(got["lbm_density"][..., 0], scalars["lbm_density"].cpu().numpy())
            and np.array_equal(got["velocity"][:2, ..., 0], vectors["velocity"].cpu().numpy()))
    if not same or k.cnt[VTK2D].count < 1:
        raise RuntimeError("sim2d_1: the VTK2D cut read back differs from the card's fields")
    err = max(err, compare_app_2d("sim2d_1_res4", k, p, vtk2d=probe.name, cycles=probe.cycle,
                                  read_back="equal"))
    launches += k._step.kernel.launches

    geo = str(golden_geometries() / "1.txt")
    k, p = app_2d_runs(lambda fused, where: sim2d_2.build(
        1, geo, results_parent=where, value_path=str(where / "tke"), use_fused=fused,
        device=DEVICE), "sim2d_2_res1", lambda sim: compress_statistics(sim, 150))
    tke = (k.integrate_tke_roi(), p.integrate_tke_roi())
    d_acc = max(max_diff(getattr(k, n), getattr(p, n))
                for n in ("sum_v", "frozen_mean", "sum_up2", "sum_upmag"))
    same = all(getattr(k, n) == getattr(p, n) for n in (
        "iterations", "mean_samples", "fluc_samples", "means_frozen", "flucs_frozen",
        "tke_value_written")) and [r["event"] for r in k.csv_rows] == [r["event"] for r in p.csv_rows]
    err = max(err, compare_app_2d("sim2d_2_res1_geometry1", k, p, tke_kernel=tke[0],
                                  tke_plain=tke[1], max_d_accumulators=d_acc,
                                  mean_samples=k.mean_samples, fluc_samples=k.fluc_samples))
    if not (same and k.tke_value_written and tke[1] > 0
            and abs(tke[0] - tke[1]) <= TOL_APP * tke[1] and d_acc <= TOL_APP):
        raise RuntimeError(f"sim2d_2: the statistics differ from the plain run's: TKE {tke}, "
                           f"accumulators {d_acc}")
    launches += k._step.kernel.launches
    return {"launches": launches, "err": err}


def card_state() -> str:
    """The card's SM and memory clocks, power draw and temperature now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def phase_time_2d(floor_gbps: float) -> dict:
    """sim2d_3's channel at resolution 64 (8192 x 2048, the site count of
    256^3) with geometry 1's disk scaled by 64 (centre (2048, 1024), radius
    256) in a one-site Bouzidi ring of seeded thetas: 200 steps through
    ``Simulation`` (counted from sim_init: ms/step, MLUPS, peak memory),
    torch.profiler over 10 more (the device's busy share), and on the state
    after the 200 B5 timed in three windows of 20 launches (the first right
    after the loop, before the profiler; ms is their median, the card's
    clocks, power and temperature read before the first and after the
    last), then against its plain version (one step from the same input,
    step bounds; 3 calls timed, peak memory).  GB/s at the bytes this run's
    data needs, against the P1 floor of this call."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim2d_3
    from tnl_lbm_tpu_torch.kernels.fused_2d import make_fused_step_2d
    from tnl_lbm_tpu_torch.ops.boundary import GEO
    from torch_cases import timing_disk_2d

    where = WORK / "time_2d"
    sim = sim2d_3.build(TIME_2D_RES, None, results_parent=where, values_dir=where / "values",
                        device=DEVICE)
    timing_disk_2d(sim.domain)
    sim.phys_final_time = BENCH_STEPS * sim.domain.units.phys_dt
    counting_from_init(sim)
    if not sim.run():
        raise RuntimeError("sim2d_3 res 64 failed")
    launches = report_main(sim, f"sim2d_3_res{TIME_2D_RES}")["d2q9"]
    if launches != BENCH_STEPS:
        raise RuntimeError(f"sim2d_3 res 64: {launches} B5 launches for {BENCH_STEPS} steps")
    kernel = dataclasses.replace(sim._step.kernel)
    dom = sim.domain
    X, Y = dom.shape
    near = int((dom.map == GEO.FLUID_NEAR_WALL).sum())
    bytes_site = B5_BYTES + (32 * near + 8 * Y) / (X * Y)  # thetas at the ring, the profile once
    evolved = sim.iterations
    f, nu, u_in = sim.f.clone(), dom.units.lbm_viscosity(), sim.update_inflow(sim.phys_time())
    step = make_fused_step_2d(sim.cfg, dom, DEVICE)
    out = torch.empty_like(f)
    before = card_state()
    windows = [time_ms(lambda: step(f, nu, u_in=u_in, out=out), reps=20)]
    profile_loop(sim, f"sim2d_3_res{TIME_2D_RES}")
    sim._spare = sim.rho = sim.u = sim.f = None
    torch.cuda.empty_cache()
    windows += [time_ms(lambda: step(f, nu, u_in=u_in, out=out), reps=20) for _ in range(2)]
    after = card_state()
    ms = float(np.median(windows))
    fk, rk, uk = step(f, nu, u_in=u_in)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fp, rp, up = step.plain(f, nu, u_in=u_in)
    torch.cuda.synchronize()
    plain_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
    check_2d("sim2d_3 res 64", d)
    del fk, rk, uk, fp, rp, up
    torch.cuda.empty_cache()
    plain_ms = time_ms(lambda: step.plain(f, nu, u_in=u_in), reps=3)
    rate = gbps(bytes_site, ms)
    log("time_2d", kernel="d2q9_step", shape=f"{X}x{Y}", evolved_steps=evolved,
        near_wall_sites=near, bytes_per_site=f"{bytes_site:.4f}", max_df=d[0], max_drho=d[1],
        max_du=d[2], ms=f"{ms:.4f}", windows_ms="/".join(f"{w:.4f}" for w in windows),
        card_before=repr(before), card_after=repr(after), plain_ms=f"{plain_ms:.2f}",
        plain_temporaries_gb=f"{plain_gb:.3f}", gbps=f"{rate:.1f}",
        share_of_p1_floor=f"{rate / floor_gbps:.3f}",
        share_of_3350=f"{rate / HBM_PEAK_GBPS:.3f}", mlups_kernel=f"{X * Y / ms / 1e3:.1f}")
    del sim, f, out
    torch.cuda.empty_cache()
    return {"kernel": kernel, "err": d[0], "time": (ms, plain_ms), "bytes": bytes_site}


# ------------------------------------------------------- the forcing-hook slice

#: B9 per site: rho and u read, the map, F written (B/site)
NN_BYTES = 29
#: a force_field step: the step's bytes and the [3] f32 force read
FF_BYTES = AB_BYTES + 12
#: the u* pass (macro_only): 27 f32 read, the map, rho and u written
MACRO_BYTES = 125
#: B5's force_field variant: the [2] f32 force read beside the step's bytes
B5_FF_EXTRA = 8
HOOKED_STEPS = 100
#: the least max |df| by which the hook must move one step from the seeded
#: 256^3 state, 100 times the step bound
HOOK_EFFECT_MIN = 100 * TOL_F
#: the bench duct's rheology (scripts/bench_hooked.py:56-69)
NN_BENCH_MODEL = "cy"
#: the JSON keys of the slice's kernels, with the ptxas/SASS instance each one's
#: figures come from (the CUM_WELL instances; B5's CLBM one, as sim2d_3 runs it)
NN_INSTANCES = {
    "nn_force": "nn_force_kernel",
    "nn_step_ab": "nn_step_ab_cum_well_kernel",
    "nn_step_even": "nn_step_even_cum_well_kernel",
    "nn_step_odd": "nn_step_odd_cum_well_kernel",
    "ab_step_force_field": "ab_step_force_field_cum_well_kernel",
    "ab_step_macro_only": "ab_macro_well_kernel",
    "aa_even_force_field": "aa_even_force_field_cum_well_kernel",
    "aa_even_macro_only": "aa_even_macro_well_kernel",
    "aa_odd_force_field": "aa_odd_force_field_cum_well_kernel",
    "aa_odd_macro_only": "aa_odd_macro_well_kernel",
    "d2q9_step_force_field": "d2q9_clbm_force_field_kernel",
}
NN_KERNEL_NAMES = tuple(NN_INSTANCES.values()) + tuple(
    f"nn_step_{m}_{n}_kernel" for m in ("ab", "even", "odd") for n in ("cum_quad", "cum_invcum")
) + tuple(f"{p}_force_field_{n}_kernel" for p in ("ab_step", "aa_even", "aa_odd")
          for n in ("cum_quad", "cum_invcum")) + (
    "ab_macro_total_kernel", "aa_even_macro_total_kernel", "aa_odd_macro_total_kernel",
    "d2q9_srt_force_field_kernel")


def check_step(label: str, d) -> None:
    """(|df|, |drho|, |du|) within the step bounds, or raise."""
    if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U):
        raise RuntimeError(f"{label} out of tolerance: {d}")


def nn_force_diff(fk, fp, label: str) -> tuple:
    """(max |dF|, max |dF| / max |F|, max |F|) of B9 against its plain
    version, or raise beyond TOL_F relative to max |F| (or at F = 0)."""
    scale = float(fp.abs().max())
    d = max_diff(fk, fp)
    if not (scale > 0 and d <= TOL_F * scale):
        raise RuntimeError(f"{label}: |dF| {d}, max |F| {scale}")
    return d, d / scale, scale


def cuda_kernels(wrapper) -> list:
    """The CudaKernel records of a kernel wrapper (``kernel``, or the
    ``ab``/``even``/``odd`` of the per-parity wrappers)."""
    from tnl_lbm_tpu_torch.kernels.fused import CudaKernel

    return [k for k in (getattr(wrapper, a, None) for a in ("kernel", "ab", "even", "odd"))
            if isinstance(k, CudaKernel)]


def hooked_cfg(cfg, model: str, periodic):
    """``cfg`` with the non-Newtonian hook of ``NN_MODELS[model]`` wrapped as
    ``periodic`` (None: edge-replicated on every axis)."""
    from tnl_lbm_tpu_torch.ops.non_newtonian import make_nn_forcing_hook
    from torch_cases import NN_MODELS

    return dataclasses.replace(cfg, forcing_hook=make_nn_forcing_hook(NN_MODELS[model],
                                                                      periodic=periodic))


def seeded_field(shape, seed: int, scale: float = 1e-5):
    """A seeded per-site force [D, *S] on the card."""
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(DEVICE)


def phase_compare_hooked() -> dict:
    """The slice's kernels against their plain versions on the card, small
    and seeded, on the wall duct (periodic x), the periodic box with a
    ragged Z and the closed box with an obstacle (tests/torch_cases.py
    nn_case), as the JAX suite varies them:

    - B9 with Carreau-Yasuda and with Casson, the hook's periodicity equal
      to the domain's and not: |dF| <= 1e-6 of max |F|;
    - B10, A-B and A-A (even, odd), 4 chained steps on each side, each
      step to the step bounds; on the duct also with the hook wrapping z
      where the domain does not (the DF reads and the stencil keep two
      flags);
    - the force_field and macro_only variants of B4 and B2/B3 (CUM_WELL and
      CUM with eq_inv_cum) on the duct, the periodic box and the box of
      every code (A-B: ``bc_box``; A-A: ``aa_box``), one step from the same
      input, a seeded per-site force plus a homogeneous one;
    - B5's force_field variant (SRT and CLBM) on the 2D channel, the
      channel with a Bouzidi ring and the periodic channel, one step and 4
      chained steps.
    Returns max |df| per JSON key (B9: |dF|; macro_only: the larger of
    |drho| and |du|) under "err", and B9's largest |dF| / max |F| under
    "nn_force_rel"."""
    import torch

    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
    from tnl_lbm_tpu_torch.kernels.fused_2d import make_fused_step_2d
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa
    from tnl_lbm_tpu_torch.kernels.fused_nn import make_nn_force_kernel
    from tnl_lbm_tpu_torch.kernels.fused_nn_step import make_fused_nn_step
    from tnl_lbm_tpu_torch.models import D2Q9
    from torch_cases import (
        NN_KINDS,
        NN_MODELS,
        U_IN,
        aa_box,
        bc_box,
        case_2d,
        nn_case,
        nn_state,
        seeded_2d,
    )

    dev = torch.device(DEVICE)
    err, rel = dict.fromkeys(NN_INSTANCES, 0.0), 0.0
    force = (FORCE_SMALL, 0.0, 0.0)

    def on_card(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    for kind in NN_KINDS:
        m, periodic, _, _ = nn_case(kind)
        dom = interop.domain_from_numpy(m, periodic)
        rho, u = on_card(nn_state(dom.shape, seed=3))
        other = None if any(periodic) else (True, True, False)
        for model in ("cy", "casson"):
            for per in (periodic, other):
                b9 = make_nn_force_kernel(NN_MODELS[model], dom, dev, periodic=per)
                fk, fp = b9(rho, u, NU), b9.plain(rho, u, NU)
                torch.cuda.synchronize()
                d = nn_force_diff(fk, fp, f"nn_force vs plain on {kind}/{model}/{per}")
                log("compare_hooked", kernel="nn_force", case=kind, model=model,
                    hook_periodic=repr(per), max_dF=d[0], max_dF_relative=d[1], max_F=d[2])
                err["nn_force"] = max(err["nn_force"], d[0])
                rel = max(rel, d[1])

    for kind in NN_KINDS:
        m, periodic, model, hook_per = nn_case(kind)
        dom = interop.domain_from_numpy(m, periodic)
        rho, u = on_card(nn_state(dom.shape, seed=5))
        for streaming in ("AB", "AA"):
            for per in (hook_per,) + (((True, False, True),) if kind == "duct" else ()):
                cfg = hooked_cfg(interop.config_from_spec("CUM_WELL", "EQ_WELL", True,
                                                          streaming), model, per)
                step = make_fused_nn_step(cfg, dom, NN_MODELS[model], per, dev)
                fk = cfg.eq(cfg.lat, rho, u).float().contiguous()
                fp = fk.clone()
                for it in range(4):
                    parity = it % 2 if streaming == "AA" else 0
                    fk, rk, uk = step(fk, NU, force=force, parity=parity)
                    fp, rp, up = step.plain(fp, NU, force=force, parity=parity)
                    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
                    key = ("nn_step_ab" if streaming == "AB"
                           else ("nn_step_even", "nn_step_odd")[parity])
                    log("compare_hooked", kernel=key, case=kind, hook_periodic=repr(per), step=it,
                        max_df=d[0], max_drho=d[1], max_du=d[2])
                    check_step(f"{key} vs plain on {kind}/{per} step {it}", d)
                    err[key] = max(err[key], d[0])

    for label, m, periodic in (("duct",) + nn_case("duct")[:2],
                               ("periodic",) + nn_case("periodic")[:2],
                               ("box", bc_box((24, 20, 150)), (False, False, True))):
        for streaming in ("AB", "AA"):
            mm = aa_box((24, 20, 150)) if label == "box" and streaming == "AA" else m
            dom = interop.domain_from_numpy(mm, periodic)
            u_in = U_IN if label == "box" else None
            field = seeded_field((3,) + dom.shape, seed=9)
            for spec in (("CUM_WELL", "EQ_WELL", True), ("CUM", "EQ_INV_CUM", False)):
                cfg = interop.config_from_spec(*spec, streaming)
                f = rand_f(cfg, dom.shape, dev, seed=13)
                build = make_fused_step if streaming == "AB" else make_fused_step_aa
                ff, macro = build(cfg, dom, dev, force_field=True), build(cfg, dom, dev,
                                                                           macro_only=True)
                for parity in ((0,) if streaming == "AB" else (0, 1)):
                    prefix = "ab_step" if streaming == "AB" else ("aa_even", "aa_odd")[parity]
                    fk, rk, uk = ff(f.clone(), NU, u_in=u_in, force=field, force_add=force,
                                    parity=parity)
                    fp, rp, up = ff.plain(f, NU, u_in=u_in, force=field, force_add=force,
                                          parity=parity)
                    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
                    log("compare_hooked", kernel=f"{prefix}_force_field", case=label,
                        variant=spec[0] + "/" + spec[1], max_df=d[0], max_drho=d[1], max_du=d[2])
                    check_step(f"{prefix}_force_field vs plain on {label}", d)
                    err[f"{prefix}_force_field"] = max(err[f"{prefix}_force_field"], d[0])
                    rk, uk = macro(f, NU, force=force, parity=parity)
                    rp, up = macro.plain(f, NU, force=force, parity=parity)
                    d = (0.0, max_diff(rk, rp), max_diff(uk, up))
                    log("compare_hooked", kernel=f"{prefix}_macro_only", case=label,
                        variant=spec[0] + "/" + spec[1], max_drho=d[1], max_du=d[2])
                    check_step(f"{prefix}_macro_only vs plain on {label}", d)
                    err[f"{prefix}_macro_only"] = max(err[f"{prefix}_macro_only"], d[1], d[2])

    for kind in ("channel", "bouzidi", "periodic"):
        m, periodic, bz = case_2d(kind, shape=(37, 150))
        dom = interop.domain_from_numpy(m, periodic, lat=D2Q9, bouzidi=bz)
        field = seeded_field((2,) + dom.shape, seed=17)
        for coll in ("SRT", "CLBM"):
            cfg = interop.config_2d_from_spec(coll)
            step = make_fused_step_2d(cfg, dom, dev, force_field=True)
            fk = seeded_2d(cfg, dom.shape, dev, seed=4)
            fp = fk.clone()
            for it in range(4):
                fk, rk, uk = step(fk, NU, u_in=(0.03, 0.0), force=field, force_add=(1e-5, 0.0))
                fp, rp, up = step.plain(fp, NU, u_in=(0.03, 0.0), force=field,
                                        force_add=(1e-5, 0.0))
                d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
                check_step(f"d2q9_step_force_field vs plain on {kind}/{coll} step {it}", d)
                err["d2q9_step_force_field"] = max(err["d2q9_step_force_field"], d[0])
            log("compare_hooked", kernel="d2q9_step_force_field", case=kind, collision=coll,
                steps=4, max_df=d[0], max_drho=d[1], max_du=d[2])
    return {"err": err, "nn_force_rel": rel}


def nn_bench_sim(streaming: str, single: bool, start=None, label: str = ""):
    """``Simulation`` on the 256^3 bench duct with the Carreau-Yasuda hook of
    scripts/bench_hooked.py, HOOKED_STEPS steps with ``use_fused``, counted
    from the end of sim_init.  ``single``: the hook wrapped as the domain
    (the one-kernel route, B10); else built without ``periodic``
    (scripts/profile_hooked.py:32), which runs the pipeline.  ``start``: the
    state the run starts from (an evolved one)."""
    import torch

    from tnl_lbm_tpu_torch.sim.state import Simulation

    class HookedDuct(Simulation):
        def body_force(self, phys_time):
            return np.array([FORCE_BENCH, 0.0, 0.0])

        def sim_init(self):
            super().sim_init()
            if start is not None:
                self.f.copy_(start)
                self._initial_macro()

    cfg, dom = flagship(BENCH_SHAPE, streaming=streaming)
    cfg = hooked_cfg(cfg, NN_BENCH_MODEL, dom.periodic if single else None)
    sim = counting_from_init(HookedDuct(
        cfg, dom, device=DEVICE, sim_id=f"hooked_duct_{label or streaming}",
        results_parent=WORK / "main_hooked", phys_final_time=HOOKED_STEPS * dom.units.phys_dt,
        steps_per_dispatch=10, use_fused=True))
    sim.sample_phases_at_finish = False
    if not sim.run():
        raise RuntimeError(f"hooked main path {label} failed (NaN or refused)")
    torch.cuda.synchronize()
    return sim


def hooked_vs_plain(step, f, force, parity: int, label: str, state: str) -> tuple:
    """One hooked step from ``f`` against the plain hooked step on the card
    (the step bounds), and the hook's effect on that step: max |df| between
    the plain hooked step and the plain step without the hook.  On the
    seeded state the effect must reach HOOK_EFFECT_MIN, so that a route
    whose NN force were wrong or missing fails the step bounds; on the
    final state of a run it is logged only (the CY force is near 1e-6
    there).  The input is cloned for the in-place A-A even pipeline.
    Returns (|df|, |drho|, |du|)."""
    import torch

    from tnl_lbm_tpu_torch.sim.step import make_step

    fk, rk, uk = step(f.clone(), NU, force=force, parity=parity)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fp, rp, up = step.plain(f, NU, force=force, parity=parity)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
    del fk, rk, uk, rp, up
    newtonian = make_step(dataclasses.replace(step.cfg, forcing_hook=None), step.domain)
    effect = max_diff(fp, newtonian(f, NU, force=force, parity=parity)[0])
    log("main_hooked", path=label, compare=f"kernel vs plain hooked step, from the {state} state",
        parity=parity, max_df=d[0], max_drho=d[1], max_du=d[2], hook_effect_max_df=effect,
        plain_temporaries_gb=f"{peak / 1e9:.3f}")
    check_step(f"{label}: kernel vs plain from the {state} state", d)
    if state == "seeded" and not effect >= HOOK_EFFECT_MIN:
        raise RuntimeError(f"{label}: the hook moves the seeded step by {effect} only")
    return d


def pipeline_parts_vs_plain(step, f, force, parity: int, label: str, state: str):
    """The pipeline's u* pass (macro_only) and B9 at 256^3 on the state
    ``f`` against their plain versions, B9 on the plain u*: ({JSON key:
    max |d|}, B9's |dF| / max |F|)."""
    fb = np.array(force, np.float32)
    prefix = "ab_step" if step.cfg.streaming == "AB" else ("aa_even", "aa_odd")[parity]
    rk, uk = step.macro(f, NU, force=fb, parity=parity)
    rp, up = step.macro.plain(f, NU, force=fb, parity=parity)
    d = (0.0, max_diff(rk, rp), max_diff(uk, up))
    check_step(f"{label}: {prefix}_macro_only vs plain from the {state} state", d)
    del rk, uk
    dF = nn_force_diff(step.nn_force(rp, up, NU), step.nn_force.plain(rp, up, NU),
                       f"{label}: nn_force vs plain from the {state} state")
    log("main_hooked", path=label, compare=f"u* pass and B9 vs plain, from the {state} state",
        parity=parity, max_drho=d[1], max_du=d[2], max_dF=dF[0], max_dF_relative=dF[1],
        max_F=dF[2])
    return {f"{prefix}_macro_only": max(d[1], d[2]), "nn_force": dF[0]}, dF[1]


def time_hooked_kernels(step, f, force, parity: int, floor_gbps: float, res: dict) -> dict:
    """Each kernel of a hooked step's route at 256^3 on the state ``f``
    (CUDA events over 20 launches; plain versions over 3 calls), GB/s at
    its bytes against the P1 floor of this call, its registers.  Returns
    {JSON key: (ms, plain ms)}."""
    import torch

    times, fb = {}, np.array(force, np.float32)
    if step.route == "single_kernel":
        k = step.nn_single
        key = ("nn_step_ab" if step.cfg.streaming == "AB"
               else ("nn_step_even", "nn_step_odd")[parity])
        out = torch.empty_like(f)
        times[key] = (time_ms(lambda: k(f, NU, force=force, parity=parity, out=out), reps=20),
                      time_ms(lambda: k.plain(f, NU, force=force, parity=parity), reps=3))
        del out
        bytes_site = {key: AB_BYTES}
    else:
        prefix = "ab_step" if step.cfg.streaming == "AB" else ("aa_even", "aa_odd")[parity]
        rho0, u0 = step.macro(f, NU, force=fb, parity=parity)
        extra = step.nn_force(rho0, u0, NU)
        work = f.clone()
        times[f"{prefix}_macro_only"] = (
            time_ms(lambda: step.macro(f, NU, force=fb, parity=parity), reps=20),
            time_ms(lambda: step.macro.plain(f, NU, force=fb, parity=parity), reps=3))
        times["nn_force"] = (time_ms(lambda: step.nn_force(rho0, u0, NU), reps=20),
                             time_ms(lambda: step.nn_force.plain(rho0, u0, NU), reps=3))
        ff = step.base
        kw = dict(force=extra, force_add=fb, parity=parity)
        times[f"{prefix}_force_field"] = (
            time_ms(lambda: ff(work, NU, **kw), reps=20),
            time_ms(lambda: ff.plain(f, NU, **kw), reps=3))
        # what force_add saves: the body force summed into the hook's field
        # in one PyTorch call, as the pipeline would run it without
        fb_site = torch.as_tensor(fb, device=f.device).view(3, 1, 1, 1)
        summed = torch.empty_like(extra)
        add_ms = time_ms(lambda: torch.add(extra, fb_site, out=summed), reps=20)
        log("time_hooked", op="hook field + body force, one torch.add (force_add's saving)",
            shape="256^3", parity=parity, ms=f"{add_ms:.4f}")
        del work, extra, rho0, u0, summed
        bytes_site = {f"{prefix}_macro_only": MACRO_BYTES, "nn_force": NN_BYTES,
                      f"{prefix}_force_field": FF_BYTES}
    torch.cuda.empty_cache()
    for key, (ms, plain_ms) in times.items():
        rate = gbps(bytes_site[key], ms)
        log("time_hooked", kernel=key, shape="256^3", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}",
            bytes_per_site=bytes_site[key], gbps=f"{rate:.1f}",
            share_of_p1_floor=f"{rate / floor_gbps:.3f}",
            registers=res.get(NN_INSTANCES[key], {}).get("registers"))
    return times


def phase_main_hooked(floor_gbps: float, res: dict) -> dict:
    """The hooked main path at 256^3 (the bench duct with
    ``CarreauYasuda(0.1, 1.0, 2.0, 0.5)``, scripts/bench_hooked.py): an
    evolved state from HOOKED_STEPS steps of the one-kernel A-B route from
    rest, then from it, HOOKED_STEPS steps each through ``Simulation`` with
    ``use_fused``: (i) A-B, one kernel (B10 ab); (ii) A-A, one kernel (B10
    even/odd); (iii) A-B pipeline (the hook without ``periodic``: B4's u*
    pass, B9, B4's force_field); (iv) A-A pipeline (B2/B3's).  Each: ms/step,
    MLUPS, peak memory, launches (every step through its route's kernels,
    0 plain calls), the sampled phase times, torch.profiler over 10 more
    steps (``profile_loop``); then one step from the final state against
    the plain hooked step, the route's kernels timed, and for
    the one-kernel routes the pipeline (``single_kernel=False``, the same
    hook) held to B10 from the same state.  Each check is made again from a
    seeded 256^3 state (u at 0.02 per site), where the CY force is large
    (HOOK_EFFECT_MIN), so that the 256^3 gates can tell a wrong NN force;
    on the pipelines the u* pass and B9 are also held to their plain
    versions from both states."""
    import torch

    from tnl_lbm_tpu_torch.kernels.hooked import make_hooked_fused_step

    warm = nn_bench_sim("AB", True, label="evolve")
    evolved = warm.f.clone()
    log("main_hooked", path="evolve", steps=warm.iterations,
        launches=kernel_launches(warm)["nn_step_ab"])
    del warm
    torch.cuda.empty_cache()
    half = HOOKED_STEPS // 2
    want = {
        "ab_single": {"nn_step_ab": HOOKED_STEPS},
        "aa_single": {"nn_step_even": half, "nn_step_odd": HOOKED_STEPS - half},
        "ab_pipeline": {"ab_step_macro_only": HOOKED_STEPS, "nn_force": HOOKED_STEPS,
                        "ab_step_force_field": HOOKED_STEPS},
        "aa_pipeline": {"aa_even_macro_only": half, "aa_odd_macro_only": HOOKED_STEPS - half,
                        "nn_force": HOOKED_STEPS, "aa_even_force_field": half,
                        "aa_odd_force_field": HOOKED_STEPS - half},
    }
    seeded = rand_f(flagship(BENCH_SHAPE)[0], BENCH_SHAPE, DEVICE, seed=21)
    kernels, err, times, mlups, rel = {}, {}, {}, {}, 0.0
    for label, want_l in want.items():
        streaming, single = label[:2].upper(), label.endswith("single")
        sim = nn_bench_sim(streaming, single, start=evolved, label=label)
        launches = report_main(sim, f"hooked_{label}")
        ran = {k: v for k, v in launches.items() if v}
        if ran != want_l or sim._step.route != ("single_kernel" if single else "pipeline"):
            raise RuntimeError(f"hooked {label}: route {sim._step.route}, launches {launches}")
        mlups[label] = run_figures(sim)[1]
        for w in sim._step.kernels:
            for k in cuda_kernels(w):
                if k.name in want_l:
                    prev = kernels.get(k.name)
                    kernels[k.name] = dataclasses.replace(
                        k, launches=k.launches + (prev.launches if prev else 0))
        phases = sim.sample_phase_timers()
        log("main_hooked", path=label, **{f"phase_{k}_ms": f"{v:.4f}" for k, v in phases.items()})
        profile_loop(sim, f"hooked_{label}")
        force = sim.body_force(0.0)
        f = sim.f
        sim._spare = None
        torch.cuda.empty_cache()
        parities = (0,) if streaming == "AB" else (0, 1)
        for parity in parities:
            other = ("odd", "even")[parity] if streaming == "AA" else None
            # the kernels whose output is f; macro_only and B9 are held apart
            f_keys = [k for k in want_l if "macro_only" not in k and k != "nn_force"
                      and (other is None or other not in k)]
            for state, f0 in (("final", f), ("seeded", seeded)):
                e = hooked_vs_plain(sim._step, f0, force, parity, f"hooked_{label}", state)[0]
                for key in f_keys:
                    err[key] = max(err.get(key, 0.0), e)
                if not single:
                    parts, r = pipeline_parts_vs_plain(sim._step, f0, force, parity,
                                                       f"hooked_{label}", state)
                    for key, v in parts.items():
                        err[key] = max(err.get(key, 0.0), v)
                    rel = max(rel, r)
            times.update(time_hooked_kernels(sim._step, f, force, parity, floor_gbps, res))
        if single:
            pipe = make_hooked_fused_step(sim.cfg, sim.domain, DEVICE, single_kernel=False)
            for parity in parities:
                for state, f0 in (("final", f), ("seeded", seeded)):
                    fk, rk, uk = sim._step(f0.clone(), NU, force=force, parity=parity)
                    fp, rp, up = pipe(f0.clone(), NU, force=force, parity=parity)
                    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
                    log("main_hooked", path=label, compare="one kernel vs pipeline, same hook",
                        state=state, parity=parity, max_df=d[0], max_drho=d[1], max_du=d[2])
                    check_step(f"hooked {label}: one kernel vs pipeline from the {state} state",
                               d)
                    del fk, rk, uk, fp, rp, up
            del pipe
        del sim, f
        torch.cuda.empty_cache()
    log("main_hooked", **{f"mlups_{k}": f"{v:.1f}" for k, v in mlups.items()},
        single_over_pipeline_ab=f"{mlups['ab_single'] / mlups['ab_pipeline']:.3f}",
        single_over_pipeline_aa=f"{mlups['aa_single'] / mlups['aa_pipeline']:.3f}")
    return {"kernels": kernels, "err": err, "times": times, "nn_force_rel": rel}


def phase_blunt() -> None:
    """The physics gate: shear thinning blunts the channel profile.  The
    channel of JAX tests/test_non_newtonian.py:42-78 (4 x 4 x 21, walls on
    the z faces, periodic x and y, nu 0.05, force 5e-6), CUM_WELL in
    float32, BLUNT_STEPS steps from rest and one more through
    ``Simulation``: the Newtonian run through B4, the Carreau-Yasuda one
    (nu0 0.5, lambda 500, a 2, n 0.3, the hook wrapped as the domain)
    through B10 - a domain smaller than B10's tile, with a ragged Z.  The
    shape factor of the CY run must lie more than 0.01 below the Newtonian
    one, and each within 1e-3 of the JAX XLA step's value."""
    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.ops.non_newtonian import make_nn_forcing_hook
    from tnl_lbm_tpu_torch.sim.state import Simulation
    from torch_cases import (
        BLUNT_FORCE,
        BLUNT_JAX,
        BLUNT_MODEL,
        BLUNT_NU,
        BLUNT_STEPS,
        blunt_channel,
        shape_factor,
    )

    class Channel(Simulation):
        def body_force(self, phys_time):
            return np.array(BLUNT_FORCE)

    m, periodic = blunt_channel()
    dom = interop.domain_from_numpy(m, periodic, phys_viscosity=BLUNT_NU)
    if abs(dom.units.lbm_viscosity() - BLUNT_NU) > 1e-12:
        raise RuntimeError(f"the channel's lattice viscosity is {dom.units.lbm_viscosity()}")
    base = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AB")
    factors = {}
    for label, hook in (("newtonian", None),
                        ("carreau_yasuda", make_nn_forcing_hook(BLUNT_MODEL, periodic=periodic))):
        sim = counting_from_init(Channel(
            dataclasses.replace(base, forcing_hook=hook), dom, device=DEVICE,
            sim_id=f"blunt_{label}", results_parent=WORK / "blunt",
            phys_final_time=(BLUNT_STEPS + 1) * dom.units.phys_dt, use_fused=True))
        sim.sample_phases_at_finish = False
        if not sim.run():
            raise RuntimeError(f"blunt channel {label} failed")
        launches = report_main(sim, f"blunt_{label}")
        key = "ab" if hook is None else "nn_step_ab"
        if {k: v for k, v in launches.items() if v} != {key: BLUNT_STEPS + 1}:
            raise RuntimeError(f"blunt channel {label}: launches {launches}")
        factors[label] = shape_factor(sim.u[0, 0, 0].cpu().numpy())
        log("blunt", run=label, shape_factor=f"{factors[label]:.6f}",
            jax_xla=f"{BLUNT_JAX[label]:.5f}", kernel="B10" if hook else "B4")
    drop = factors["newtonian"] - factors["carreau_yasuda"]
    log("blunt", drop=f"{drop:.6f}", gate="> 0.01", jax_drop="0.01302")
    if not drop > 0.01 or any(abs(factors[k] - BLUNT_JAX[k]) > 1e-3 for k in factors):
        raise RuntimeError(f"blunted profile: {factors} (JAX {BLUNT_JAX})")


def phase_coupled_hooked() -> dict:
    """sim_coupled at resolution 2 with the Carreau-Yasuda hook (wrapped as
    its domain): ``coupled_kernel`` "two-kernel", APP_STEPS steps through
    the hooked A-B step then B6 and through the plain steps on the card,
    from the same start (rho, u within TOL_APP, phi relative to its local
    magnitude); then one step from the kernel run's final state, the hooked
    step and B6 against the plain hooked step and the plain ADE step (f,
    rho, u to the step bounds, g and phi to the ADE step's relative to the
    local magnitude).  Returns the launches per JSON key."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim_coupled
    from tnl_lbm_tpu_torch.sim.step_ade import make_ade_step, transfer_direction_flags
    from torch_cases import local_scale

    runs = {}
    for fused in (True, False):
        sim = sim_coupled.build(2, device=DEVICE, use_fused=fused,
                                results_parent=WORK / "coupled_hooked" / str(fused))
        sim.cfg = hooked_cfg(sim.cfg, NN_BENCH_MODEL, sim.domain.periodic)
        sim.phys_final_time = APP_STEPS * sim.domain.units.phys_dt
        sim.sample_phases_at_finish = False
        if not counting_from_init(sim).run():
            raise RuntimeError(f"sim_coupled res 2 with a hook (use_fused={fused}) failed")
        runs[fused] = sim
    k, p = runs[True], runs[False]
    launches = kernel_launches(k)
    if (k.coupled_kernel != "two-kernel" or launches.get("ade") != APP_STEPS
            or sum(v for n, v in launches.items() if n != "ade") < APP_STEPS
            or k._step.plain_calls != 0):
        raise RuntimeError(f"sim_coupled with a hook: {k.coupled_kernel}, {launches}")
    scale = local_scale(p.phi)
    d = (max_diff(k.rho, p.rho), max_diff(k.u, p.u), scaled_diff(k.phi, p.phi, scale))
    log("coupled_hooked", path="sim_coupled_res2", route=k._step.route, steps=APP_STEPS,
        max_drho=d[0], max_du=d[1], max_dphi_scaled=d[2],
        **{f"launches_{n}": v for n, v in launches.items()})
    if not (d[0] <= TOL_APP and d[1] <= TOL_APP and d[2] <= TOL_APP):
        raise RuntimeError(f"sim_coupled with a hook: kernel vs plain run {d}")
    t = k.phys_time()
    u_in, force = k.update_inflow(t), k.body_force(t)
    nu = k.domain.units.lbm_viscosity()
    fk, rk, uk = k._step(k.f.clone(), nu, u_in=u_in, force=force)
    gk, phik = k._ade_step(k.g, uk, k._nu_ade, phi_in=float(k.phi_inflow))
    fp, rp, up = k._step.plain(k.f, nu, u_in=u_in, force=force)
    gp, phip = make_ade_step(k.ade_cfg, k.ade_domain)(
        k.g, up, k._nu_ade, phi_in=float(k.phi_inflow),
        transfer_dirs=torch.as_tensor(transfer_direction_flags(k.ade_cfg.lat, k.ade_domain.map),
                                      device=DEVICE),
        transfer_coeff=k.transfer_coeff)
    scale = local_scale(k.g)
    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up), scaled_diff(gk, gp, scale),
         scaled_diff(phik, phip, scale))
    log("coupled_hooked", compare="hooked A-B step then B6 vs plain, one step", max_df=d[0],
        max_drho=d[1], max_du=d[2], max_dg_scaled=d[3], max_dphi_scaled=d[4])
    if not (d[0] <= TOL_F and d[1] <= TOL_RHO and d[2] <= TOL_U and d[3] <= TOL_G
            and d[4] <= TOL_PHI):
        raise RuntimeError(f"sim_coupled with a hook: one step kernel vs plain {d}")
    return launches


def phase_hooked_2d(floor_gbps: float) -> dict:
    """The 2D hooked path: sim2d_3's res-64 timing channel (as phase
    time_2d) with the Carreau-Yasuda hook wrapped as its domain,
    HOOKED_STEPS steps through ``Simulation``: the plain u* pass and the
    hook as tensor ops (as the JAX package runs them in XLA), then B5's
    force_field variant, every step; one step from the final state against
    the plain hooked step; B5's force_field variant timed there (20
    launches; plain over 3 calls), GB/s at the bytes this data needs."""
    import torch

    from tnl_lbm_tpu_torch.apps import sim2d_3
    from tnl_lbm_tpu_torch.ops.boundary import GEO
    from torch_cases import timing_disk_2d

    where = WORK / "hooked_2d"
    sim = sim2d_3.build(TIME_2D_RES, None, results_parent=where, values_dir=where / "values",
                        device=DEVICE)
    timing_disk_2d(sim.domain)
    sim.cfg = hooked_cfg(sim.cfg, NN_BENCH_MODEL, sim.domain.periodic)
    sim.phys_final_time = HOOKED_STEPS * sim.domain.units.phys_dt
    sim.sample_phases_at_finish = False
    if not counting_from_init(sim).run():
        raise RuntimeError("sim2d_3 res 64 with a hook failed")
    launches = report_main(sim, f"hooked_sim2d_3_res{TIME_2D_RES}")
    if launches != {"d2q9_step_force_field": HOOKED_STEPS}:
        raise RuntimeError(f"the 2D hooked path: launches {launches}")
    kernel = dataclasses.replace(sim._step.base.kernel)
    phases = sim.sample_phase_timers()
    log("hooked_2d", **{f"phase_{k}_ms": f"{v:.4f}" for k, v in phases.items()})
    dom, step = sim.domain, sim._step
    t = sim.phys_time()
    f, nu, u_in = sim.f.clone(), dom.units.lbm_viscosity(), sim.update_inflow(t)
    force = sim.body_force(t)
    sim._spare = sim.rho = sim.u = sim.f = None
    torch.cuda.empty_cache()
    fk, rk, uk = step(f, nu, u_in=u_in, force=force)
    fp, rp, up = step.plain(f, nu, u_in=u_in, force=force)
    d = (max_diff(fk, fp), max_diff(rk, rp), max_diff(uk, up))
    log("hooked_2d", compare="kernel vs plain hooked step, from the final state", max_df=d[0],
        max_drho=d[1], max_du=d[2])
    check_step("hooked sim2d_3: kernel vs plain", d)
    del fk, rk, uk, fp, rp, up
    rho0, u0, fluid = step._ustar(f, force, 0)
    extra = step._hook(rho0, u0, nu, fluid, None)
    del rho0, u0, fluid
    torch.cuda.empty_cache()
    X, Y = dom.shape
    near = int((dom.map == GEO.FLUID_NEAR_WALL).sum())
    bytes_site = B5_BYTES + B5_FF_EXTRA + (32 * near + 8 * Y) / (X * Y)
    out = torch.empty_like(f)
    kw = dict(u_in=u_in, force=extra, force_add=force)
    ms = time_ms(lambda: step.base(f, nu, out=out, **kw), reps=20)
    plain_ms = time_ms(lambda: step.base.plain(f, nu, **kw), reps=3)
    rate = gbps(bytes_site, ms)
    log("hooked_2d", kernel="d2q9_step_force_field", shape=f"{X}x{Y}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.2f}", bytes_per_site=f"{bytes_site:.4f}", gbps=f"{rate:.1f}",
        share_of_p1_floor=f"{rate / floor_gbps:.3f}")
    del sim, f, out, extra
    torch.cuda.empty_cache()
    return {"kernel": kernel, "err": d[0], "time": (ms, plain_ms), "bytes": bytes_site}


def kernel_footprints(ops: dict, b5_bytes: float, b5_ff_bytes: float) -> dict:
    """(bytes per site, FP32 operations per site) of each kernel at its
    timed 256^3 inputs (B5: 8192 x 2048, as many sites, ``b5_bytes`` and
    ``b5_ff_bytes`` per site from the timed runs' data): the bytes it must
    move (each input read once, each output written once) and the SASS
    count of ``phase_build`` (B5: its CLBM instances, the ones timed; the
    pair: two of the lean CUM_WELL site updates it shares with the odd
    kernel's FLUID/WALL/NOTHING instance, per site; P2: the affine passes,
    2 operations per DF; the slice's kernels: their CUM_WELL instances)."""
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
        "element_pipeline": (216, 2 * 27 * ELEMENT_TIMED[2]),
        **{name: (216, 0) for name in ("window_copy", "window_copy_ld4", "window_copy_ld16")},
        "aa_pair_pad_even": (b1b_bytes(BENCH_SHAPE)[0], ops["aa_pair_pad_even_cum_well_kernel"]),
        "aa_pair_pad_odd": (b1b_bytes(BENCH_SHAPE)[1], ops["aa_pair_pad_odd_kernel"]),
        "ab_step_sitemajor": (SITEMAJOR_BYTES, ops["ab_step_sitemajor_cum_well_kernel"]),
        "ade_step": (ADE_BYTES, ops["ade_step_clbm_kernel"]),
        "coupled_ab": (COUPLED_BYTES, ops["coupled_cum_well_clbm_kernel"]),
        "coupled_aa_even": (COUPLED_BYTES, ops["coupled_aa_even_cum_well_clbm_kernel"]),
        "coupled_aa_odd": (COUPLED_BYTES, ops["coupled_aa_odd_cum_well_clbm_kernel"]),
        "d2q9_step": (b5_bytes, ops["d2q9_clbm_kernel"]),
        "nn_force": (NN_BYTES, ops[NN_INSTANCES["nn_force"]]),
        **{f"nn_step_{m}": (AB_BYTES, ops[NN_INSTANCES[f"nn_step_{m}"]])
           for m in ("ab", "even", "odd")},
        **{f"{p}_force_field": (FF_BYTES, ops[NN_INSTANCES[f"{p}_force_field"]])
           for p in ("ab_step", "aa_even", "aa_odd")},
        **{f"{p}_macro_only": (MACRO_BYTES, ops[NN_INSTANCES[f"{p}_macro_only"]])
           for p in ("ab_step", "aa_even", "aa_odd")},
        "d2q9_step_force_field": (b5_ff_bytes, ops[NN_INSTANCES["d2q9_step_force_field"]]),
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
    t_start = time.perf_counter()
    device = phase_device()
    built = phase_build()
    ops = built["ops"]
    hooked_cmp = phase_compare_hooked()
    steps = phase_compare_steps()
    aa_codes_err = phase_compare_aa_codes()
    pairs = phase_compare_pairs(steps["times"])
    probe = phase_probes()
    floor = gbps(232, probe["times"]["copy_permute"][0])
    ab = phase_compare_ab(steps["times"], floor)
    t_layouts = time.perf_counter()
    layouts = phase_layouts({**steps["times"], **pairs["times"], **ab["times"]}, floor)
    t_layouts = time.perf_counter() - t_layouts
    ade_err = phase_compare_ade()
    coupled_err = phase_compare_coupled()
    timed = phase_time_coupled(floor)
    coupled_aa = phase_compare_coupled_aa()
    timed_aa = phase_time_coupled_aa(steps["times"], floor)
    main_path = phase_main_path()
    kernels = main_path["kernels"]
    t_bench = time.perf_counter()
    bench_launches = phase_bench()
    t_bench = time.perf_counter() - t_bench
    kernels["ab_step_sitemajor"] = layouts["kernels"]["ab_step_sitemajor"]
    for key in ("aa_pair_pad_even", "aa_pair_pad_odd"):  # B1b's launches: the bench entry's
        k = layouts["kernels"][key]
        kernels[key] = dataclasses.replace(k, launches=bench_launches[k.name])
    for store in STORES:
        k = kernels[f"aa_pair_{store}"]
        kernels[f"aa_pair_{store}"] = dataclasses.replace(
            k, launches=k.launches + bench_launches[k.name])
    hooked = phase_main_hooked(floor, built["res"])
    kernels.update(hooked["kernels"])
    phase_blunt()
    for name, n in phase_coupled_hooked().items():
        if name in kernels:
            kernels[name] = dataclasses.replace(kernels[name], launches=kernels[name].launches + n)
    compare_2d_err = phase_compare_2d()
    golden = phase_golden_2d()
    apps_2d = phase_apps_2d()
    timed_2d = phase_time_2d(floor)
    kernels["d2q9_step"] = dataclasses.replace(
        timed_2d["kernel"], launches=golden["kernel"].launches + apps_2d["launches"]
        + timed_2d["kernel"].launches)
    hooked_2d = phase_hooked_2d(floor)
    kernels["d2q9_step_force_field"] = hooked_2d["kernel"]
    phase_accuracy()
    err = {**steps["err"], **pairs["err"], **probe["err"], **ab["err"], **layouts["err"],
           "d2q9_step": max(compare_2d_err, timed_2d["err"])}
    for key in ("aa_even", "aa_odd"):
        err[key] = max(err[key], aa_codes_err, main_path["err"][key])
    for key in ("ab_step", "ade_step", "coupled_ab", "coupled_aa_even", "coupled_aa_odd"):
        err[key] = max(err.get(key, 0.0), main_path["err"].get(key, 0.0),
                       timed["err"].get(key, 0.0), ade_err.get(key, 0.0),
                       coupled_err.get(key, 0.0), coupled_aa["err"].get(key, 0.0),
                       timed_aa["err"].get(key, 0.0))
    for key, e in hooked_cmp["err"].items():
        err[key] = max(e, hooked["err"].get(key, 0.0))
    nn_force_rel = max(hooked_cmp["nn_force_rel"], hooked["nn_force_rel"])
    err["d2q9_step_force_field"] = max(err["d2q9_step_force_field"], hooked_2d["err"])
    times = {**steps["times"], **pairs["times"], **probe["times"], **ab["times"],
             **layouts["times"],
             **timed["times"], **timed_aa["times"], "d2q9_step": timed_2d["time"],
             **hooked["times"], "d2q9_step_force_field": hooked_2d["time"]}
    kernels.update(probe["kernels"])
    footprint = kernel_footprints(ops, timed_2d["bytes"], hooked_2d["bytes"])
    record = {"kernels": []}
    for key, k in kernels.items():
        bound_ms, bound_by = bound(*footprint[key])
        entry = {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
                 "launches": k.launches, "max_abs_err": err[key]}
        if key == "nn_force":  # |dF| above; its gate is relative to max |F|
            entry["max_rel_err"] = nn_force_rel
        if key in ("aa_pair_pad_even", "aa_pair_pad_odd"):  # the pair against its least work
            entry["pair_ms"] = layouts["pair_ms"]
            entry["pair_bound_ms"] = bound(*footprint["aa_pair_f32"])[0]
        record["kernels"].append(
            {**entry, "ms": times[key][0], "plain_ms": times[key][1], "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": probe["library"].get(key)})
    total = time.perf_counter() - t_start
    added = probe["window_seconds"] + t_layouts + t_bench
    log("time", total_seconds=f"{total:.1f}", window_probes_seconds=f"{probe['window_seconds']:.1f}",
        layouts_seconds=f"{t_layouts:.1f}", bench_seconds=f"{t_bench:.1f}",
        added_share=f"{added / total:.3f}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
