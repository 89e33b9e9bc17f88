"""Register-cap probe of the A-A coupled pair (B8), on the card.

B8's odd kernel moves the even kernel's bytes but takes longer, with 106-114
registers per thread against 64-68.  This probe builds ``csrc/coupled_aa.cu``
a second time with its kernels' ``__launch_bounds__(COUPLED_THREADS)`` given
a minimum of ``MIN_BLOCKS`` blocks per SM (6: at most 80 registers for 128
threads, against four blocks uncapped; ``-maxrregcount`` does not apply to a
kernel with launch bounds) and times both builds on the bench duct at
256^3 with an ADE lattice (WALL faces, periodic x, CLBM, scalar diffusion),
for the CUM_WELL instance (the duct's) and CUM + ``eq_quadratic``
(sim_coupled's), each parity from the same seeded state, in the order
uncapped, capped, capped, uncapped.  It prints the card, the capped build's
registers and spills per odd instance, and per instance and parity both
times, GB/s at 294 B/site and whether the two builds' outputs are equal bit
for bit.  Run it from the repository root::

    python -m tnl_lbm_tpu_torch.kernels.regcap_probe

The capped build goes to ``build/torch_kernels/regcap_<n>/``; nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from unittest import mock

import numpy as np

from tnl_lbm_tpu_torch.kernels import build, fused_coupled

SHAPE = (256, 256, 256)
#: bytes per site of one B8 parity: 27 f32 in and out, map, rho/u; 7 f32 in and out, ADE map, phi
BYTES_PER_SITE = 294
NU, NU_ADE, FORCE = 0.02, 0.02, (1e-6, 0.0, 0.0)
SPECS = {"cum_well": ("CUM_WELL", "EQ_WELL", True), "cum_quad": ("CUM", "EQ", False)}
MIN_BLOCKS = 6
REPS = 20  # launches per timing, as chip_smoke.py times the kernels


def build_capped(min_blocks: int) -> tuple[ctypes.CDLL, dict]:
    """``coupled_aa.cu`` alone, its launch bounds given ``min_blocks`` blocks
    per SM: the loaded library (its entry point typed as the main build's)
    and the ptxas resources per kernel."""
    out = build.BUILD_DIR / f"regcap_{min_blocks}"
    out.mkdir(parents=True, exist_ok=True)
    bounds = "__launch_bounds__(COUPLED_THREADS)"
    src = (build.CSRC / "coupled_aa.cu").read_text()
    if src.count(bounds) != 2:
        raise RuntimeError(f"expected the even and the odd kernel's {bounds} in coupled_aa.cu")
    capped_src = out / "coupled_aa.cu"
    capped_src.write_text(src.replace(bounds, f"__launch_bounds__(COUPLED_THREADS, {min_blocks})"))
    lib_path = out / "libcoupled_aa.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-shared", "-o",
                           str(lib_path), str(capped_src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.tnl_lbm_coupled_aa.argtypes = build.load_library().tnl_lbm_coupled_aa.argtypes
    lib.tnl_lbm_coupled_aa.restype = ctypes.c_int
    return lib, build.kernel_resources(proc.stdout + proc.stderr)


def bench_pair(spec, device):
    """B8 on the bench duct with an ADE lattice, under A-A streaming."""
    from tnl_lbm_tpu_torch import interop
    from tnl_lbm_tpu_torch.models import D3Q7
    from tnl_lbm_tpu_torch.ops.boundary import GEO
    from tnl_lbm_tpu_torch.sim.step_ade import ADEGEO

    mn = np.zeros(SHAPE, np.uint8)
    mn[:, 0] = mn[:, -1] = GEO.WALL
    mn[:, :, 0] = mn[:, :, -1] = GEO.WALL
    ma = np.where(mn == GEO.WALL, int(ADEGEO.WALL), 0).astype(np.uint8)
    periodic = (True, False, False)
    return fused_coupled.make_fused_coupled_step_aa(
        interop.config_from_spec(*spec, "AA"), interop.domain_from_numpy(mn, periodic),
        interop.ade_config_from_spec("CLBM", "AA"),
        interop.domain_from_numpy(ma, periodic, lat=D3Q7), device)


def seeded_state(pair, device):
    """(f, g): equilibria of a seeded rho, u and phi."""
    import torch

    from tnl_lbm_tpu_torch.ops.equilibrium import eq_quadratic

    rng = np.random.default_rng(7)
    rho = torch.from_numpy((1 + 0.01 * rng.standard_normal(SHAPE)).astype(np.float32))
    u = torch.from_numpy((0.02 * rng.standard_normal((3,) + SHAPE)).astype(np.float32))
    phi = torch.from_numpy((0.5 + 0.1 * rng.standard_normal(SHAPE)).astype(np.float32))
    cfg = pair.nse.cfg
    f = cfg.eq(cfg.lat, rho.to(device), u.to(device)).float().contiguous()
    g = eq_quadratic(pair.ade.lat, phi.to(device), u.to(device)).float().contiguous()
    return f, g


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("the register-cap probe needs a CUDA device")
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    capped, resources = build_capped(MIN_BLOCKS)
    for name, res in sorted(resources.items()):
        if "odd" in name:
            print(json.dumps({"capped_kernel": name, **res}), flush=True)
    sites = float(np.prod(SHAPE))
    main_lib = build.load_library()
    for label, spec in SPECS.items():
        pair = bench_pair(spec, device)
        f0, g0 = seeded_state(pair, device)
        fo, go = torch.empty_like(f0), torch.empty_like(g0)
        for parity in (0, 1):
            def run(lib, f, g):
                with mock.patch.object(fused_coupled, "load_library", lambda: lib):
                    return pair(f, g, NU, NU_ADE, force=FORCE, parity=parity, out_f=fo,
                                out_g=go)

            outs = [[t.clone() for t in run(lib, f0.clone(), g0.clone())]
                    for lib in (main_lib, capped)]
            equal = all(torch.equal(a, b) for a, b in zip(*outs))
            del outs
            fw, gw = f0.clone(), g0.clone()  # the even parity updates them in place
            ms = [time_ms(lambda lib=lib: run(lib, fw, gw), REPS)
                  for lib in (main_lib, capped, capped, main_lib)]
            del fw, gw
            uncapped, cap = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
            print(json.dumps({
                "instance": f"coupled_aa_{('even', 'odd')[parity]}_{label}_clbm",
                "shape": "256^3", "uncapped_ms": ms[0::3], "capped_ms": ms[1:3],
                "gbps_uncapped": BYTES_PER_SITE * sites / (uncapped * 1e-3) / 1e9,
                "gbps_capped": BYTES_PER_SITE * sites / (cap * 1e-3) / 1e9,
                "capped_over_uncapped": cap / uncapped, "bit_equal": equal}), flush=True)
        del f0, g0, fo, go, pair
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
