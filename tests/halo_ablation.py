"""The haloed kernels (``csrc/halo_step.cu``) against the unsharded ones and
against variants with a register cap, at sim_2 res 8's shard block.

    python tests/halo_ablation.py

On one CUDA card, on the 32 x 128 x 256 block of sim_2 res 8 on 2 y-shards
(a seeded state, halos from the sharded step's exchange): B4's haloed
CUM_WELL instance and B3's haloed lean instance, each from the library and
from ``halo_step.cu`` built again with ``__launch_bounds__(128, n)`` for n =
3..6 (registers and spill bytes from ptxas, the output held bit for bit to
the library's), all on CUDA events over 20 launches; then the unsharded
B4 and B3 (lean) on a block of the same shape and map, and the exchange of
the 2 shards.  Prints the card's name and power limit, then one line each.
"""

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tnl_lbm_tpu_torch import interop  # noqa: E402
from tnl_lbm_tpu_torch.apps import sim_2  # noqa: E402
from tnl_lbm_tpu_torch.kernels.build import CSRC, NVCC_FLAGS, _nvcc, load_library  # noqa: E402
from tnl_lbm_tpu_torch.kernels.fused import make_fused_step  # noqa: E402
from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa  # noqa: E402
from tnl_lbm_tpu_torch.parallel import sharded as sh  # noqa: E402

WORK = ROOT / "build" / "halo_ablation"
MIN_BLOCKS = (3, 4, 5, 6)


def build(n: int):
    """halo_step.cu with ``__launch_bounds__(THREADS, n)`` as a library of
    its own: (n, path, [(kernel, spill bytes, registers)])."""
    src = (CSRC / "halo_step.cu").read_text().replace('#include "lbm_site.cuh"',
                                                      f'#include "{CSRC}/lbm_site.cuh"')
    path = WORK / f"halo_mb{n}.cu"
    path.write_text(src.replace("__launch_bounds__(THREADS)", f"__launch_bounds__(THREADS, {n})"))
    so = WORK / f"halo_mb{n}.so"
    out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so), str(path)],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    regs = re.findall(r"Function properties for (\w+)\n.*?(\d+) bytes spill stores.*?\n"
                      r".*?Used (\d+) registers", out.stdout + out.stderr, re.S)
    return n, so, regs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cs.phase_device()
    WORK.mkdir(parents=True, exist_ok=True)
    libs = {"library": load_library()}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    with ThreadPoolExecutor(len(MIN_BLOCKS)) as ex:
        for n, so, regs in ex.map(build, MIN_BLOCKS):
            lib = ctypes.CDLL(str(so))
            lib.tnl_lbm_ab_step_halo.argtypes = [p] * 6 + [i] * 6 + [f] * 7 + [i, p]
            lib.tnl_lbm_ab_step_halo.restype = i
            lib.tnl_lbm_aa_odd_halo.argtypes = [p] * 6 + [i] * 8 + [f] * 7 + [i, p]
            lib.tnl_lbm_aa_odd_halo.restype = i
            libs[f"min_blocks_{n}"] = lib
            print(f"[ptxas] min_blocks={n} " + " ".join(f"{k}:{r}regs/{s}B" for k, s, r in regs),
                  flush=True)
    nu, fx = cs.NU, cs.FORCE_SMALL
    for streaming in ("AB", "AA"):
        s = sim_2.build(8, device="cuda", streaming=streaming, results_parent=WORK / "sims")
        plan = cs.card_plan((1, 2, 1))
        make = sh.make_sharded_fused_step if streaming == "AB" else sh.make_sharded_fused_step_aa
        step = make(s.cfg, s.domain, plan)
        f0 = plan.shard_field(cs.seeded_cfg_state(s.cfg, s.domain.shape), like_f=True)
        halo = step.exchange(f0)[0]
        ls = step.local_step
        X, Y, Z = ls.shape
        fo = torch.empty((27, X, Y, Z), device="cuda")
        rho = torch.empty((X, Y, Z), device="cuda")
        u = torch.empty((3, X, Y, Z), device="cuda")
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ref = None
        for name, lib in libs.items():
            if streaming == "AB":
                args = (halo.data_ptr(), fo.data_ptr(), step.maps.blocks[0].data_ptr(), None,
                        rho.data_ptr(), u.data_ptr(), X, Y, Z, 0, 0, 0, nu, fx, 0.0, 0.0, 0.0,
                        0.0, 0.0, 0, stream)
                run = lambda lib=lib, a=args: lib.tnl_lbm_ab_step_halo(*a)  # noqa: E731
            else:
                gbits = sum(1 << k for k, g in enumerate(ls._faces(step.bflags[0])) if g)
                args = (halo.data_ptr(), fo.data_ptr(), step.rings[0].data_ptr(), None,
                        rho.data_ptr(), u.data_ptr(), X, Y, Z, 0, gbits, 1, ls.variant, 0, nu, fx,
                        0.0, 0.0, 0.0, 0.0, 0.0, 0, stream)
                run = lambda lib=lib, a=args: lib.tnl_lbm_aa_odd_halo(*a)  # noqa: E731
            ms = cs.time_ms(run, 20)
            run()
            torch.cuda.synchronize()
            ref = fo.clone() if ref is None else ref
            print(f"[halo] {streaming} {name} ms={ms:.4f} block={X}x{Y}x{Z} "
                  f"equal_to_library={torch.equal(fo, ref)}", flush=True)
        block = np.ascontiguousarray(s.domain.map[:, :Y])
        dom = interop.domain_from_numpy(block, s.domain.periodic)
        one = (make_fused_step if streaming == "AB" else make_fused_step_aa)(s.cfg, dom, "cuda")
        fb = cs.seeded_cfg_state(s.cfg, block.shape)
        out = torch.empty_like(fb)
        kw = {"parity": 1} if streaming == "AA" else {}
        ms = cs.time_ms(lambda: one(fb, nu, force=(fx, 0.0, 0.0), out=out, **kw), 20)
        print(f"[halo] {streaming} unsharded kernel on a {X}x{Y}x{Z} block of the same map "
              f"ms={ms:.4f}", flush=True)
        ms = cs.time_ms(lambda: step.exchange(f0), 20)
        print(f"[halo] {streaming} exchange of the 2 shards ms={ms:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
