"""Whether a kernel-vs-plain check before a timing moves the float64 times.

    python tests/f64_timing_order.py

On one CUDA card: B4's float64 CUM_WELL step (A-B) and B2's float64 even
step (A-A) on the 256^3 bench duct, each timed on CUDA events over 20
launches from a fresh seeded state, either directly or right after one
launch held to the plain version on the same state (the plain call's
whole-array temporaries allocated and freed first), in turns: direct,
check, check, direct, twice.  Prints the card's name and power limit, then
one line per step with both lists of ms.
"""

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tnl_lbm_tpu_torch.kernels.build import build_library  # noqa: E402
from tnl_lbm_tpu_torch.kernels.fused import make_fused_step  # noqa: E402
from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa  # noqa: E402


def free() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    cs.phase_device()
    build_library()
    force = (cs.FORCE_BENCH, 0.0, 0.0)
    for streaming in ("AB", "AA"):
        cfg, dom = cs.flagship(cs.BENCH_SHAPE, streaming=streaming)
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float64)
        step = (make_fused_step if streaming == "AB" else make_fused_step_aa)(cfg, dom, cs.DEVICE)
        res = {"direct": [], "after_check": []}
        for order in ("direct", "after_check", "after_check", "direct") * 2:
            free()
            f = cs.seeded_state64(cs.BENCH_SHAPE, torch.float64)
            if order == "after_check":
                want = step.plain(f, cs.NU, force=force)
                free()
                cs.agree(step(f, cs.NU, force=force), want, cs.F64_TOL, "check")
                del want
                free()
            out = torch.empty_like(f)
            if streaming == "AB":
                ms = cs.time_ms(lambda: step(f, cs.NU, force=force, out=out), reps=20)
            else:
                ms = cs.time_ms(lambda: step(f, cs.NU, force=force, parity=0), reps=20)
            res[order].append(ms)
            del f, out
        print("B4 f64" if streaming == "AB" else "B2 f64",
              {k: " ".join(f"{v:.4f}" for v in vs) for k, vs in res.items()}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
