"""Where the A-B step (B4) spends its extra time on sim_2 --velocity's map.

    python tests/b4_map_ablation.py

On one CUDA card: B4's float32 CUM_WELL vector instance at 256^3 from one
seeded state, timed in turns (CUDA events, 20 launches, three rounds) on
sim_2 --velocity's res-8 map (an INFLOW_LEFT plane, OUTFLOW_RIGHT_INTERP, a
NOTHING ring around the WALL planes), on that map with its NOTHING sites
made WALL, on it with the inflow and outflow planes made FLUID and x
periodic, and on the bench duct's map (WALL faces, periodic x).  Prints the
card's name and power limit, then one line per map.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tnl_lbm_tpu_torch import interop  # noqa: E402
from tnl_lbm_tpu_torch.kernels.fused import make_fused_step  # noqa: E402
from tnl_lbm_tpu_torch.ops.boundary import GEO  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    cfg, dom, _ = cs.velocity_domain(8, "single")
    _, bench = cs.flagship(cs.BENCH_SHAPE, streaming="AB")
    walls = dom.map.copy()
    walls[walls == GEO.NOTHING] = GEO.WALL
    closed = np.isin(dom.map, (GEO.INFLOW_LEFT, GEO.OUTFLOW_RIGHT_INTERP))
    maps = {"velocity": (dom.map, dom.periodic),
            "velocity_nothing_as_wall": (walls, dom.periodic),
            "velocity_periodic_x": (np.where(closed, GEO.FLUID, dom.map).astype(np.uint8),
                                    (True, False, False)),
            "bench_duct": (bench.map, bench.periodic)}
    f = cs.seeded_state64(cs.BENCH_SHAPE, torch.float32)
    out = torch.empty_like(f)
    steps = {k: make_fused_step(cfg, interop.domain_from_numpy(m, p), "cuda")
             for k, (m, p) in maps.items()}
    turns = cs.in_turns({k: (lambda s=s: s(f, cs.NU, u_in=cs.U_IN64, out=out))
                         for k, s in steps.items()}, rounds=3, reps=20)
    for k, t in turns.items():
        print(f"b4_map {k} ms={' '.join(f'{x:.4f}' for x in t)} median={np.median(t):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
