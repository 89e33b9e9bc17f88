"""The "auto" pair-dispatch probe on sim_2 res 8 A-A over 2 shards of one
card, repeated, each time beside ``chip_smoke.py`` ``auto_choice``'s longer
chains of both routes.

    python tests/auto_probe_repeat.py [REPEATS]

On one CUDA card: builds the kernels, then REPEATS times (default 6) a
fresh ``sim_2.build(8, streaming="AA", use_fused=True,
pair_dispatch="auto")`` under a 1x2x1 plan, whose ``sim_init`` runs the
probe, and ``auto_choice`` on it (5 chains of 20 pairs of each route; a
verdict only where the chains separate the routes).  Prints the card's
name and power limit, then one ``[main] path=auto`` line per repeat and a
``DISAGREES`` line for each repeat whose probe picked the slower route.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tnl_lbm_tpu_torch.apps import sim_2  # noqa: E402
from tnl_lbm_tpu_torch.parallel.sharded import choose_plan  # noqa: E402


def main(repeats: int = 6) -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cs.phase_device()
    disagree = 0
    for rep in range(repeats):
        sim = sim_2.build(cs.SHARDED_RES, device=cs.DEVICE, streaming="AA", use_fused=True,
                          pair_dispatch="auto", results_parent=cs.WORK / "auto_repeat" / str(rep))
        sim.plan = choose_plan(sim.domain, [cs.DEVICE + ":0"] * 2)
        sim.sim_init()
        try:
            cs.auto_choice(sim, f"repeat {rep}")
        except RuntimeError as exc:
            disagree += 1
            print("DISAGREES", exc, flush=True)
        del sim
        torch.cuda.empty_cache()
    return 1 if disagree else 0


if __name__ == "__main__":
    sys.exit(main(*map(int, sys.argv[1:])))
