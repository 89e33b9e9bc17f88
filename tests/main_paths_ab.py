"""MLUPS of the port's 3D main paths with the package of a given checkout,
so that two commits can be compared on one card in one call.

    python tests/main_paths_ab.py <checkout root>

Runs ``chip_smoke.py``'s loops of this checkout against the package and the
kernels of ``<checkout root>`` (built there): the 256^3 bench duct per step
(A-A, B2/B3) and through the A-B step (B4), 200 steps each; sim_1 at
resolution 8 (B4, 100 steps); sim_coupled at resolution 8 through the
coupled step (B7, 100 steps); where the checkout's package has the hooked
path (``kernels/hooked.py``), the 256^3 bench duct with the Carreau-Yasuda
hook through its one-kernel route (B10) and its pipeline, A-B and A-A, 100
steps each.  Prints one JSON line, path -> MLUPS.  Run it in turns within
one call (parent, change, change, parent) and compare only within that
call.  Needs one CUDA card.
"""

import importlib.util
import json
import shutil
import sys
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    sys.path[:0] = [str(root), str(root / "tests")]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.WORK = root / "build" / "main_paths_ab"
    shutil.rmtree(cs.WORK, ignore_errors=True)  # a finished run's flags refuse a rerun

    from tnl_lbm_tpu_torch.apps import sim_coupled
    from tnl_lbm_tpu_torch.kernels.build import load_library

    load_library()  # build this checkout's kernels before any loop is timed

    def coupled():
        sim = sim_coupled.build(cs.COUPLED_RES, device=cs.DEVICE, use_fused=True,
                                results_parent=cs.WORK / "coupled")
        sim.phys_final_time = cs.APP_STEPS * sim.domain.units.phys_dt
        if not cs.counting_from_init(sim).run():
            raise RuntimeError("sim_coupled res 8 failed")
        return sim

    runs = [("per_step", lambda: cs.bench_sim(False)),
            ("ab_step", lambda: cs.bench_sim(False, streaming="AB")),
            ("sim_1_res8", cs.sim1_main_path), ("sim_coupled_res8", coupled)]
    if (root / "tnl_lbm_tpu_torch" / "kernels" / "hooked.py").exists():
        runs += [(f"hooked_{s.lower()}_{route}",
                  lambda s=s, route=route: cs.nn_bench_sim(s, route == "single",
                                                           label=f"{s}_{route}"))
                 for s in ("AB", "AA") for route in ("single", "pipeline")]
    mlups = {}
    for label, run in runs:
        sim = run()
        cs.report_main(sim, label)
        mlups[label] = cs.run_figures(sim)[1]
        del sim
    print(json.dumps({"root": str(root), "mlups": mlups}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
