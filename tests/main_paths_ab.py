"""MLUPS of the port's 3D main paths with the package of a given checkout,
so that two commits can be compared on one card in one call.

    python tests/main_paths_ab.py <checkout root> [--only path,path,...]

Runs ``chip_smoke.py``'s loops of this checkout against the package and the
kernels of ``<checkout root>`` (built there): the 256^3 bench duct per step
(A-A, B2/B3) and through the A-B step (B4), 200 steps each; sim_1 at
resolution 8 (B4, 100 steps); sim_coupled at resolution 8 through the
coupled step (B7, 100 steps); sim2d_3's channel at resolution 64
(8192 x 2048, B5 per step, 200 steps); where the checkout's package has the hooked
path (``kernels/hooked.py``), the 256^3 bench duct with the Carreau-Yasuda
hook through its one-kernel route (B10) and its pipeline, A-B and A-A, 100
steps each; where it has the IBM slice (``ibm/``), sim_ibm at resolution 4
(the hooked A-B pipeline with the IBM solve, 200 steps); the pair paths: the 256^3 duct in pairs (B1) with the state in
f32, f16 and bf16, 200 steps each, sim_2 at resolution 2 in pairs, per
step (2000 steps each) and with "auto" dispatch (its choice and its
probe's two times beside), the benchmark entry (``python -m
tnl_lbm_tpu_torch.bench``, pair2) per store dtype, the pair kernel itself
on sim_2's resolution-2 duct and at 256^3 per store dtype (CUDA events over
50 or 20 pairs from a seeded state), and 12 rows of the golden sweep
(sim2d_3 res 1, 1440 steps: wall seconds per row, B5's ms per step
through ``Simulation._advance``, the row's parts).  Prints one JSON line: path -> MLUPS and
peak memory (GB, ``max_memory_allocated`` from the end of sim_init), the
graph replays and graphs kept per path where the checkout has them, B5's
ms per launch at 8192 x 2048 on the res-64 run's final state, the golden
rows, and the pair kernel's ms per store dtype.  ``--only`` runs the named
paths alone ("bench", "golden" and "pair_ms" name the last three parts).  Run it in turns within
one call (parent, change, change, parent) and compare only within that
call.  The duct is built here from the checkout's own ``interop``, so a
checkout without the benchmark entry (``tnl_lbm_tpu_torch/bench.py``)
runs the same loops.  Needs one CUDA card.
"""

import dataclasses
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    # --only a,b,...: just these paths (and "bench", "golden", "pair_ms" by name)
    only = set(sys.argv[sys.argv.index("--only") + 1].split(",")) if "--only" in sys.argv else None
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

    def flagship(shape, storage=None, streaming="AA"):
        """``chip_smoke.flagship``'s duct (walls on the y and z faces,
        periodic in x) from this checkout's ``interop``."""
        from tnl_lbm_tpu_torch import interop
        from tnl_lbm_tpu_torch.ops.boundary import GEO

        m = np.zeros(shape, np.uint8)
        m[:, 0] = m[:, -1] = GEO.WALL
        m[:, :, 0] = m[:, :, -1] = GEO.WALL
        cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, streaming)
        if storage not in (None, "f32"):
            cfg = dataclasses.replace(cfg, storage_dtype=cs.store_dtype(storage))
        dom = interop.domain_from_numpy(m, (True, False, False), phys_viscosity=cs.NU)
        return cfg, dom

    cs.flagship = flagship

    def coupled():
        sim = sim_coupled.build(cs.COUPLED_RES, device=cs.DEVICE, use_fused=True,
                                results_parent=cs.WORK / "coupled")
        sim.phys_final_time = cs.APP_STEPS * sim.domain.units.phys_dt
        if not cs.counting_from_init(sim).run():
            raise RuntimeError("sim_coupled res 8 failed")
        return sim

    runs = [("per_step", lambda: cs.bench_sim(False)),
            ("ab_step", lambda: cs.bench_sim(False, streaming="AB")),
            ("sim_1_res8", cs.sim1_main_path), ("sim_coupled_res8", coupled),
            ("sim2d_3_res64", cs.time_2d_sim)]
    if (root / "tnl_lbm_tpu_torch" / "kernels" / "hooked.py").exists():
        runs += [(f"hooked_{s.lower()}_{route}",
                  lambda s=s, route=route: cs.nn_bench_sim(s, route == "single",
                                                           label=f"{s}_{route}"))
                 for s in ("AB", "AA") for route in ("single", "pipeline")]
    if (root / "tnl_lbm_tpu_torch" / "ibm").exists():
        runs.append(("sim_ibm_res4", lambda: cs.ibm_sim(cs.IBM_RES, "res4", cs.IBM_STEPS)))
    runs += [(f"pair_{store}", lambda store=store: cs.bench_sim(True, storage=store))
             for store in cs.STORES]

    def sim2(pair_dispatch, tag):
        from tnl_lbm_tpu_torch.apps import sim_2

        sim = sim_2.build(2, device=cs.DEVICE, streaming="AA", use_fused=True,
                          pair_dispatch=pair_dispatch, results_parent=cs.WORK / tag)
        sim.phys_final_time = 2000 * sim.domain.units.phys_dt
        if not cs.counting_from_init(sim).run():
            raise RuntimeError(f"sim_2 res 2 ({tag}) failed")
        return sim

    runs += [("sim_2_res2_pairs", lambda: sim2(True, "sim2")),
             ("sim_2_res2_per_step", lambda: sim2(False, "sim2_step")),
             ("sim_2_res2_auto", lambda: sim2("auto", "sim2_auto"))]
    mlups, chose, peak, graphs, kernel_ms = {}, {}, {}, {}, {}
    for label, run in runs:
        if only is not None and label not in only:
            continue
        sim = run()
        _, mlups[label], peak[label] = cs.run_figures(sim)  # before report_main's checks
        cs.report_main(sim, label)
        if hasattr(sim, "graph_replays"):  # a checkout with the chunked dispatch
            graphs[label] = (sim.graph_replays, len(sim._graphs))
        if label.endswith("_auto"):
            chose[label] = ("pair" if sim.pair_dispatch else "per_step", sim.pair_probe_ms)
        if label == "sim2d_3_res64":
            kernel_ms[label] = b5_kernel_ms(cs, sim)
        del sim
    wanted = (lambda name: only is None or name in only)
    if wanted("bench"):
        mlups.update(bench_entry())
    print(json.dumps({"root": str(root), "mlups": mlups, "peak_gb": peak, "graphs": graphs,
                      "auto": chose, "b5_kernel_ms": kernel_ms,
                      "golden": golden_sweep(cs) if wanted("golden") else None,
                      "pair_ms": pair_kernel_ms(cs, flagship) if wanted("pair_ms") else None}))
    return 0


def b5_kernel_ms(cs, sim) -> list:
    """B5 at 8192 x 2048 on the run's final state: ms per launch over three
    windows of 20 launches (CUDA events), the checkout's step kernel."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused_2d import make_fused_step_2d

    step = make_fused_step_2d(sim.cfg, sim.domain, cs.DEVICE)
    f, nu = sim.f.clone(), sim.domain.units.lbm_viscosity()
    u_in, out = sim.update_inflow(sim.phys_time()), torch.empty_like(f)
    times = [cs.time_ms(lambda: step(f, nu, u_in=u_in, out=out), reps=20) for _ in range(3)]
    del f, out
    torch.cuda.empty_cache()
    return times


def golden_sweep(cs) -> dict:
    """The golden sweep's rows as the checkout's sim2d_3 runs them: wall
    seconds per row (build and run, 1440 steps at 128 x 32) over
    GOLDEN_ROWS rows, B5's ms per step from CUDA events over 20 dispatches
    of 20 steps through ``Simulation._advance`` (the checkout's route),
    and the rows' parts with the collector running and frozen
    (``golden_row_split``)."""
    rows = sorted(p.name for p in cs.golden_geometries().glob("*.txt"))[:GOLDEN_ROWS]
    walls = cs.sweep_row_seconds(rows, chunked=True)
    split = cs.golden_row_split(rows, f"main_paths_ab {cs.WORK.parents[1].name}")
    return {"rows": len(walls), "row_s_median": float(np.median(walls)),
            "row_s": walls, "b5_ms_per_launch": cs.b5_launch_ms(chunked=True),
            "split_row_s": {"running": split[False]["row"], "frozen": split[True]["row"]}}


#: golden rows timed per checkout
GOLDEN_ROWS = 12


def bench_entry() -> dict:
    """The checkout's benchmark entry, pair2 per store dtype: its MLUPS."""
    import contextlib
    import io

    from tnl_lbm_tpu_torch import bench

    out = {}
    for store in ("f32", "f16", "bf16"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench.main(["--kernel", "pair2", "--storage", store])
        out[f"bench_pair2_{store}"] = json.loads(buf.getvalue().strip().splitlines()[-1])["value"]
    return out


def pair_kernel_ms(cs, flagship) -> dict:
    """The checkout's pair kernel on sim_2's resolution-2 duct in f32 and at
    256^3 per store dtype, ms per pair."""
    import torch

    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair2_aa, to_storage

    from tnl_lbm_tpu_torch.apps import sim_2

    small = sim_2.build(2, device=cs.DEVICE, streaming="AA", use_fused=True,
                        results_parent=cs.WORK / "sim2_kernel")
    pair = make_fused_pair2_aa(small.cfg, small.domain, cs.DEVICE)
    f = cs.rand_f(small.cfg, small.domain.shape, cs.DEVICE, seed=7)
    res = torch.empty_like(f)
    out = {"sim_2_res2_f32": cs.time_ms(lambda: pair(f, cs.NU, out=res), reps=50)}
    cfg, dom = flagship(cs.BENCH_SHAPE)
    f32 = cs.rand_f(cfg, dom.shape, cs.DEVICE, seed=7)
    for store in cs.STORES:
        pair = make_fused_pair2_aa(cfg, dom, cs.DEVICE, store_dtype=cs.store_dtype(store))
        f = to_storage(f32, cs.store_dtype(store))
        res = torch.empty_like(f)
        out[store] = cs.time_ms(lambda: pair(f, cs.NU, force=(cs.FORCE_BENCH, 0.0, 0.0), out=res),
                                reps=20)
        del f, res
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
