"""IBM performance tables: dirac kernels x methods x point counts.

Counterpart of ``scripts/make_ibm_performance_tables.py`` (reference
makeIBMPerformanceTables.py:15-95) for the port: a sphere of ``--points``
Lagrangian points (radius n/5, at the centre of a periodic n^3 D3Q27 CUM
lattice, flow 0.05 along x, CG capped at 50 iterations), per row the IBM
build's seconds, the ms per step and the CG iterations per step.  The JAX
script times the plain step; this one times the kernel route
(``make_hooked_fused_step``: the u* pass, the IBM solve, the force_field
step), the path a run takes on the card.  A step's time is the host clock
around ``--steps`` steps that end in a device synchronize, after one warm
step.

Usage: python -m tnl_lbm_tpu_torch.ibm_tables [--n 96] [--points 4096,32768]
       [--steps 10] [--diracs phi1,phi2] [--methods modified,original]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from tnl_lbm_tpu_torch.ibm import IBM
from tnl_lbm_tpu_torch.ibm.generators import points_sphere
from tnl_lbm_tpu_torch.kernels.hooked import make_hooked_fused_step
from tnl_lbm_tpu_torch.models import D3Q27
from tnl_lbm_tpu_torch.ops import collision as col
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig, initial_dfs
from tnl_lbm_tpu_torch.sim.state import resolve_device, synchronize
from tnl_lbm_tpu_torch.utils.units import Lattice

NU = 0.05
MAX_ITERS = 50


def run_case(dirac: str, method: str, n: int, points: int, steps: int, device) -> dict:
    """One row: {"dirac", "method", "points", "space", "unique_nodes",
    "build_s", "step_ms", "cg_iters"} (``cg_iters``: the mean over the timed steps)."""
    dev = resolve_device(device)
    units = Lattice(global_size=(n, n, n), phys_origin=(0, 0, 0), phys_dl=1.0, phys_dt=1.0,
                    phys_viscosity=NU)
    dom = Domain(lat=D3Q27, units=units, map=np.zeros((n, n, n), np.uint8),
                 periodic=(True,) * 3)
    radius = n / 5
    sigma = np.sqrt(4 * np.pi * radius**2 / points)
    pts = points_sphere((n / 2, n / 2, n / 2), radius, sigma)

    synchronize(dev)
    t0 = time.perf_counter()
    ibm = IBM(units, pts, dirac=dirac, method=method, max_iters=MAX_ITERS, device=dev)
    synchronize(dev)
    t_build = time.perf_counter() - t0

    hook = ibm.forcing_hook()
    cfg = LBMConfig(lat=D3Q27, collision=col.collide_cum, forcing_hook=hook)
    step = make_hooked_fused_step(cfg, dom, dev)
    f = initial_dfs(cfg, dom, dev, u0=(0.05, 0.0, 0.0))
    spare = torch.empty_like(f)
    f, spare = step(f, NU, out=spare, hook_consts=hook.consts)[0], f
    synchronize(dev)
    iters = []
    t0 = time.perf_counter()
    for _ in range(steps):
        f, spare = step(f, NU, out=spare, hook_consts=hook.consts)[0], f
        iters.append(ibm.last_cg_iters)
    synchronize(dev)
    t_step = (time.perf_counter() - t0) / steps
    if not bool(torch.isfinite(f).all()):
        raise RuntimeError(f"non-finite state: dirac={dirac} method={method} m={ibm.m}")
    return {"dirac": dirac, "method": method, "points": ibm.m, "space": ibm.space,
            "unique_nodes": ibm.u, "build_s": t_build, "step_ms": t_step * 1e3,
            "cg_iters": float(np.mean(iters))}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description="IBM performance tables (the port)")
    p.add_argument("--n", type=int, default=96)
    p.add_argument("--points", default="4096", help="comma-separated point counts")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--diracs", default="phi1,phi2,phi3,phi4")
    p.add_argument("--methods", default="modified,original")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no card is present")
    args = p.parse_args(argv)

    rows = []
    for points in (int(x) for x in args.points.split(",")):
        for dirac in args.diracs.split(","):
            for method in args.methods.split(","):
                row = run_case(dirac, method, args.n, points, args.steps, args.device)
                rows.append(row)
                print(f"ran dirac={dirac} method={method} m={row['points']}", file=sys.stderr)

    header = (f"{'dirac':8s} {'method':10s} {'points':>7s} {'space':>6s} {'nodes':>7s} "
              f"{'build[s]':>10s} {'step[ms]':>10s} {'cg/step':>8s}")
    print(header)
    print("-" * len(header))
    for r in rows:
        print(f"{r['dirac']:8s} {r['method']:10s} {r['points']:7d} {r['space']:>6s} "
              f"{r['unique_nodes']:7d} {r['build_s']:10.4f} {r['step_ms']:10.2f} "
              f"{r['cg_iters']:8.1f}")
    return rows


if __name__ == "__main__":
    main()
