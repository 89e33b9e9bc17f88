"""sim2d_1: 2D channel flow past a wall with a hole, D2Q9 CLBM (counterpart
of ``tnl_lbm_tpu/apps/sim2d_1.py``; reference sim_2D/sim2d_1.cu:1-206).

A constant inflow vector (INFLOW) at x = 0, OUTFLOW_RIGHT at x = X-1, walls
on the y faces, a wall with a hole at x ~ 0.2 m, and a 2D cut at X/2
written as VTK2D.

Usage: python -m tnl_lbm_tpu_torch.apps.sim2d_1 [RES] [--device cuda|cpu]
       [--use-fused] [--sharded] [--final-time T] [--results-dir DIR]

As in the JAX app, the plain step runs unless ``--use-fused`` asks for the
D2Q9 kernel (B5).  ``--sharded`` shards the lattice over the machine's
cards (``parallel/sharded.py choose_plan``; on the CPU over the one
device): B5 on haloed blocks with ``--use-fused``, else the plain sharded
step.
"""

from __future__ import annotations

import argparse

import numpy as np

from tnl_lbm_tpu_torch.models import D2Q9
from tnl_lbm_tpu_torch.ops import collision_2d as col2
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.parallel.sharded import app_devices, choose_plan
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.obstacles import set_boundary_x, set_boundary_y
from tnl_lbm_tpu_torch.sim.state import PRINT, VTK2D, Probe2DCut, Simulation
from tnl_lbm_tpu_torch.utils.units import Lattice


class Sim2D1(Simulation):
    lbm_inflow_vx: float = 0.0

    def update_inflow(self, phys_time):
        return np.array([self.lbm_inflow_vx, 0.0])


def build(resolution: int = 1, final_time: float = 0.5, results_parent=".",
          use_fused: bool = False, sharded: bool = False, *, device, devices=None) -> Sim2D1:
    """The channel at ``resolution`` (lattice 128r x 32r) on ``device``;
    ``sharded`` plans it over ``devices`` (by default ``app_devices``)."""
    X = 128 * resolution
    Y = 32 * resolution
    lbm_viscosity = 1e-5  # reference sim2d_1.cu:123
    phys_height = 0.41
    phys_viscosity = 1.5e-5
    phys_velocity = 1.0
    phys_dl = phys_height / (Y - 2)
    phys_dt = lbm_viscosity / phys_viscosity * phys_dl * phys_dl

    units = Lattice(global_size=(X, Y), phys_origin=(0.0, 0.0), phys_dl=phys_dl, phys_dt=phys_dt,
                    phys_viscosity=phys_viscosity)
    dom = Domain(lat=D2Q9, units=units, map=np.zeros((X, Y), np.uint8))
    set_boundary_x(dom, 0, GEO.INFLOW)
    set_boundary_x(dom, X - 1, GEO.OUTFLOW_RIGHT)
    set_boundary_y(dom, 0, GEO.WALL)
    set_boundary_y(dom, Y - 1, GEO.WALL)

    # wall with a hole
    cx = int(np.floor(0.20 / phys_dl))
    width = max(Y // 10, 1)
    rows = np.arange(1, Y - 1)
    solid = rows[(rows < Y * 4 // 10) | (rows > Y * 6 // 10)]
    dom.map[cx : min(cx + width + 1, X), solid] = int(GEO.WALL)

    cfg = LBMConfig(lat=D2Q9, collision=col2.collide_clbm_2d)
    sim = Sim2D1(cfg, dom, device=device, sim_id=f"sim2d_1_res{resolution:02d}",
                 results_parent=results_parent, phys_final_time=final_time,
                 use_fused=use_fused,
                 plan=choose_plan(dom, devices or app_devices(device)) if sharded else None)
    sim.lbm_inflow_vx = units.phys2lbm_velocity(phys_velocity)
    sim.cnt[PRINT].period = 0.01
    sim.cnt[VTK2D].period = 0.05
    sim.probes_2d.append(Probe2DCut(axis=0, name="cut_X", position=X // 2))
    return sim


def main(argv=None) -> Sim2D1:
    p = argparse.ArgumentParser("sim2d_1", description="2D channel with wall-with-hole "
                                                      "(D2Q9 CLBM)")
    p.add_argument("resolution", type=int, nargs="?", default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no card is present")
    p.add_argument("--final-time", type=float, default=0.5)
    p.add_argument("--results-dir", default=".")
    p.add_argument("--use-fused", action="store_true", help="run the D2Q9 kernel (B5)")
    p.add_argument("--sharded", action="store_true",
                   help="shard the lattice over the cards (on the CPU: over the one device)")
    args = p.parse_args(argv)
    sim = build(args.resolution, args.final_time, args.results_dir, use_fused=args.use_fused,
                sharded=args.sharded, device=args.device)
    sim.run()
    return sim


if __name__ == "__main__":
    main()
