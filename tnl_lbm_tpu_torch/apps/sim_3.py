"""sim_3: 3D flow past a sphere at a given Reynolds number (counterpart of
``tnl_lbm_tpu/apps/sim_3.py``; reference sim_NSE/sim_3.cu).

A rasterized solid sphere in a channel: D3Q27 cumulant (``CUM``) with the
quadratic equilibrium, equilibrium inflow (INFLOW), the interpolated
outflow (OUTFLOW_RIGHT_INTERP, A-B only), walls on the y and z faces, a 2D
cut at mid z.

Usage: python -m tnl_lbm_tpu_torch.apps.sim_3 [RES] [--re RE]
       [--device cuda|cpu] [--no-fused] [--sharded] [--final-time T] [--results-dir DIR]

``--sharded`` shards the lattice over the machine's cards
(``parallel/sharded.py choose_plan``; on the CPU over the one device),
through B4 on haloed blocks.
"""

from __future__ import annotations

import argparse

import numpy as np

from tnl_lbm_tpu_torch.models import D3Q27
from tnl_lbm_tpu_torch.ops import collision as col
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.parallel.sharded import app_devices, choose_plan
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.obstacles import (
    draw_sphere,
    set_boundary_x,
    set_boundary_y,
    set_boundary_z,
)
from tnl_lbm_tpu_torch.sim.state import PRINT, VTK2D, Probe2DCut, Simulation
from tnl_lbm_tpu_torch.utils.units import Lattice


class Sim3(Simulation):
    lbm_inflow_vx: float = 0.0

    def update_inflow(self, phys_time):
        return np.array([self.lbm_inflow_vx, 0.0, 0.0])


def build(resolution: int = 1, re: float = 100.0, final_time: float = 1.0, results_parent=".",
          use_fused: bool = True, sharded: bool = False, *, device, devices=None) -> Sim3:
    """The sphere channel at ``resolution`` (lattice 128r x 32r x 32r) on ``device``;
    ``sharded`` plans it over ``devices`` (by default ``app_devices``)."""
    X = 128 * resolution
    Y = Z = 32 * resolution
    lbm_viscosity = 1e-2
    phys_height = 0.41
    phys_dl = phys_height / (Y - 2)
    phys_velocity = 1.0
    sphere_d = 0.1 * phys_height * 2  # diameter ~ 1/5 of height
    phys_viscosity = phys_velocity * sphere_d / re
    phys_dt = lbm_viscosity / phys_viscosity * phys_dl * phys_dl

    units = Lattice(global_size=(X, Y, Z), phys_origin=(0.0, 0.0, 0.0), phys_dl=phys_dl,
                    phys_dt=phys_dt, phys_viscosity=phys_viscosity)
    dom = Domain(lat=D3Q27, units=units, map=np.zeros((X, Y, Z), np.uint8))
    set_boundary_x(dom, 0, GEO.INFLOW)
    set_boundary_x(dom, X - 1, GEO.OUTFLOW_RIGHT_INTERP)
    set_boundary_y(dom, 0, GEO.WALL)
    set_boundary_y(dom, Y - 1, GEO.WALL)
    set_boundary_z(dom, 0, GEO.WALL)
    set_boundary_z(dom, Z - 1, GEO.WALL)

    center = (0.2 * (X * units.phys_dl), 0.5 * (Y * units.phys_dl), 0.5 * (Z * units.phys_dl))
    draw_sphere(dom, center, sphere_d / 2, GEO.WALL)

    cfg = LBMConfig(lat=D3Q27, collision=col.collide_cum)
    plan = choose_plan(dom, devices or app_devices(device)) if sharded else None
    sim = Sim3(cfg, dom, device=device, sim_id=f"sim_3_res{resolution:02d}_re{int(re)}",
               steps_per_dispatch=10, results_parent=results_parent,
               phys_final_time=final_time, use_fused=use_fused, plan=plan)
    sim.lbm_inflow_vx = units.phys2lbm_velocity(phys_velocity)
    sim.cnt[PRINT].period = final_time / 100
    sim.cnt[VTK2D].period = final_time / 10
    sim.probes_2d.append(Probe2DCut(axis=2, name="cut_Z", position=Z // 2))
    return sim


def main(argv=None) -> Sim3:
    p = argparse.ArgumentParser("sim_3", description="3D flow past a sphere (D3Q27 cumulant)")
    p.add_argument("resolution", type=int, nargs="?", default=1)
    p.add_argument("--re", type=float, default=100.0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no card is present")
    p.add_argument("--sharded", action="store_true",
                   help="shard the lattice over the machine's cards")
    p.add_argument("--final-time", type=float, default=1.0)
    p.add_argument("--results-dir", default=".")
    p.add_argument("--no-fused", action="store_true", help="run the plain PyTorch step")
    args = p.parse_args(argv)
    sim = build(args.resolution, args.re, args.final_time, args.results_dir,
                use_fused=not args.no_fused, sharded=args.sharded, device=args.device)
    sim.run()
    return sim


if __name__ == "__main__":
    main()
