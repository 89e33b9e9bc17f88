"""sim_1: 3D channel flow past a wall with a hole (counterpart of
``tnl_lbm_tpu/apps/sim_1.py``; reference sim_NSE/sim_1.cu:6-200).

D3Q27 cumulant collision (``CUM``) with the inverse-cumulant equilibrium,
constant inflow through the Eichler moment BC (INFLOW_LEFT), OUTFLOW_RIGHT,
solid walls with an extra NOTHING ghost layer, a wall with a rectangular
hole at x ~ 0.2 m, three 2D cuts and a strided 3D box cut.

Usage: python -m tnl_lbm_tpu_torch.apps.sim_1 [RES] [--device cuda|cpu]
       [--streaming AB|AA] [--use-fused | --no-fused] [--pair-dispatch auto|on|off]
       [--final-time T] [--results-dir DIR]

The kernels run by default (``--use-fused`` says so explicitly): A-B
streaming through the A-B kernel (B4), A-A through the even and odd
kernels (B2, B3) one step a launch, or in pairs through the full-set pair
(B1b, one launch a pair) with ``--pair-dispatch on``, or where the
default "auto" times the pair faster on a card (on the CPU "auto" runs
per step).  ``--no-fused`` runs the plain step.  ``--sharded`` shards the
lattice over the machine's cards (``parallel/sharded.py choose_plan``; on
the CPU over the one device), A-B through B4 on haloed blocks, A-A
through B2 and B3 on haloed blocks.
"""

from __future__ import annotations

import argparse

import numpy as np

from tnl_lbm_tpu_torch.models import D3Q27
from tnl_lbm_tpu_torch.ops import collision as col
from tnl_lbm_tpu_torch.ops import equilibrium as eqlib
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.parallel.sharded import app_devices, choose_plan
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.obstacles import set_boundary_x, set_boundary_y, set_boundary_z
from tnl_lbm_tpu_torch.sim.state import (
    PRINT,
    VTK2D,
    VTK3D,
    VTK3DCUT,
    Probe2DCut,
    Probe3DCut,
    Simulation,
)
from tnl_lbm_tpu_torch.utils.units import Lattice


class Sim1(Simulation):
    lbm_inflow_vx: float = 0.0

    def update_inflow(self, phys_time):
        return np.array([self.lbm_inflow_vx, 0.0, 0.0])


def build(resolution: int = 1, final_time: float = 1.0, results_parent=".", streaming="AB",
          use_fused: bool = True, pair_dispatch="auto", sharded: bool = False, *,
          device, devices=None) -> Sim1:
    """The channel at ``resolution`` (lattice 128r x 32r x 32r) on ``device``;
    ``sharded`` plans it over ``devices`` (by default ``app_devices``)."""
    X = 128 * resolution
    Y = 32 * resolution
    Z = Y
    lbm_viscosity = 1e-5
    phys_height = 0.41
    phys_viscosity = 1.5e-5
    phys_velocity = 1.0
    phys_dl = phys_height / (Y - 2)
    phys_dt = lbm_viscosity / phys_viscosity * phys_dl * phys_dl

    units = Lattice(global_size=(X, Y, Z), phys_origin=(0.0, 0.0, 0.0), phys_dl=phys_dl,
                    phys_dt=phys_dt, phys_viscosity=phys_viscosity)
    dom = Domain(lat=D3Q27, units=units, map=np.zeros((X, Y, Z), np.uint8))

    set_boundary_x(dom, 0, GEO.INFLOW_LEFT)
    set_boundary_x(dom, X - 1, GEO.OUTFLOW_RIGHT)
    set_boundary_z(dom, 1, GEO.WALL)
    set_boundary_z(dom, Z - 2, GEO.WALL)
    set_boundary_y(dom, 1, GEO.WALL)
    set_boundary_y(dom, Y - 2, GEO.WALL)
    # extra ghost layer for the A-A pattern (reference sim_1.cu:36-40)
    set_boundary_z(dom, 0, GEO.NOTHING)
    set_boundary_z(dom, Z - 1, GEO.NOTHING)
    set_boundary_y(dom, 0, GEO.NOTHING)
    set_boundary_y(dom, Y - 1, GEO.NOTHING)

    # wall with a hole (reference sim_1.cu:42-52)
    cx = int(np.floor(0.20 / phys_dl))
    width = Z // 10
    yy, zz = np.meshgrid(np.arange(Y), np.arange(Z), indexing="ij")
    hole = (zz >= Z * 4 // 10) & (zz <= Z * 6 // 10) & (yy >= Y * 4 // 10) & (yy <= Y * 6 // 10)
    for px in range(cx, min(cx + width + 1, X)):
        plane = dom.map[px, 1 : Y - 1, 1 : Z - 1]
        plane[~hole[1 : Y - 1, 1 : Z - 1]] = int(GEO.WALL)

    cfg = LBMConfig(lat=D3Q27, collision=col.collide_cum, eq=eqlib.eq_inv_cum,
                    streaming=streaming)
    plan = choose_plan(dom, devices or app_devices(device)) if sharded else None
    sim = Sim1(cfg, dom, device=device, sim_id=f"sim_1_res{resolution:02d}",
               steps_per_dispatch=10, results_parent=results_parent,
               phys_final_time=final_time, use_fused=use_fused, pair_dispatch=pair_dispatch,
               plan=plan)
    sim.lbm_inflow_vx = units.phys2lbm_velocity(phys_velocity)
    sim.cnt[PRINT].period = 0.001
    sim.cnt[VTK2D].period = 0.001
    sim.probes_2d += [
        Probe2DCut(axis=0, name="cut_X", position=X // 2),
        Probe2DCut(axis=1, name="cut_Y", position=Y // 2),
        Probe2DCut(axis=2, name="cut_Z", position=Z // 2),
    ]
    sim.cnt[VTK3D].period = 0.1
    sim.cnt[VTK3DCUT].period = 0.1
    sim.probes_3d.append(Probe3DCut(origin=(X // 4, Y // 4, Z // 4),
                                    length=(X // 2, Y // 2, Z // 2), step=2, name="box"))
    return sim


def main(argv=None) -> Sim1:
    p = argparse.ArgumentParser("sim_1", description="3D channel with wall-with-hole "
                                                    "(D3Q27 cumulant)")
    p.add_argument("resolution", type=int, nargs="?", default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no card is present")
    p.add_argument("--final-time", type=float, default=1.0)
    p.add_argument("--results-dir", default=".")
    p.add_argument("--streaming", choices=["AB", "AA"], default="AB")
    fused = p.add_mutually_exclusive_group()
    fused.add_argument("--use-fused", action="store_true",
                       help="run the CUDA kernels (the default)")
    fused.add_argument("--no-fused", action="store_true", help="run the plain PyTorch step")
    p.add_argument("--sharded", action="store_true",
                   help="shard the lattice over the machine's cards")
    p.add_argument("--pair-dispatch", choices=["auto", "on", "off"], default="auto",
                   help="A-A only: two steps per dispatch via the one-kernel pair")
    args = p.parse_args(argv)
    if args.resolution < 1:
        p.error("resolution must be at least 1")
    sim = build(args.resolution, args.final_time, args.results_dir, args.streaming,
                use_fused=not args.no_fused,
                pair_dispatch={"auto": "auto", "on": True, "off": False}[args.pair_dispatch],
                sharded=args.sharded, device=args.device)
    sim.run()
    return sim


if __name__ == "__main__":
    main()
