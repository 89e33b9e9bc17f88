"""sim_ibm: 3D channel flow past an immersed-boundary cylinder (counterpart of
``tnl_lbm_tpu/apps/sim_ibm.py``; reference lagrange_3D.hpp + obstacles_ibm.h:69-131).

A Lagrangian point cylinder immersed in a D3Q27 channel (CUM), the
Wu-Shu velocity-correction force solved each step in the forcing hook
(``ibm/lagrange.py``).  With ``use_fused`` a step is the hooked pipeline
(``kernels/hooked.py``): the A-B u* pass (B4 macro_only), the IBM solve as
tensor ops, the A-B force_field step (B4) with the inflow vector; without
it the plain hooked step.  ``--sharded`` plans the lattice over the
machine's cards (``parallel/sharded.py choose_plan``; on the CPU over the
one device) with the IBM's ownership-partitioned hook (``IBM.sharded_hook``):
the same pipeline on the shards' haloed blocks (B4 halo's macro_only and
force_field modes), or the plain sharded hooked step without the kernels.
It writes
- the Lagrangian point cloud as VTK POLYDATA with each 2D cut (reference
  vtk_writer.h + state.hpp:76-113 writeVTKs_points), and
- the integrated body force (drag) to the "ibm" logger each PROBE1 period
  (reference lagrange_3D.hpp:862-890 integrateForce).

Usage: python -m tnl_lbm_tpu_torch.apps.sim_ibm [RES] [--dirac phi2]
       [--method modified|original] [--device cuda|cpu] [--no-fused]
       [--sharded] [--final-time T] [--results-dir DIR]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from tnl_lbm_tpu_torch.ibm import IBM
from tnl_lbm_tpu_torch.ibm.generators import points_cylinder
from tnl_lbm_tpu_torch.io.vtk import write_points_vtk
from tnl_lbm_tpu_torch.models import D3Q27
from tnl_lbm_tpu_torch.ops import collision as col
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.parallel.sharded import app_devices, choose_plan
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.obstacles import set_boundary_x, set_boundary_y, set_boundary_z
from tnl_lbm_tpu_torch.sim.state import PRINT, PROBE1, VTK2D, Probe2DCut, Simulation
from tnl_lbm_tpu_torch.utils.logging_utils import init_logging
from tnl_lbm_tpu_torch.utils.units import Lattice


class SimIBM(Simulation):
    """Channel + IBM cylinder; writes the point cloud with each 2D cut."""

    lbm_inflow_vx: float = 0.0
    ibm: IBM | None = None

    def update_inflow(self, phys_time):
        return np.array([self.lbm_inflow_vx, 0.0, 0.0])

    def probe1(self):
        # drag diagnostic: integrate the spread force over the lattice
        # (reference lagrange_3D.hpp:862-890 integrateForce)
        if self.ibm is not None and self.u is not None:
            force = self.ibm.compute_forces(self.u, self.rho)
            fx, fy, fz = self.ibm.integrate_force(force)
            self.ibm.log.info(
                '{"ibm": "integrateForce", "iteration": %d, "fx": %.6e, "fy": %.6e, "fz": %.6e}',
                self.iterations, fx, fy, fz,
            )

    def _write_vtk_2d(self):
        super()._write_vtk_2d()
        if self.ibm is not None:
            write_points_vtk(
                self.results_dir / "ibm_points" / f"points_{self.cnt[VTK2D].count:05d}.vtk",
                self.ibm.points_phys, time=self.phys_time(),
            )


def build(resolution: int = 1, dirac: str = "phi2", method: str = "modified",
          final_time: float = 0.5, results_parent=".", use_fused: bool = True,
          sharded: bool = False, devices=None, *, device) -> SimIBM:
    """The cylinder channel at ``resolution`` (lattice 96r x 32r x 32r) on
    ``device``; ``sharded`` plans it over ``devices`` (by default
    ``app_devices(device)``) with the IBM's sharded hook (JAX
    ``apps/sim_ibm.py:110-116``)."""
    X = 96 * resolution
    Y = 32 * resolution
    Z = 32 * resolution
    lbm_viscosity = 5e-3
    phys_height = 0.41
    phys_dl = phys_height / (Y - 2)
    phys_velocity = 1.0
    cyl_d = 0.25 * phys_height
    re = 100.0
    phys_viscosity = phys_velocity * cyl_d / re
    phys_dt = lbm_viscosity / phys_viscosity * phys_dl * phys_dl

    units = Lattice(global_size=(X, Y, Z), phys_origin=(0.0, 0.0, 0.0), phys_dl=phys_dl,
                    phys_dt=phys_dt, phys_viscosity=phys_viscosity)
    dom = Domain(lat=D3Q27, units=units, map=np.zeros((X, Y, Z), np.uint8))
    set_boundary_x(dom, 0, GEO.INFLOW)
    set_boundary_x(dom, X - 1, GEO.OUTFLOW_EQ)
    set_boundary_y(dom, 0, GEO.WALL)
    set_boundary_y(dom, Y - 1, GEO.WALL)
    set_boundary_z(dom, 0, GEO.WALL)
    set_boundary_z(dom, Z - 1, GEO.WALL)

    # Lagrangian cylinder spanning the z-extent, centered at 1/4 channel
    cx = 0.25 * X * phys_dl
    cy = 0.5 * Y * phys_dl
    cz = 0.5 * Z * phys_dl
    sigma = 0.7 * phys_dl  # point spacing < dl (reference obstacles_ibm.h:90)
    pts = points_cylinder((cx, cy, cz), cyl_d, (Z - 4) * phys_dl, sigma, axis=2)
    sim_id = f"sim_ibm_res{resolution:02d}_{dirac}_{method}"
    # the run's log_ibm before the solver is built, so that it holds the
    # setup and constructMatrices lines too
    init_logging(Path(results_parent) / f"results_{sim_id}", names=("ibm",))
    ibm = IBM(units, pts, dirac=dirac, method=method, device=device)
    lo, hi = ibm.min_max_spacing()
    ibm.log.info(
        '{"ibm": "setup", "points": %d, "min_spacing": %.4e, "max_spacing": %.4e}',
        ibm.m, lo, hi,
    )

    plan = None
    if sharded:
        # the ownership-partitioned IBM: each shard samples and spreads the
        # stencil nodes its block holds, the partial sums added
        plan = choose_plan(dom, devices or app_devices(device))
        hook = ibm.sharded_hook(plan, dom.shape)
    else:
        hook = ibm.forcing_hook()
    cfg = LBMConfig(lat=D3Q27, collision=col.collide_cum, forcing_hook=hook)
    sim = SimIBM(cfg, dom, device=device, sim_id=sim_id, results_parent=results_parent,
                 phys_final_time=final_time, use_fused=use_fused, plan=plan)
    sim.ibm = ibm
    sim.lbm_inflow_vx = units.phys2lbm_velocity(phys_velocity)
    sim.cnt[PRINT].period = final_time / 50
    sim.cnt[PROBE1].period = final_time / 50
    sim.cnt[VTK2D].period = final_time / 10
    sim.probes_2d.append(Probe2DCut(axis=2, name="cut_Z", position=Z // 2))
    return sim


def main(argv=None) -> SimIBM:
    p = argparse.ArgumentParser("sim_ibm", description="channel flow past an IBM cylinder")
    p.add_argument("resolution", type=int, nargs="?", default=1)
    p.add_argument("--dirac", default="phi2", choices=["phi1", "phi2", "phi3", "phi4"])
    p.add_argument("--method", default="modified", choices=["modified", "original"])
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no card is present")
    p.add_argument("--sharded", action="store_true",
                   help="shard the lattice over the machine's cards (the CPU: its one device)")
    p.add_argument("--final-time", type=float, default=0.5)
    p.add_argument("--results-dir", default=".")
    p.add_argument("--no-fused", action="store_true",
                   help="run the plain hooked step (skip the kernels)")
    args = p.parse_args(argv)
    sim = build(args.resolution, args.dirac, args.method, args.final_time, args.results_dir,
                use_fused=not args.no_fused, sharded=args.sharded, device=args.device)
    sim.run()
    return sim


if __name__ == "__main__":
    main()
