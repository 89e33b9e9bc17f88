"""sim2d_3: the 2D geometry channel -> one kinetic-energy value (counterpart
of ``tnl_lbm_tpu/apps/sim2d_3.py``; reference sim_2D/sim2d_3.cu).

Loads a geometry file (per-cell type and Bouzidi thetas, ``io/geometry.py``),
runs a D2Q9 CLBM channel with a parabolic inflow, and writes the kinetic
energy integrated over the ROI x in [X/2, 3X/4), interior y, to
``values/value_<geom>``: the one-number regression output of the golden
geometry sweep (reference sim2d_3.cu:221-260).

Usage: python -m tnl_lbm_tpu_torch.apps.sim2d_3 [RES] [OBJECT_FILE]
       [--device cuda|cpu] [--no-bouzidi] [--sharded] [--final-time T]
       [--results-dir DIR] [--values-dir DIR]

Every step runs through the D2Q9 kernel (B5), as in the JAX app;
``--sharded`` shards the lattice over the machine's cards
(``parallel/sharded.py choose_plan``; on the CPU over the one device): B5
on haloed blocks, padded and cropped where the plan does not divide the
lattice.  The KE value reads the gathered velocity.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from tnl_lbm_tpu_torch.io.geometry import load_geometry_file
from tnl_lbm_tpu_torch.models import D2Q9
from tnl_lbm_tpu_torch.ops import collision_2d as col2
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.parallel.sharded import app_devices, choose_plan
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.obstacles import set_boundary_x, set_boundary_y
from tnl_lbm_tpu_torch.sim.state import Simulation, to_host
from tnl_lbm_tpu_torch.utils.fileutils import mkdir_p
from tnl_lbm_tpu_torch.utils.units import Lattice


class ParabolicInflow:
    """The parabolic inflow profile between the walls at y = 1 and y = Y-2,
    peaking at ``u_max_lbm`` (reference sim2d_3.cu:36-56): [2, 1, Y] on the
    run's device, made once per ``u_max_lbm`` since it does not change in
    time, so no step copies it from the host."""

    u_max_lbm: float = 0.0
    _inflow = None

    def update_inflow(self, phys_time):
        if self._inflow is None or self._inflow[0] != self.u_max_lbm:
            Y = self.domain.shape[1]
            y0, y1 = 1, Y - 2
            s = np.clip((np.arange(Y) - y0) / max(y1 - y0, 1), 0.0, 1.0)
            prof = np.zeros((2, 1, Y))
            prof[0, 0] = self.u_max_lbm * 4.0 * s * (1.0 - s)
            self._inflow = (self.u_max_lbm, torch.as_tensor(prof, dtype=self.cfg.compute_dtype,
                                                            device=self.device))
        return self._inflow[1]


class Sim2D3(ParabolicInflow, Simulation):
    value_path: Path | None = None
    ke_value: float | None = None

    def integrate_ke_roi(self) -> float:
        """0.5 (u^2 + v^2) over x in [X/2, 3X/4), interior y, fluid sites
        only, in physical units (reference sim2d_3.cu:221-247); on the host,
        as the JAX app sums it."""
        units = self.domain.units
        X, Y = self.domain.shape
        x0, x1 = max(1, X // 2), min(X - 1, int(np.ceil(0.75 * X)))
        u = to_host(self.u) * units.lbm2phys_velocity(1.0)
        fluid = np.isin(self.domain.map, [int(GEO.FLUID), int(GEO.FLUID_NEAR_WALL)])
        roi = np.zeros_like(fluid)
        roi[x0:x1, 1 : Y - 1] = True
        ke = 0.5 * (u[0] ** 2 + u[1] ** 2)
        return float((ke * (fluid & roi)).sum() * units.phys_dl**2)

    def after_sim_finished(self):
        value = self.integrate_ke_roi()
        if self.value_path is not None:
            mkdir_p(self.value_path.parent)
            self.value_path.write_text(f"{value:.17g}\n")
            self.log.info("KE value %.17g -> %s", value, self.value_path)
        self.ke_value = value
        super().after_sim_finished()


def channel_units(resolution: int) -> Lattice:
    """The 2D channel's lattice (128r x 32r) and units, shared by sim2d_2 and
    sim2d_3: height 0.5 m between the walls, lattice viscosity 1e-3."""
    X, Y = 128 * resolution, 32 * resolution
    lbm_viscosity = 1.0e-3
    phys_viscosity = 1.0e-3
    phys_dl = 0.50 / (Y - 2)
    phys_dt = lbm_viscosity / phys_viscosity * phys_dl * phys_dl
    return Lattice(global_size=(X, Y), phys_origin=(0, 0), phys_dl=phys_dl, phys_dt=phys_dt,
                   phys_viscosity=phys_viscosity)


def channel_domain(units: Lattice, object_file, enable_bouzidi: bool) -> Domain:
    """The geometry file's map and thetas (none: an empty channel; without
    Bouzidi the near-wall cells are fluid and carry no thetas), with INFLOW
    at x = 0, OUTFLOW_RIGHT at x = X-1, walls at y = 1 and Y-2 and NOTHING
    rows outside them."""
    X, Y = units.global_size
    if object_file:
        m, bz = load_geometry_file(object_file, X, Y, use_bouzidi_for_type1=enable_bouzidi)
        if not enable_bouzidi:
            bz = None
    else:
        m, bz = np.zeros((X, Y), np.uint8), None
    dom = Domain(lat=D2Q9, units=units, map=m, bouzidi=bz)
    set_boundary_x(dom, 0, GEO.INFLOW)
    set_boundary_x(dom, X - 1, GEO.OUTFLOW_RIGHT)
    set_boundary_y(dom, 1, GEO.WALL)
    set_boundary_y(dom, Y - 2, GEO.WALL)
    set_boundary_y(dom, 0, GEO.NOTHING)
    set_boundary_y(dom, Y - 1, GEO.NOTHING)
    return dom


def build(resolution: int = 1, object_file: str | None = None, enable_bouzidi: bool = True,
          final_time: float = 4.0, results_parent=".", values_dir="values",
          use_fused: bool = True, sharded: bool = False, *, device, devices=None) -> Sim2D3:
    """The geometry channel at ``resolution`` (lattice 128r x 32r) on
    ``device``; ``sharded`` plans it over ``devices`` (by default
    ``app_devices``)."""
    units = channel_units(resolution)
    dom = channel_domain(units, object_file, enable_bouzidi)
    cfg = LBMConfig(lat=D2Q9, collision=col2.collide_clbm_2d)
    obj_name = Path(object_file).name if object_file else "none"
    sim = Sim2D3(cfg, dom, device=device,
                 sim_id=f"sim2d_3_res{resolution:02d}_{Path(obj_name).stem}",
                 results_parent=results_parent, phys_final_time=final_time,
                 steps_per_dispatch=20, use_fused=use_fused,
                 plan=choose_plan(dom, devices or app_devices(device)) if sharded else None)
    sim.u_max_lbm = units.phys2lbm_velocity(1.5)
    sim.value_path = Path(values_dir) / f"value_{obj_name}"
    return sim


def main(argv=None) -> Sim2D3:
    p = argparse.ArgumentParser("sim2d_3", description="2D geometry channel -> KE value")
    p.add_argument("resolution", type=int, nargs="?", default=1)
    p.add_argument("object_file", nargs="?", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no card is present")
    p.add_argument("--no-bouzidi", action="store_true")
    p.add_argument("--sharded", action="store_true",
                   help="shard the lattice over the cards (on the CPU: over the one device)")
    p.add_argument("--final-time", type=float, default=4.0)
    p.add_argument("--results-dir", default=".")
    p.add_argument("--values-dir", default="values")
    args = p.parse_args(argv)
    sim = build(args.resolution, args.object_file, not args.no_bouzidi, args.final_time,
                args.results_dir, args.values_dir, sharded=args.sharded, device=args.device)
    sim.run()
    return sim


if __name__ == "__main__":
    main()
