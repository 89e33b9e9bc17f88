"""sim_coupled: scalar plume transport in a 3D channel, NSE + ADE
(counterpart of ``tnl_lbm_tpu/apps/sim_coupled.py``; reference
state_NSE_ADE.h:3-468 with kernels.h:102-176).

D3Q27 cumulant flow (``CUM``) advects a D3Q7 scalar (``CLBM``) released at
the inflow; the walls impose the anti-bounce-back body-concentration
condition and the outflow uses Peclet extrapolation.  Lattice
64r x 32r x 32r, periodic in z.

Usage: python -m tnl_lbm_tpu_torch.apps.sim_coupled [RES] [--device cuda|cpu]
       [--use-fused] [--streaming AB|AA] [--sharded] [--final-time T]
       [--results-dir DIR]

With ``--use-fused`` both lattices advance in one launch per step: of the
coupled kernel (B7) with A-B streaming, of the A-A coupled pair's kernel of
the step's parity (B8) with ``--streaming AA``.  ``--sharded`` shards both
lattices over the machine's cards (``parallel/sharded.py choose_plan`` on
the NSE lattice; on the CPU over the one device): with ``--use-fused`` B4
then B6 on haloed blocks each step ("sharded-fused"; ``--streaming AA``
raises there, ROADMAP §C), else the plain sharded steps ("sharded").
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tnl_lbm_tpu_torch.models import D3Q7, D3Q27
from tnl_lbm_tpu_torch.ops import collision as col
from tnl_lbm_tpu_torch.ops import collision_ade as cade
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.parallel.sharded import app_devices, choose_plan
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.coupled import CoupledSimulation
from tnl_lbm_tpu_torch.sim.state import PRINT, VTK2D, Probe2DCut
from tnl_lbm_tpu_torch.sim.step_ade import ADEGEO
from tnl_lbm_tpu_torch.utils.units import Lattice


class SimCoupled(CoupledSimulation):
    lbm_inflow_vx: float = 0.0

    def update_inflow(self, phys_time):
        return np.array([self.lbm_inflow_vx, 0.0, 0.0])

    def initial_phi(self):
        return torch.zeros(self.ade_domain.shape, dtype=self.ade_cfg.compute_dtype,
                           device=self.device)


def build(resolution: int = 1, final_time: float = 1.0, results_parent=".",
          use_fused: bool = False, streaming: str = "AB", sharded: bool = False, *,
          device, devices=None) -> SimCoupled:
    """The plume channel at ``resolution`` on ``device``; ``sharded`` plans
    both lattices over ``devices`` (by default ``app_devices``), as the JAX
    app does, by the NSE lattice."""
    X = 64 * resolution
    Y = 32 * resolution
    Z = 32 * resolution
    lbm_viscosity = 5e-3
    phys_height = 0.1
    phys_dl = phys_height / (Y - 2)
    phys_velocity = 0.5
    phys_viscosity = 1e-4
    phys_dt = lbm_viscosity / phys_viscosity * phys_dl * phys_dl

    units = Lattice(global_size=(X, Y, Z), phys_origin=(0.0, 0.0, 0.0), phys_dl=phys_dl,
                    phys_dt=phys_dt, phys_viscosity=phys_viscosity)

    m = np.zeros((X, Y, Z), np.uint8)
    m[:, 0] = m[:, -1] = GEO.WALL
    m[0, 1:-1] = GEO.INFLOW
    m[-1, 1:-1] = GEO.OUTFLOW_EQ
    nse_dom = Domain(lat=D3Q27, units=units, map=m, periodic=(False, False, True))

    ma = np.zeros((X, Y, Z), np.uint8)
    ma[:, 0] = ma[:, -1] = ADEGEO.WALL_BODY
    ma[0] = ADEGEO.INFLOW
    ma[-1] = ADEGEO.OUTFLOW_PE
    ade_dom = Domain(lat=D3Q7, units=units, map=ma, periodic=(False, False, True))

    # A-A + OUTFLOW_PE is A-B only; with A-A the outflow switches to the
    # pull-shift variant, as in the JAX app
    if streaming == "AA":
        ma[ma == int(ADEGEO.OUTFLOW_PE)] = int(ADEGEO.OUTFLOW_RIGHT)
    cfg = LBMConfig(lat=D3Q27, collision=col.collide_cum, streaming=streaming)
    ade_cfg = LBMConfig(lat=D3Q7, collision=cade.collide_clbm_ade, streaming=streaming)

    sim = SimCoupled(cfg, nse_dom, ade_cfg, ade_dom, ade_diffusion=5e-3, phi_inflow=1.0,
                     device=device, sim_id=f"sim_coupled_res{resolution:02d}",
                     results_parent=results_parent, phys_final_time=final_time,
                     use_fused=use_fused,
                     plan=choose_plan(nse_dom, devices or app_devices(device)) if sharded else None)
    sim.lbm_inflow_vx = units.phys2lbm_velocity(phys_velocity)
    sim.cnt[PRINT].period = final_time / 50
    sim.cnt[VTK2D].period = final_time / 10
    sim.probes_2d.append(Probe2DCut(axis=2, name="cut_Z", position=Z // 2))
    return sim


def main(argv=None) -> SimCoupled:
    p = argparse.ArgumentParser("sim_coupled", description="NSE+ADE scalar plume channel")
    p.add_argument("resolution", type=int, nargs="?", default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no card is present")
    p.add_argument("--final-time", type=float, default=1.0)
    p.add_argument("--results-dir", default=".")
    p.add_argument("--use-fused", action="store_true",
                   help="run the CUDA kernels (the coupled kernel of the streaming pattern)")
    p.add_argument("--streaming", choices=["AB", "AA"], default="AB")
    p.add_argument("--sharded", action="store_true",
                   help="shard both lattices over the cards (on the CPU: over the one device)")
    args = p.parse_args(argv)
    if args.resolution < 1:
        p.error("resolution must be at least 1")
    sim = build(args.resolution, args.final_time, args.results_dir, args.use_fused,
                streaming=args.streaming, sharded=args.sharded, device=args.device)
    sim.run()
    return sim


if __name__ == "__main__":
    main()
