"""sim_2: square-duct verification (counterpart of ``tnl_lbm_tpu/apps/sim_2.py``).

Laminar flow in a square duct, periodic in x and driven by a body force,
checked against the Fourier-series analytic solution with L1/L2 error
norms and the dynamic steady-state stopping criterion (reference
sim_NSE/sim_2.cu:63-113, 193-257).

Usage: python -m tnl_lbm_tpu_torch.apps.sim_2 RES [--device cuda|cpu]
       [--streaming AB|AA] [--use-fused] [--pair-dispatch auto|on|off]
       [--storage full|f16|bf16] [--precision single|double] [--final-time T]
       [--results-dir DIR]

``--storage f16|bf16`` keeps the state in 16 bits between steps (half
storage, on the one-kernel A-A pair only) and implies ``--streaming AA
--use-fused --pair-dispatch on``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tnl_lbm_tpu_torch.models import D3Q27
from tnl_lbm_tpu_torch.ops import collision as col
from tnl_lbm_tpu_torch.ops import equilibrium as eqlib
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.obstacles import set_boundary_y, set_boundary_z
from tnl_lbm_tpu_torch.sim.state import PRINT, PROBE1, Simulation
from tnl_lbm_tpu_torch.utils.units import Lattice


def duct_analytical_ux(Y: int, Z: int, fx_lbm: float, nu_lbm: float, n_terms: int = 50) -> np.ndarray:
    """Fourier-series solution of laminar flow in a rectangular duct.

    Returns the axial velocity profile [Y, Z] in lattice units for walls at
    y,z = 1 and N-2 (half-way bounce-back planes), in the reference's
    overflow-safe exp formulation (reference sim_2.cu:63-88).
    """
    a = Y / 2.0 - 1.0
    b = Z / 2.0 - 1.0
    y = (np.arange(Y) + 0.5 - Y / 2.0) / a
    z = (np.arange(Z) + 0.5 - Z / 2.0) / a
    yy, zz = np.meshgrid(y, z, indexing="ij")
    b_over_a = b / a
    omega = np.pi / 2.0
    total = np.zeros_like(yy)
    sign = 1.0
    for k in range(n_terms + 1):
        kk = 2.0 * k + 1.0
        ratio = (
            np.exp(omega * kk * (zz - b_over_a))
            * (1.0 + np.exp(-2.0 * omega * kk * zz))
            / (1.0 + np.exp(-2.0 * omega * kk * b_over_a))
        )
        total += sign * (1.0 - ratio) * np.cos(omega * kk * yy) / kk**3
        sign = -sign
    ux = fx_lbm * 16.0 * a * a / np.pi**3 * total / nu_lbm
    ux[0, :] = ux[-1, :] = 0.0
    ux[:, 0] = ux[:, -1] = 0.0
    return ux


def duct_startup_ux(Y: int, Z: int, fx_lbm: float, nu_lbm: float, iterations: float,
                    wall_sites: float = 1.0, n_terms: int = 60) -> np.ndarray:
    """Axial velocity [Y, Z] of the duct flow started from rest, after
    ``iterations`` lattice steps (Fourier series of the start-up problem:
    mode (p, q) of the steady solution grows as 1 - exp(-nu lambda_pq t)).

    The walls sit ``wall_sites`` sites in from each face: 1 is the geometry
    of :func:`duct_analytical_ux` (walls at i = 0.5 and N - 1.5); 2 is the
    effective geometry of the lattice, whose full-way bounce-back walls on
    sites 1 and N - 2 act half-way to the first fluid site (i = 1.5 and
    N - 2.5).
    """
    a = Y / 2.0 - wall_sites
    b = Z / 2.0 - wall_sites
    y = np.arange(Y) + 0.5 - Y / 2.0
    z = np.arange(Z) + 0.5 - Z / 2.0
    p = 2 * np.arange(n_terms) + 1.0
    sign = (-1.0) ** np.arange(n_terms)
    lam = (np.pi / 2) ** 2 * ((p / a)[:, None] ** 2 + (p / b)[None, :] ** 2)
    coef = 16 / np.pi**2 * np.outer(sign / p, sign / p) * fx_lbm / (nu_lbm * lam)
    coef *= -np.expm1(-nu_lbm * lam * iterations)
    ux = np.cos(np.outer(y, p) * np.pi / (2 * a)) @ coef @ np.cos(np.outer(p, z) * np.pi / (2 * b))
    inside = (np.abs(y)[:, None] < a) & (np.abs(z)[None, :] < b)
    return np.where(inside, ux, 0.0)


def duct_errors(ux: np.ndarray, analytical: np.ndarray, units) -> tuple[float, float]:
    """Physical L1/L2 error of an axial velocity field [X, Y, Z] against the
    analytic profile [Y, Z], over the interior sites (reference sim_2.cu:193-257)."""
    diff = np.abs(ux[1:-1, 1:-1, 1:-1] - analytical[None, 1:-1, 1:-1])
    dl3 = units.phys_dl**3
    to_phys = units.lbm2phys_velocity(1.0)
    return to_phys * diff.sum() * dl3, to_phys * np.sqrt((diff**2).sum() * dl3)


class Sim2(Simulation):
    """Duct verification state with error probes + dynamic stopping."""

    def __init__(self, *args, fx_lbm=0.0, analytical=None, **kw):
        super().__init__(*args, **kw)
        self.fx_lbm = fx_lbm
        self.analytical = analytical  # [Y, Z] lattice-unit ux
        self.l1_history = [1.0] * 10
        self._err_idx = 0
        self.last_errors = (np.inf, np.inf)
        #: (iterations, l1, l2) of every probe, to compare runs at one iteration
        self.error_history = []

    def body_force(self, phys_time):
        if self.fx_lbm:
            return np.array([self.fx_lbm, 0.0, 0.0])
        return None

    def probe1(self):
        """L1/L2 error vs analytic + dynamic stopping (reference sim_2.cu:193-257)."""
        l1, l2 = duct_errors(self.u[0].cpu().numpy(), self.analytical, self.domain.units)
        self.last_errors = (l1, l2)
        self.error_history.append((self.iterations, l1, l2))

        prev = np.mean(self.l1_history)
        stddev = np.std(self.l1_history, ddof=1)
        stopping = abs(prev - l1) / l1 if l1 > 0 else 0.0
        if stopping < 1e-4 and stddev < 1e-3:
            self.terminate = True
            self.flags.create("finished")  # converged, not an error
            self.terminate_reason = "converged"
        self._err_idx = (self._err_idx + 1) % len(self.l1_history)
        self.l1_history[self._err_idx] = l1
        self.log.info(
            "at t=%.2fs, iterations=%d l1error_phys=%e l2error_phys=%e stopping=%e",
            self.phys_time(), self.iterations, l1, l2, stopping,
        )


def build(resolution: int = 2, *, device, precision: str = "single", storage: str = "full",
          final_time: float = 200.0, results_parent=".", streaming: str = "AB",
          use_fused: bool = False, pair_dispatch="auto") -> Sim2:
    """The body-force duct at ``resolution`` (lattice 32 x 32r x 32r) on
    ``device``; ``storage`` "f16"/"bf16" stores the state in 16 bits (it
    needs the A-A pair path)."""
    block_size = 32
    X = block_size
    Y = Z = block_size * resolution

    lbm_viscosity = 0.001
    phys_viscosity = 1.5e-5
    phys_height = 0.25
    phys_dl = phys_height / (Z - 2)
    phys_dt = lbm_viscosity / phys_viscosity * phys_dl * phys_dl
    units = Lattice(global_size=(X, Y, Z), phys_origin=(0, 0, 0),
                    phys_dl=phys_dl, phys_dt=phys_dt, phys_viscosity=phys_viscosity)
    dom = Domain(lat=D3Q27, units=units, map=np.zeros((X, Y, Z), np.uint8),
                 periodic=(True, False, False))
    set_boundary_z(dom, 1, GEO.WALL)
    set_boundary_z(dom, Z - 2, GEO.WALL)
    set_boundary_y(dom, 1, GEO.WALL)
    set_boundary_y(dom, Y - 2, GEO.WALL)
    set_boundary_z(dom, 0, GEO.NOTHING)
    set_boundary_z(dom, Z - 1, GEO.NOTHING)
    set_boundary_y(dom, 0, GEO.NOTHING)
    set_boundary_y(dom, Y - 1, GEO.NOTHING)

    fx_lbm = units.phys2lbm_force(1e-4)
    analytical = duct_analytical_ux(Y, Z, fx_lbm, lbm_viscosity)

    # well-conditioned cumulant: deviation DF storage keeps the tiny duct
    # forcing well above float32 round-off
    cfg = LBMConfig(
        lat=D3Q27,
        collision=col.collide_cum_well,
        eq=eqlib.eq_well,
        well=True,
        streaming=streaming,
        compute_dtype=torch.float64 if precision == "double" else torch.float32,
        # half storage quantifies its accuracy cost right here: the error
        # probes compare with the analytic solution either way
        storage_dtype={"full": None, "f16": torch.float16, "bf16": torch.bfloat16}[storage],
    )
    sim_id = f"sim_2_CUM_{precision}_forcing_strong_res_{resolution}_nd_1"
    if storage != "full":
        sim_id += f"_store_{storage}"
    sim = Sim2(
        cfg, dom,
        device=device,
        sim_id=sim_id,
        results_parent=results_parent,
        phys_final_time=final_time,
        fx_lbm=fx_lbm,
        analytical=analytical,
        steps_per_dispatch=10,
        use_fused=use_fused,
        pair_dispatch=pair_dispatch,
    )
    sim.cnt[PRINT].period = 10.0
    sim.cnt[PROBE1].period = 1.0
    return sim


def main(argv=None) -> Sim2:
    p = argparse.ArgumentParser("sim_2", description="square-duct verification")
    p.add_argument("resolution", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no card is present")
    p.add_argument("--precision", choices=["single", "double"], default="single")
    p.add_argument("--final-time", type=float, default=200.0)
    p.add_argument("--results-dir", default=".")
    p.add_argument("--streaming", choices=["AB", "AA"], default="AB")
    p.add_argument("--use-fused", action="store_true",
                   help="run the CUDA kernels: the A-B step, or the A-A kernels per step "
                        "or in pairs")
    p.add_argument("--pair-dispatch", choices=["auto", "on", "off"], default="auto")
    p.add_argument("--storage", choices=["full", "f16", "bf16"], default="full",
                   help="16-bit at-rest DF storage on the A-A pair path (FP16S; implies "
                        "--streaming AA --use-fused --pair-dispatch on)")
    args = p.parse_args(argv)
    if args.storage != "full":
        # half storage exists only on the one-kernel A-A pair path
        args.streaming, args.use_fused, args.pair_dispatch = "AA", True, "on"

    sim = build(
        args.resolution,
        device=args.device,
        precision=args.precision,
        storage=args.storage,
        final_time=args.final_time,
        results_parent=args.results_dir,
        streaming=args.streaming,
        use_fused=args.use_fused,
        pair_dispatch={"auto": "auto", "on": True, "off": False}[args.pair_dispatch],
    )
    ok = sim.run()
    l1, l2 = sim.last_errors
    print(f"final l1error_phys={l1:e} l2error_phys={l2:e} ok={ok}")
    return sim


if __name__ == "__main__":
    main()
