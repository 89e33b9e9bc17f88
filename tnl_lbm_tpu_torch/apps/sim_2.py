"""sim_2: square-duct verification (counterpart of ``tnl_lbm_tpu/apps/sim_2.py``).

Laminar flow in a square duct, periodic in x and driven by a body force, or
fed by the analytic profile at an inflow (INFLOW_LEFT at x = 0,
OUTFLOW_RIGHT_INTERP at x = X - 1; ``--velocity``), checked against the
Fourier-series analytic solution with L1/L2 error norms and the dynamic
steady-state stopping criterion (reference sim_NSE/sim_2.cu:63-113,
193-257).  ``--precision double`` computes in float64, the reference's
SP-vs-DP precision test (sim_2.cu:483-487).

Usage: python -m tnl_lbm_tpu_torch.apps.sim_2 RES [--device cuda|cpu]
       [--streaming AB|AA] [--use-fused] [--pair-dispatch auto|on|off]
       [--storage full|f16|bf16] [--precision single|double] [--velocity]
       [--sharded] [--scaling strong|weak_1d|weak_3d]
       [--final-time T] [--results-dir DIR]

``--sharded`` shards the lattice over the machine's cards
(``parallel/sharded.py choose_plan``; on the CPU over the one device): with
``--use-fused`` A-B through B4 on haloed blocks, A-A per step through B2
and B3 on haloed blocks (in single or double precision), or in pairs
through the sharded pair (B1 on persistent haloed blocks): "on" and
``--storage f16|bf16`` take it, "auto" times it against per step on the
card and stays per step on the CPU.
``--scaling`` sizes the lattice by the device count n (1 without
``--sharded``), as the JAX app does: strong keeps it, weak_1d makes x n
times longer, weak_3d scales each axis by the cube root of n.

``--storage f16|bf16`` keeps the state in 16 bits between steps (half
storage, on the one-kernel A-A pair only) and implies ``--streaming AA
--use-fused --pair-dispatch on``.  Two combinations raise where the JAX
driver runs its XLA step (ROADMAP §C): ``--velocity --streaming AA
--use-fused`` (the A-A kernels take no OUTFLOW_RIGHT_INTERP, and no inflow
profile) and ``--storage f16|bf16 --precision double`` (16-bit storage
under float64 compute, ROADMAP Bh64).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tnl_lbm_tpu_torch.models import D3Q27
from tnl_lbm_tpu_torch.ops import collision as col
from tnl_lbm_tpu_torch.ops import equilibrium as eqlib
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.parallel.sharded import app_devices, choose_plan
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.obstacles import set_boundary_x, set_boundary_y, set_boundary_z
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

    def __init__(self, *args, fx_lbm=0.0, u_profile=None, analytical=None, **kw):
        super().__init__(*args, **kw)
        self.fx_lbm = fx_lbm
        self.u_profile = u_profile  # [3, 1, Y, Z] inflow profile or None
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

    def update_inflow(self, phys_time):
        return self.u_profile

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


def build(resolution: int = 2, *, device, use_forcing: bool = True, scaling: str = "strong",
          precision: str = "single", storage: str = "full", final_time: float = 200.0,
          results_parent=".", n_devices: int = 1, sharded: bool = False, devices=None,
          streaming: str = "AB", use_fused: bool = False, pair_dispatch="auto") -> Sim2:
    """The body-force duct at ``resolution`` (lattice 32 x 32r x 32r,
    periodic in x) on ``device``, or with ``use_forcing=False`` the
    velocity-inflow duct (32r x 32r x 32r: the analytic profile [3, 1, Y, Z]
    at INFLOW_LEFT, x = 0, OUTFLOW_RIGHT_INTERP at x = X - 1, no force);
    ``scaling`` sizes it by ``n_devices`` (JAX ``apps/sim_2.py`` build:
    weak_1d x times n, weak_3d every axis times the cube root of n, with
    the periods and the final time of weak_3d scaled alike);
    ``sharded`` plans it over ``devices`` (by default ``app_devices``);
    ``precision`` "double" computes in float64; ``storage`` "f16"/"bf16"
    stores the state in 16 bits (it needs the A-A pair path).  The
    combinations the kernels do not take where the JAX driver runs its XLA
    step raise: the velocity duct under A-A with the kernels, and 16-bit
    storage under float64 compute (ROADMAP §C)."""
    if not use_forcing and streaming == "AA" and use_fused:
        raise NotImplementedError(
            "sim_2 --velocity --streaming AA --use-fused: the A-A kernels take no "
            "OUTFLOW_RIGHT_INTERP (the JAX kernels' supports refuses it under A-A, "
            "tnl_lbm_tpu/kernels/fused.py:49-53) and no inflow profile (ROADMAP Bprof); the "
            "JAX driver runs its XLA step there, the port refuses (ROADMAP §C)")
    if storage != "full" and precision == "double":
        raise NotImplementedError(
            "sim_2 --storage f16|bf16 --precision double: 16-bit storage under float64 "
            "compute has no kernel (ROADMAP Bh64); the JAX driver runs its XLA step there, the "
            "port refuses (ROADMAP §C)")
    block_size = 32
    X = block_size if use_forcing else block_size * resolution
    Y = Z = block_size * resolution
    if scaling == "weak_1d":
        X *= n_devices
    elif scaling == "weak_3d":
        factor = n_devices ** (1.0 / 3.0)
        X, Y, Z = (int(round(v * factor)) for v in (X, Y, Z))

    lbm_viscosity = 0.001
    phys_viscosity = 1.5e-5
    phys_height = 0.25
    phys_dl = phys_height / (Z - 2)
    phys_dt = lbm_viscosity / phys_viscosity * phys_dl * phys_dl
    units = Lattice(global_size=(X, Y, Z), phys_origin=(0, 0, 0),
                    phys_dl=phys_dl, phys_dt=phys_dt, phys_viscosity=phys_viscosity)
    dom = Domain(lat=D3Q27, units=units, map=np.zeros((X, Y, Z), np.uint8),
                 periodic=(use_forcing, False, False))
    set_boundary_z(dom, 1, GEO.WALL)
    set_boundary_z(dom, Z - 2, GEO.WALL)
    set_boundary_y(dom, 1, GEO.WALL)
    set_boundary_y(dom, Y - 2, GEO.WALL)
    set_boundary_z(dom, 0, GEO.NOTHING)
    set_boundary_z(dom, Z - 1, GEO.NOTHING)
    set_boundary_y(dom, 0, GEO.NOTHING)
    set_boundary_y(dom, Y - 1, GEO.NOTHING)
    if not use_forcing:
        set_boundary_x(dom, 0, GEO.INFLOW_LEFT)
        set_boundary_x(dom, X - 1, GEO.OUTFLOW_RIGHT_INTERP)

    fx_lbm = units.phys2lbm_force(1e-4)
    analytical = duct_analytical_ux(Y, Z, fx_lbm, lbm_viscosity)
    u_profile = None
    if not use_forcing:
        # the steady profile of the forced duct enters at x = 0, no force
        u_profile = np.zeros((3, 1, Y, Z), np.float64)
        u_profile[0, 0] = analytical

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
    sim_id = (f"sim_2_CUM_{precision}_{'forcing' if use_forcing else 'velocity'}_{scaling}_res_"
              f"{resolution}_nd_{n_devices}")
    if storage != "full":
        sim_id += f"_store_{storage}"
    sim = Sim2(
        cfg, dom,
        device=device,
        sim_id=sim_id,
        results_parent=results_parent,
        phys_final_time=final_time,
        fx_lbm=fx_lbm if use_forcing else 0.0,
        u_profile=u_profile,
        analytical=analytical,
        steps_per_dispatch=10,
        use_fused=use_fused,
        pair_dispatch=pair_dispatch,
        plan=choose_plan(dom, devices or app_devices(device)) if sharded else None,
    )
    sim.cnt[PRINT].period = 10.0
    sim.cnt[PROBE1].period = 1.0
    if scaling == "weak_3d":
        factor = (Y - 2) / float(block_size * resolution - 2) * resolution / 2
        sim.cnt[PRINT].period /= factor
        sim.cnt[PROBE1].period /= factor
        sim.phys_final_time /= factor
    return sim


def main(argv=None) -> Sim2:
    p = argparse.ArgumentParser("sim_2", description="square-duct verification")
    p.add_argument("resolution", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no card is present")
    p.add_argument("--precision", choices=["single", "double"], default="single")
    p.add_argument("--velocity", action="store_true",
                   help="profile inflow (INFLOW_LEFT, OUTFLOW_RIGHT_INTERP) instead of a body "
                        "force")
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
    p.add_argument("--sharded", action="store_true",
                   help="shard the lattice over the machine's cards")
    p.add_argument("--scaling", choices=["strong", "weak_1d", "weak_3d"], default="strong",
                   help="size the lattice by the device count (weak_1d: x; weak_3d: every axis)")
    args = p.parse_args(argv)
    if args.storage != "full":
        # half storage exists only on the one-kernel A-A pair path
        args.streaming, args.use_fused, args.pair_dispatch = "AA", True, "on"

    devices = app_devices(args.device) if args.sharded else None
    sim = build(
        args.resolution,
        device=args.device,
        use_forcing=not args.velocity,
        scaling=args.scaling,
        n_devices=len(devices) if args.sharded else 1,
        sharded=args.sharded,
        devices=devices,
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
