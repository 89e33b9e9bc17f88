"""sim2d_2: the 2D geometry channel with turbulence statistics (counterpart
of ``tnl_lbm_tpu/apps/sim2d_2.py``; reference sim_2D/sim2d_2.cu).

sim2d_3's channel and geometry file with the reference app's two-phase
statistics state machine (sim2d_2.cu:155-199, 396-437):

1. running-mean accumulation starts at ``stats_start_time``;
2. the ROI's average mean speed is checked on a cadence; when it is stable
   for ``mean_stable_required`` consecutive checks (absolute or relative
   tolerance), or at the ``stats_end_time`` deadline, the mean freezes and
   is snapshotted (sim2d_2.cu:412-422, 468-510);
3. after a guard time, fluctuations around the frozen mean accumulate
   (u'^2, v'^2 and |u'|, sim2d_2.cu:88-118);
4. when the ROI's RMS fluctuation speed stabilizes, the ROI's TKE integral
   is exported once and the run terminates (sim2d_2.cu:432-435).

The accumulators are tensors on the run's device, updated in place after
every step.  The VTK field set is the reference's (sim2d_2.cu:334-391):
lbm_density, velocity, velocity_magnitude, mean_vx, mean_vy, mean_vel_mag,
mean_fluc_mag and the 8 raw Bouzidi theta planes; CSV rows are written on
the statistics events and on the PROBE1 cadence (sim2d_2.cu:667-701).

Usage: python -m tnl_lbm_tpu_torch.apps.sim2d_2 [RES] [OBJECT_FILE]
       [--device cuda|cpu] [--no-bouzidi] [--final-time T] [--stat-start T]
       [--stat-end T] [--results-dir DIR] [--value-file PATH]

Every step runs through the D2Q9 kernel (B5), as in the JAX app.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np
import torch

from tnl_lbm_tpu_torch.apps.sim2d_3 import ParabolicInflow, channel_domain, channel_units
from tnl_lbm_tpu_torch.models import D2Q9
from tnl_lbm_tpu_torch.ops import collision_2d as col2
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.parallel.sharded import app_devices, choose_plan
from tnl_lbm_tpu_torch.sim.config import LBMConfig
from tnl_lbm_tpu_torch.sim.state import PRINT, PROBE1, Simulation, to_host

#: the Bouzidi theta planes' names in the output, in the thetas' order
THETA_NAMES = ("east", "north", "west", "south", "ne", "nw", "sw", "se")


class Sim2D2(ParabolicInflow, Simulation):
    # statistics window (reference sim2d_2.cu:162-163)
    stats_start_time: float = 1.5
    stats_end_time: float = 5.5

    # mean stabilization (reference sim2d_2.cu:166-171)
    mean_tol: float = 1.0e-3          # abs [m/s]
    mean_check_period: float = 0.05   # [s]
    mean_stable_required: int = 10
    mean_rel_tol: float = 1.0e-3
    mean_min_time: float = 1.0        # guard before checking [s]

    # fluctuation stabilization (reference sim2d_2.cu:184-186)
    fluc_tol: float = 1.0e-3
    fluc_check_period: float = 0.05
    fluc_stable_required: int = 10
    fluc_rel_tol: float = 1.0e-3
    fluc_min_time: float = 1.0        # after the mean freeze [s]

    # ROI (reference sim2d_2.cu:193-196)
    roi_x0_fraction: float = 0.5
    roi_x1_fraction: float = 0.75
    roi_y_offset_cells: int = 3

    value_path: str | None = None  # TKE value file (the run terminates when written)

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.mean_samples = 0
        self.means_frozen = False
        self.mean_freeze_time = -1.0
        self._mean_stable_count = 0
        self._next_mean_check = None
        self._prev_mean_speed = -1.0

        self.fluc_samples = 0
        self.flucs_frozen = False
        self._fluc_stable_count = 0
        self._next_fluc_check = None
        self._prev_fluc_rms = -1.0
        self.tke_value_written = False

        self.sum_v = None          # running sum of the velocity [2, X, Y]
        self.frozen_mean = None    # frozen <u> in lattice units [2, X, Y]
        self.sum_up2 = None        # sums of the u'^2 components [2, X, Y]
        self.sum_upmag = None      # sum of |u'| [X, Y]
        self.csv_rows = []

    # --------------------------------------------------------- accumulators
    def compute_after_step(self):
        t = self.phys_time()
        # phase 1: mean accumulation within the window (sim2d_2.cu:396-398)
        if not self.means_frozen and self.stats_start_time <= t < self.stats_end_time:
            if self.sum_v is None:
                self.sum_v = torch.zeros_like(self.u)
            self.sum_v.add_(self.u)
            self.mean_samples += 1

        # mean stabilization and freeze (sim2d_2.cu:411-422)
        if not self.means_frozen:
            self._check_mean_freeze(t)
            if not self.means_frozen and t >= self.stats_end_time:
                self._freeze_means(self.stats_end_time)

        # phase 2: fluctuations around the frozen mean (sim2d_2.cu:424-435)
        if self.means_frozen and not self.flucs_frozen:
            if t >= self.mean_freeze_time + self.fluc_min_time:
                up = self.u - self.frozen_mean
                self.sum_up2.add_(up * up)
                self.sum_upmag.add_(torch.sqrt(up[0] ** 2 + up[1] ** 2))
                self.fluc_samples += 1
            self._check_fluc_freeze(t)
            if self.flucs_frozen and not self.tke_value_written:
                self._export_tke_and_terminate()

    # ------------------------------------------------------ ROI + metrics
    def roi_indices(self):
        """The ROI fractions as a clamped lattice index box (sim2d_2.cu roiIndices)."""
        X, Y = self.domain.shape
        x0 = max(1, int(np.floor(self.roi_x0_fraction * X)))
        x1 = min(X - 1, int(np.ceil(self.roi_x1_fraction * X)))
        y0 = max(1, self.roi_y_offset_cells)
        y1 = min(Y - 1, Y - self.roi_y_offset_cells)
        if x0 >= x1:
            x0, x1 = 1, X - 1
        if y0 >= y1:
            y0, y1 = 1 + self.roi_y_offset_cells, Y - 1 - self.roi_y_offset_cells
        return x0, x1, y0, y1

    def roi_mask(self):
        fluid = np.isin(self.domain.map, [int(GEO.FLUID), int(GEO.FLUID_NEAR_WALL)])
        roi = np.zeros_like(fluid)
        x0, x1, y0, y1 = self.roi_indices()
        roi[x0:x1, y0:y1] = True
        return fluid & roi

    def _roi_average(self, field) -> float:
        """The average of a [X, Y] host field over the ROI's fluid sites."""
        sel = self.roi_mask()
        n = sel.sum()
        return float((field * sel).sum() / n) if n else 0.0

    def _roi_avg_mean_speed(self) -> float:
        """Average |<u>| over the ROI in m/s (sim2d_2.cu computeROIAvgMeanSpeed)."""
        if self.mean_samples == 0:
            return 0.0
        mean = to_host(self.sum_v) / self.mean_samples
        return self._roi_average(np.sqrt(mean[0] ** 2 + mean[1] ** 2)
                                 * self.domain.units.lbm2phys_velocity(1.0))

    def _roi_rms_fluc_speed(self) -> float:
        """RMS sqrt(<u'^2 + v'^2>) over the ROI in m/s (computeROIRMSFlucSpeed)."""
        if self.fluc_samples == 0:
            return 0.0
        up2 = to_host(self.sum_up2) / self.fluc_samples
        return self._roi_average(np.sqrt(up2[0] + up2[1])
                                 * self.domain.units.lbm2phys_velocity(1.0))

    # -------------------------------------------------- freeze state machine
    @staticmethod
    def _stable(cur: float, prev: float, tol: float, rel_tol: float) -> bool:
        delta = abs(cur - prev)
        rel = delta / abs(prev) if prev else np.inf
        return delta <= tol or rel <= rel_tol

    def _check_mean_freeze(self, t: float):
        if self._next_mean_check is None:
            self._next_mean_check = self.stats_start_time + self.mean_check_period
        if t < max(self._next_mean_check, self.stats_start_time + self.mean_min_time):
            return
        self._next_mean_check = t + self.mean_check_period
        cur = self._roi_avg_mean_speed()
        prev, self._prev_mean_speed = self._prev_mean_speed, cur
        if prev < 0:
            return
        stable = self._stable(cur, prev, self.mean_tol, self.mean_rel_tol)
        self._mean_stable_count = self._mean_stable_count + 1 if stable else 0
        if self._mean_stable_count >= self.mean_stable_required:
            self._freeze_means(t)

    def _freeze_means(self, t: float):
        """Snapshot the frozen mean and arm the fluctuation accumulation
        (sim2d_2.cu snapshotFrozenMeansToMacro, :468-510)."""
        self.means_frozen = True
        self.mean_freeze_time = t
        self.frozen_mean = (self.sum_v / self.mean_samples if self.mean_samples > 0
                            else torch.zeros_like(self.u))
        self.sum_up2 = torch.zeros_like(self.u)
        self.sum_upmag = torch.zeros_like(self.u[0])
        self.fluc_samples = 0
        self._next_fluc_check = t + self.fluc_check_period
        self._prev_fluc_rms = -1.0
        self.log.info("means frozen at t=%.4f (n=%d samples)", t, self.mean_samples)
        self.write_stats_snapshot("mean_frozen")

    def _check_fluc_freeze(self, t: float):
        if self._next_fluc_check is None or t < self._next_fluc_check:
            return
        if t < self.mean_freeze_time + self.fluc_min_time:
            return
        self._next_fluc_check = t + self.fluc_check_period
        cur = self._roi_rms_fluc_speed()
        prev, self._prev_fluc_rms = self._prev_fluc_rms, cur
        if prev < 0:
            return
        stable = self._stable(cur, prev, self.fluc_tol, self.fluc_rel_tol)
        self._fluc_stable_count = self._fluc_stable_count + 1 if stable else 0
        if self._fluc_stable_count >= self.fluc_stable_required:
            self.flucs_frozen = True
            self.log.info("fluctuations frozen at t=%.4f (n=%d samples)", t, self.fluc_samples)

    def _export_tke_and_terminate(self):
        """Write the ROI's TKE integral once and terminate
        (sim2d_2.cu exportROI_TKE_andTerminate)."""
        tke = self.integrate_tke_roi()
        if self.value_path:
            p = Path(self.value_path)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(f"{tke:e}\n")
        self.tke_value_written = True
        self.write_stats_snapshot("tke_exported")
        self.log.info("ROI TKE exported: %e - terminating", tke)
        self.terminate = True

    # ------------------------------------------------------------- integrals
    def integrate_tke_roi(self) -> float:
        """0.5 <u'^2 + v'^2> integrated over the ROI (the frozen-mean
        fluctuations when there are any, else zero)."""
        if self.sum_up2 is None or self.fluc_samples == 0:
            return 0.0
        units = self.domain.units
        up2 = to_host(self.sum_up2) / self.fluc_samples
        tke = 0.5 * (up2[0] + up2[1]) * units.lbm2phys_velocity(1.0) ** 2
        return float((tke * self.roi_mask()).sum() * units.phys_dl**2)

    def integrate_ke_roi(self) -> float:
        units = self.domain.units
        u = to_host(self.u) * units.lbm2phys_velocity(1.0)
        ke = 0.5 * (u[0] ** 2 + u[1] ** 2)
        return float((ke * self.roi_mask()).sum() * units.phys_dl**2)

    # --------------------------------------------------------------- output
    def output_data(self, cut: tuple | None = None):
        """The reference app's VTK field set (sim2d_2.cu:334-391) on the host,
        cut to ``cut`` (a tuple of slices over x and y) before the copy."""
        units = self.domain.units
        v2p = units.lbm2phys_velocity(1.0)
        sl = tuple(cut) if cut is not None else ()
        vs = (slice(None),) + sl
        u = to_host(self.u[vs]) * v2p
        scalars = {"lbm_density": to_host(self.rho[sl])}
        vectors = {"velocity": u}
        scalars["velocity_magnitude"] = np.sqrt(u[0] ** 2 + u[1] ** 2)
        if self.means_frozen and self.frozen_mean is not None:
            mean = to_host(self.frozen_mean[vs]) * v2p
        elif self.mean_samples > 0:
            mean = to_host(self.sum_v[vs]) / self.mean_samples * v2p
        else:
            mean = np.zeros_like(u)
        scalars["mean_vx"] = mean[0]
        scalars["mean_vy"] = mean[1]
        scalars["mean_vel_mag"] = np.sqrt(mean[0] ** 2 + mean[1] ** 2)
        if self.fluc_samples > 0:
            scalars["mean_fluc_mag"] = to_host(self.sum_upmag[sl]) / self.fluc_samples * v2p
        else:
            scalars["mean_fluc_mag"] = np.zeros_like(scalars["velocity_magnitude"])
        if self.domain.bouzidi is not None:
            bz = np.asarray(self.domain.bouzidi)
            for q, name in enumerate(THETA_NAMES):
                scalars[f"bouzidi_{name}"] = bz[(q,) + sl]
        return scalars, vectors

    def write_stats_snapshot(self, event: str):
        """A CSV statistics row (reference sim2d_2.cu:667-701)."""
        row = {
            "event": event,
            "time": self.phys_time(),
            "iterations": self.iterations,
            "ke_roi": self.integrate_ke_roi(),
            "tke_roi": self.integrate_tke_roi(),
            "mean_samples": self.mean_samples,
            "fluc_samples": self.fluc_samples,
            "roi_avg_mean_speed": self._roi_avg_mean_speed(),
            "roi_rms_fluc_speed": self._roi_rms_fluc_speed(),
            "means_frozen": self.means_frozen,
            "flucs_frozen": self.flucs_frozen,
        }
        self.csv_rows.append(row)
        path = self.results_dir / "stats.csv"
        write_header = not path.exists()
        with open(path, "a", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=list(row.keys()))
            if write_header:
                writer.writeheader()
            writer.writerow(row)

    def probe1(self):
        self.write_stats_snapshot("periodic")

    # ---------------------------------------------------------- checkpoint
    def checkpoint_arrays_extra(self) -> dict:
        """The statistics accumulators, saved beside f (JAX app's names)."""
        return {f"s2d2_{name}": getattr(self, name)
                for name in ("sum_v", "frozen_mean", "sum_up2", "sum_upmag")
                if getattr(self, name) is not None}

    def sim_init(self):
        super().sim_init()
        restored = self._restored_arrays
        if restored:
            for name in ("sum_v", "frozen_mean", "sum_up2", "sum_upmag"):
                if f"s2d2_{name}" in restored:
                    setattr(self, name, torch.as_tensor(restored[f"s2d2_{name}"]).to(
                        device=self.device, dtype=self.cfg.compute_dtype).contiguous())


def build(resolution: int = 1, object_file: str | None = None, enable_bouzidi: bool = True,
          final_time: float = 8.0, stat_start: float = 2.0, stat_end: float | None = None,
          results_parent=".", value_path: str | None = None, use_fused: bool = True,
          sharded: bool = False, *, device, devices=None) -> Sim2D2:
    """The statistics channel at ``resolution`` (lattice 128r x 32r) on
    ``device``; ``sharded`` plans it over ``devices`` (by default
    ``app_devices``)."""
    units = channel_units(resolution)
    dom = channel_domain(units, object_file, enable_bouzidi)
    cfg = LBMConfig(lat=D2Q9, collision=col2.collide_clbm_2d)
    obj = Path(object_file).stem if object_file else "none"
    sim = Sim2D2(cfg, dom, device=device, sim_id=f"sim2d_2_res{resolution:02d}_{obj}",
                 results_parent=results_parent, phys_final_time=final_time,
                 steps_per_dispatch=10, use_fused=use_fused,
                 plan=choose_plan(dom, devices or app_devices(device)) if sharded else None)
    sim.u_max_lbm = units.phys2lbm_velocity(1.5)
    sim.stats_start_time = stat_start
    sim.stats_end_time = (stat_end if stat_end is not None
                          else max(stat_start + 3.5, final_time - 2.0))
    sim.value_path = value_path
    sim.cnt[PRINT].period = final_time / 20
    sim.cnt[PROBE1].period = final_time / 40
    return sim


def main(argv=None) -> Sim2D2:
    p = argparse.ArgumentParser("sim2d_2", description="2D geometry channel with turbulence "
                                                      "statistics")
    p.add_argument("resolution", type=int, nargs="?", default=1)
    p.add_argument("object_file", nargs="?", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no card is present")
    p.add_argument("--no-bouzidi", action="store_true")
    p.add_argument("--sharded", action="store_true",
                   help="shard the lattice over the cards (on the CPU: over the one device)")
    p.add_argument("--final-time", type=float, default=8.0)
    p.add_argument("--stat-start", type=float, default=2.0)
    p.add_argument("--stat-end", type=float, default=None)
    p.add_argument("--results-dir", default=".")
    p.add_argument("--value-file", default=None, help="write the ROI TKE value here when frozen")
    args = p.parse_args(argv)
    sim = build(args.resolution, args.object_file, not args.no_bouzidi, args.final_time,
                args.stat_start, args.stat_end, args.results_dir, args.value_file,
                sharded=args.sharded, device=args.device)
    sim.run()
    print(f"final KE(ROI)={sim.integrate_ke_roi():e} TKE(ROI)={sim.integrate_tke_roi():e}")
    return sim


if __name__ == "__main__":
    main()
