"""Simulation loop: lifecycle, counters, probes, GLUPS, NaN guard.

Counterpart of the main-path subset of ``tnl_lbm_tpu/sim/state.py``
(reference state.h:89-330, state.hpp:906-1311, core.h:38-101):

- lifecycle ``sim_init`` -> loop { ``_advance`` (lattice steps),
  ``_after_sim_update`` (counter-gated actions) } -> ``after_sim_finished``;
- counters with periods in physical seconds (reference state.h:62-87) for
  PRINT and the app probes PROBE1-3;
- run directory ``results_<id>`` with flock-based double-run protection and
  the ``flag.*`` files (reference state.hpp:12-66);
- GLUPS reporting, the NaN guard on density, the walltime limit.

Steps are dispatched one at a time: the A-A even/odd CUDA kernels
(``kernels/fused_aa.py``) with ``use_fused=True``, else the plain PyTorch
step (``sim/step.py``).  Everything runs on the ``device`` given; asking
for a CUDA device without one raises.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from tnl_lbm_tpu_torch.ops import moments as mom
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig, initial_dfs
from tnl_lbm_tpu_torch.sim.step import make_step
from tnl_lbm_tpu_torch.utils.fileutils import FileLock, Flags, mkdir_p
from tnl_lbm_tpu_torch.utils.logging_utils import get_logger, init_logging

# counter names (reference state.h:73-87; the ported subset)
PRINT = "print"
PROBE1 = "probe1"
PROBE2 = "probe2"
PROBE3 = "probe3"
ALL_COUNTERS = (PRINT, PROBE1, PROBE2, PROBE3)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is available")
    return dev


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Counter:
    """Period-triggered action counter (reference state.h:61-71)."""

    count: int = 0
    period: float = -1.0

    def action(self, t: float) -> bool:
        return self.period > 0 and t >= self.count * self.period


class Simulation:
    """One lattice + its time loop.  Subclass and override the hooks (analog of
    the reference's virtual methods, state.h:216-229)."""

    def __init__(
        self,
        cfg: LBMConfig,
        domain: Domain,
        *,
        device,
        sim_id: str = "sim",
        results_parent=".",
        wall_time_limit: float | None = None,
        phys_final_time: float = np.inf,
        steps_per_dispatch: int = 1,
        use_fused: bool = False,
        pair_dispatch: bool | str = "auto",
    ):
        self.cfg = cfg
        self.domain = domain
        self.device = resolve_device(device)
        self.id = sim_id
        self.results_dir = Path(results_parent) / f"results_{sim_id}"
        self.wall_time_limit = wall_time_limit
        self.phys_final_time = phys_final_time
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self.use_fused = use_fused
        #: the one-kernel A-A pair is not ported yet: "auto" resolves to
        #: per-step dispatch, True raises (see _resolve_pair_dispatch)
        self.pair_dispatch = pair_dispatch

        self.cnt = {name: Counter() for name in ALL_COUNTERS}
        self.iterations = 0
        self.start_iterations = 0
        self.terminate = False
        self.terminate_reason = None
        self.nan_detected = False
        #: NaN scan cadence in iterations, independent of the PRINT counter
        self.nan_check_every = 100
        self._last_nan_check = 0

        self.f = None
        self.rho = None
        self.u = None

        self._lock = FileLock(self.results_dir / "lock")
        self.flags = Flags(self.results_dir)
        self._t_wall_start = time.time()
        self._glups_prev_iter = 0
        self._glups_prev_time = None
        self._compute_time = 0.0

        mkdir_p(self.results_dir)
        init_logging(self.results_dir)
        self.log = get_logger("main")
        self.prof = get_logger("profile")
        self._step = None

    # ------------------------------------------------------------------ hooks
    def update_inflow(self, phys_time: float):
        """Inflow velocity ([D] or [D,*S]) for this step, or None."""
        return None

    def body_force(self, phys_time: float):
        """Homogeneous body force [D], or None."""
        return None

    def compute_before_step(self):
        """Hook before each lattice step."""

    def compute_after_step(self):
        """Hook after each lattice step."""

    def probe1(self):
        """App-defined probe (PROBE1 counter), e.g. error norms."""

    def probe2(self):
        """App-defined probe (PROBE2 counter)."""

    def probe3(self):
        """App-defined probe (PROBE3 counter)."""

    # ------------------------------------------------------------- lifecycle
    def phys_time(self) -> float:
        return self.iterations * self.domain.units.phys_dt

    def can_compute(self) -> bool:
        """Refuse double-running / finished runs (reference state.hpp:40-66)."""
        if not self._lock.try_lock():
            self.log.warning("results dir is locked by another process")
            return False
        if self.flags.exists("finished"):
            self.log.info("simulation already finished")
            self._lock.release()
            return False
        return True

    def _build_step(self):
        if not self.use_fused:
            self._step = make_step(self.cfg, self.domain)
            return
        if self.cfg.streaming != "AA":
            raise NotImplementedError(
                "the A-B fused kernel (B4) is not ported yet: use streaming='AA' "
                "or use_fused=False")
        from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa

        self._step = make_fused_step_aa(self.cfg, self.domain, self.device)

    def _resolve_pair_dispatch(self):
        if self.pair_dispatch is True:
            raise NotImplementedError(
                "pair dispatch needs the one-kernel A-A pair (B1), not ported yet")
        if self.pair_dispatch == "auto":
            self.log.info("pair dispatch: the one-kernel A-A pair (B1) is not ported "
                          "yet - using per-step dispatch")
        self.pair_dispatch = False

    def sim_init(self):
        if self.flags.exists("loadstate"):
            raise NotImplementedError("checkpoint resume is not ported yet (ROADMAP A6)")
        self._build_step()
        self.estimate_memory_demands()
        self.f = initial_dfs(self.cfg, self.domain, self.device)
        self._initial_macro()
        self._resolve_pair_dispatch()
        self._glups_prev_time = time.time()
        self._t_wall_start = time.time()

    def _initial_macro(self):
        """Macro fields of the initial state without advancing (reference
        computeInitialMacro, lbm_block.hpp:252-277)."""
        self.rho, self.u = mom.density_velocity(self.cfg.lat, self.f, well=self.cfg.well,
                                                high_precision=self.cfg.high_precision_rho)

    def _advance(self, n_steps: int):
        """Run n_steps lattice updates, one dispatch per step."""
        nu = self.domain.units.lbm_viscosity()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            u_in = self.update_inflow(self.phys_time())
            force = self.body_force(self.phys_time())
            parity = (self.iterations % 2) if self.cfg.streaming == "AA" else 0
            self.compute_before_step()
            self.f, self.rho, self.u = self._step(self.f, nu, u_in=u_in, force=force,
                                                  parity=parity)
            self.iterations += 1
            self.compute_after_step()
        synchronize(self.device)
        self._compute_time += time.perf_counter() - t0

    # ------------------------------------------------------------- actions
    def _nan_guard(self) -> bool:
        """NaN scan of density (reference state.hpp:1166-1188); dumps the
        macro fields to ``vtk3D/data_nan_dump.vti``."""
        if not bool(torch.isnan(self.rho).any()):
            return False
        self.nan_detected = True
        self.terminate = True
        self.log.error("NaN detected in density at iteration %d - dumping state", self.iterations)
        from tnl_lbm_tpu.io.vtk import write_vti

        units = self.domain.units
        path = self.results_dir / "vtk3D" / "data_nan_dump.vti"
        path.parent.mkdir(parents=True, exist_ok=True)
        write_vti(path, scalars={"lbm_density": self.rho.cpu().numpy()},
                  vectors={"velocity": self.u.cpu().numpy()},
                  origin=units.lbm2phys_point([0] * self.cfg.lat.D), spacing=units.phys_dl)
        return True

    def estimate_memory_demands(self) -> dict:
        """Device-memory preflight (reference state.hpp:819-877): refuse to
        start when the state cannot fit.  Two DF buffers: the odd A-A
        kernel and the plain steps write a new state next to the old one."""
        sites = self.domain.units.num_sites
        itemsize = torch.empty((), dtype=self.cfg.compute_dtype).element_size()
        bytes_dfs = 2 * self.cfg.lat.Q * sites * itemsize
        bytes_macro = 2 * (1 + self.cfg.lat.D) * sites * itemsize
        total = bytes_dfs + bytes_macro + sites  # + the uint8 map
        free = torch.cuda.mem_get_info(self.device)[0] if self.device.type == "cuda" else 0
        info = {"total_bytes": total, "device_free": free}
        self.log.info("memory estimate: %.2f GB (device free %s)", total / 1e9,
                      f"{free / 1e9:.2f} GB" if free else "n/a")
        if free and total > 0.9 * free:
            raise MemoryError(f"state would not fit on {self.device}: {info}")
        return info

    def _print_stats(self):
        now = time.time()
        it = self.iterations
        d_it = it - self._glups_prev_iter
        d_t = now - (self._glups_prev_time or now)
        glups = self.domain.units.num_sites * d_it / d_t / 1e9 if d_t > 0 else 0.0
        t = self.phys_time()
        eta = ""
        if np.isfinite(self.phys_final_time) and t > 0:
            frac = t / self.phys_final_time
            eta = f" ETA {(now - self._t_wall_start) * (1 - frac) / frac:.0f}s"
        self.log.info("iter %d t=%.6g GLUPS=%.4f%s", it, t, glups, eta)
        self._glups_prev_iter = it
        self._glups_prev_time = now

    def after_sim_finished(self):
        wall = time.time() - self._t_wall_start
        it = self.iterations - self.start_iterations
        sites = self.domain.units.num_sites
        avg = sites * it / wall / 1e9 if wall > 0 else 0.0
        comp = sites * it / self._compute_time / 1e9 if self._compute_time > 0 else 0.0
        self.log.info("finished: %d iterations, wall %.2fs, avg GLUPS %.4f, compute GLUPS %.4f",
                      it, wall, avg, comp)
        self.prof.info("timers: compute %.2fs, other (host/actions) %.2fs",
                       self._compute_time, max(wall - self._compute_time, 0.0))

    # ---------------------------------------------------------------- loop
    def run(self) -> bool:
        """The execute() loop (reference core.h:38-101)."""
        if not self.can_compute():
            return False
        try:
            self.sim_init()
            while True:
                if self.domain.units.lbm_viscosity() <= 0:
                    self.log.error("zero viscosity - terminating (reference state.hpp:985-990)")
                    break
                self._advance(self.steps_per_dispatch)
                self._after_sim_update()
                if self.terminate:
                    self.flags.create("terminated")
                    break
                if self.phys_time() >= self.phys_final_time:
                    self.flags.create("finished")
                    break
                if (self.wall_time_limit is not None
                        and time.time() - self._t_wall_start > self.wall_time_limit):
                    self.log.warning("walltime limit reached - stopping without a "
                                     "checkpoint (checkpoints: ROADMAP A6)")
                    break
            self.after_sim_finished()
            return not self.nan_detected
        finally:
            self._lock.release()

    def _after_sim_update(self):
        t = self.phys_time()
        c = self.cnt
        if self.nan_check_every and self.iterations - self._last_nan_check >= self.nan_check_every:
            self._last_nan_check = self.iterations
            if self._nan_guard():
                return
        if c[PRINT].action(t):
            c[PRINT].count += 1
            if self._nan_guard():
                return
            self._print_stats()
        for name, hook in ((PROBE1, self.probe1), (PROBE2, self.probe2), (PROBE3, self.probe3)):
            if c[name].action(t):
                c[name].count += 1
                hook()
