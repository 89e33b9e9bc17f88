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

Dispatch (``_advance``): with ``use_fused=True`` and A-A streaming, pairs
of steps go through the one-kernel A-A pair (``make_fused_pair2_aa``) when
pair dispatch is on, and single steps - a leftover odd step, or every step
when pair dispatch is off - through the even/odd kernels
(``make_fused_step_aa``); without ``use_fused`` every step is the plain
PyTorch step (``sim/step.py``).  ``pair_dispatch="auto"`` times both
dispatches on a CUDA device and keeps the faster; half storage
(``cfg.storage_dtype``) forces pair dispatch.  Everything runs on the
``device`` given; asking for a CUDA device without one raises.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from tnl_lbm_tpu_torch.kernels.fused import supports
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


def needs_per_step_state(fn):
    """Mark a ``compute_before_step``/``compute_after_step`` override as
    reading the per-step lattice state (``self.f``).

    Under pair dispatch the state lives in the pair loop's own buffers for
    a whole dispatch chunk and ``self.f`` is refreshed only after it, so a
    hook reading ``self.f`` would not see the current state.  A marked hook
    turns pair dispatch off (``_pair_dispatch_capable``).  Hooks that read
    only ``self.rho``/``self.u`` (fresh after every pair) need no marker.
    """
    fn.needs_per_step_state = True
    return fn


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
        #: True, False or "auto"; resolved to a bool at sim_init
        #: (_resolve_pair_dispatch)
        self.pair_dispatch = pair_dispatch
        #: (pair ms, per-step ms) of the "auto" probe, when it ran
        self.pair_probe_ms = None

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
        self._pair = None

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
        """The single-step dispatch.  It runs on the full-width state, so it
        is built without ``storage_dtype`` (the pair loop widens the state
        at the end of each chunk)."""
        cfg = dataclasses.replace(self.cfg, storage_dtype=None)
        if not self.use_fused:
            self._step = make_step(cfg, self.domain)
            return
        if self.cfg.streaming != "AA":
            raise NotImplementedError(
                "the A-B fused kernel (B4) is not ported yet: use streaming='AA' "
                "or use_fused=False")
        from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa

        self._step = make_fused_step_aa(cfg, self.domain, self.device)

    def _build_pair(self):
        from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair2_aa

        if self._pair is None:
            self._pair = make_fused_pair2_aa(self.cfg, self.domain, self.device,
                                             store_dtype=self.cfg.storage_dtype)
        return self._pair

    def _pair_dispatch_capable(self) -> bool:
        """Static eligibility for the one-kernel A-A pair."""
        return (self.use_fused
                and self.cfg.streaming == "AA"
                and self.cfg.forcing_hook is None
                and self.cfg.lat.D == 3
                and not self._hooks_need_per_step_state()
                and supports(self.domain, self.cfg.streaming))

    def _hooks_need_per_step_state(self) -> bool:
        """True if a step hook is marked @needs_per_step_state."""
        if getattr(self, "needs_per_step_state", False):
            return True
        return any(getattr(getattr(self, name), "needs_per_step_state", False)
                   for name in ("compute_before_step", "compute_after_step"))

    def _pair_dispatch_ok(self) -> bool:
        """Pair dispatch is on: resolved at sim_init, which builds the pair
        kernel exactly then.  O(1) - it runs once per dispatch chunk, and
        ``_pair_dispatch_capable`` scans the whole geometry map."""
        return self.pair_dispatch is True and self._pair is not None

    def _resolve_pair_dispatch(self):
        """Resolve ``pair_dispatch`` to a bool.  Half storage forces it on;
        "auto" measures both dispatches on a CUDA device and keeps the
        faster, and is per-step on the CPU (the plain versions are no
        production path).  A pair kernel that fails to build or launch
        raises: there is no fallback."""
        if self.cfg.storage_dtype is not None:
            # half storage exists only on the pair path; falling back to the
            # full-width per-step kernels would ignore the precision request
            if self.pair_dispatch is False or not self._pair_dispatch_capable():
                raise ValueError(
                    "cfg.storage_dtype (half storage) requires the one-kernel A-A pair "
                    "path: use_fused=True, streaming='AA', no forcing hook or "
                    "per-step-state hooks, pair_dispatch not False")
            self.pair_dispatch = True
        elif self.pair_dispatch != "auto":
            self.pair_dispatch = bool(self.pair_dispatch)
        elif not self._pair_dispatch_capable() or self.device.type != "cuda":
            self.pair_dispatch = False
        else:
            t_pair, t_steps = self._probe_pair_dispatch()
            self.pair_probe_ms = (t_pair * 1e3, t_steps * 1e3)
            self.pair_dispatch = t_pair < t_steps
            self.log.info("pair-dispatch auto-probe: pair %.3f ms/pair vs per-step "
                          "%.3f ms/pair -> %s", t_pair * 1e3, t_steps * 1e3,
                          "pair dispatch" if self.pair_dispatch else "per-step dispatch")
        if self.pair_dispatch is True and self._pair_dispatch_capable():
            self._build_pair()

    def _probe_pair_dispatch(self, repeats: int = 5) -> tuple[float, float]:
        """Best-of-``repeats`` wall time in seconds of one A-A pair through
        (a) the pair kernel and (b) an even and an odd launch, each on a
        copy of the state; leaves ``self.f`` untouched."""
        from tnl_lbm_tpu_torch.kernels.fused_aa import to_storage

        nu = self.domain.units.lbm_viscosity()
        pair = self._build_pair()
        fs = to_storage(self.f, self.cfg.storage_dtype)
        out = torch.empty_like(fs)
        work = torch.empty_like(self.f)

        def time_pair():
            synchronize(self.device)
            t0 = time.perf_counter()
            pair(fs, nu, out=out)
            synchronize(self.device)
            return time.perf_counter() - t0

        def time_steps():
            work.copy_(self.f)
            synchronize(self.device)
            t0 = time.perf_counter()
            f1, _, _ = self._step(work, nu, parity=0)
            self._step(f1, nu, parity=1)
            synchronize(self.device)
            return time.perf_counter() - t0

        time_pair(), time_steps()  # warm up (first launch loads the library)
        t_pair = min(time_pair() for _ in range(repeats))
        t_steps = min(time_steps() for _ in range(repeats))
        return t_pair, t_steps

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

    def _advance_pairs(self, n_pairs: int, nu: float):
        """Advance 2 * n_pairs steps through the one-kernel A-A pair.

        The pair loop owns the state: it ping-pongs two buffers in the store
        dtype (the first is ``self.f`` itself when nothing is narrowed), so
        the state takes two buffers, as on the per-step path.  ``self.f``
        is None during the loop and is refreshed, widened to the compute
        dtype, after it; ``self.rho``/``self.u`` are fresh after every pair.
        Hooks run once per pair; a hook that reads ``self.f`` must be
        marked @needs_per_step_state, which turns pair dispatch off.
        """
        from tnl_lbm_tpu_torch.kernels.fused_aa import from_storage, to_storage

        fs = to_storage(self.f, self.cfg.storage_dtype)
        self.f = None
        spare = torch.empty_like(fs)
        for _ in range(n_pairs):
            u_in = self.update_inflow(self.phys_time())
            force = self.body_force(self.phys_time())
            self.compute_before_step()
            f_new, self.rho, self.u = self._pair(fs, nu, u_in=u_in, force=force, out=spare)
            fs, spare = f_new, fs
            self.iterations += 2
            self.compute_after_step()
        self.f = from_storage(fs, self.cfg.compute_dtype)

    def _advance(self, n_steps: int):
        """Run n_steps lattice updates: pairs through the pair kernel when
        pair dispatch is on and the parity is even, the rest one step per
        dispatch."""
        nu = self.domain.units.lbm_viscosity()
        t0 = time.perf_counter()
        if n_steps >= 2 and self.iterations % 2 == 0 and self._pair_dispatch_ok():
            n_pairs, n_steps = divmod(n_steps, 2)
            self._advance_pairs(n_pairs, nu)
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
        kernel, the pair kernel and the plain steps write a new state next
        to the old one (with half storage the two pair buffers are narrow,
        so this overestimates)."""
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
