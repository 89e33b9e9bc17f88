"""Simulation loop: lifecycle, counters, probes, GLUPS, NaN guard.

Counterpart of the main-path subset of ``tnl_lbm_tpu/sim/state.py``
(reference state.h:89-330, state.hpp:906-1311, core.h:38-101):

- lifecycle ``sim_init`` -> loop { ``_advance`` (lattice steps),
  ``_after_sim_update`` (counter-gated actions) } -> ``after_sim_finished``;
- counters with periods in physical seconds (reference state.h:62-87) for
  PRINT, the app probes PROBE1-3 and the VTK output: 2D plane cuts
  (VTK2D, ``Probe2DCut``), the whole lattice (VTK3D) and strided 3D box
  cuts (VTK3DCUT, ``Probe3DCut``), each a ``.vti`` series with a ``.pvd``
  index (reference state.hpp:123-511, lbm_block.hpp:799-1121);
- run directory ``results_<id>`` with flock-based double-run protection and
  the ``flag.*`` files (reference state.hpp:12-66);
- GLUPS reporting, the NaN guard on density, the walltime limit.

Dispatch (``_advance``): with ``use_fused=True`` and A-B streaming every
step goes through the A-B kernel (``make_fused_step``), which writes into
a second preallocated state buffer: the loop ping-pongs the two, so the
state takes two buffers and a step allocates none.  With A-A streaming,
pairs of steps go through the one-kernel A-A pair (``make_fused_pair2_aa``)
when pair dispatch is on, and single steps - a leftover odd step, or every
step when pair dispatch is off or the pair refuses the map or collision -
through the even/odd kernels (``make_fused_step_aa``); without
``use_fused`` every step is the plain
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

from tnl_lbm_tpu_torch.io.series import VtiTimeSeries
from tnl_lbm_tpu_torch.io.vtk import write_vti
from tnl_lbm_tpu_torch.kernels.fused import make_fused_step, supports
from tnl_lbm_tpu_torch.ops import moments as mom
from tnl_lbm_tpu_torch.ops.collision import collide_cum_well
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig, initial_dfs
from tnl_lbm_tpu_torch.sim.step import make_step
from tnl_lbm_tpu_torch.utils.fileutils import FileLock, Flags, mkdir_p
from tnl_lbm_tpu_torch.utils.logging_utils import get_logger, init_logging

# counter names (reference state.h:73-87; the ported subset)
PRINT = "print"
PROBE1 = "probe1"
PROBE2 = "probe2"
PROBE3 = "probe3"
VTK2D = "vtk2d"
VTK3D = "vtk3d"
VTK3DCUT = "vtk3dcut"
ALL_COUNTERS = (PRINT, VTK2D, VTK3D, PROBE1, PROBE2, PROBE3, VTK3DCUT)


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


@dataclasses.dataclass
class Probe2DCut:
    """A plane cut written at every VTK2D action."""

    axis: int  # 0=X, 1=Y, 2=Z
    name: str
    position: int
    cycle: int = 0


@dataclasses.dataclass
class Probe3DCut:
    """A strided sub-box written at every VTK3DCUT action."""

    origin: tuple
    length: tuple
    step: int
    name: str
    cycle: int = 0


def to_host(x) -> np.ndarray:
    """A field (tensor on any device, or array) as a host numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


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
        self.probes_2d: list[Probe2DCut] = []
        self.probes_3d: list[Probe3DCut] = []
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
        #: the second state buffer of the out-of-place dispatches' ping-pong
        #: (the A-B kernel, the float32 pair loop), made at sim_init
        self._spare = None
        self._vtk_series = {}

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

    def output_data(self, cut: tuple | None = None):
        """name -> fields for the VTK output, as (scalars, vectors): rho and
        the velocity in physical units.  ``cut`` (a tuple of slices over
        the lattice axes) selects a plane or a box before the unit
        conversion, so a cut costs no whole-lattice temporary.  Tensors stay
        on the device; the writers copy them to the host."""
        units = self.domain.units
        sl = tuple(cut) if cut is not None else ()
        scalars = {"lbm_density": self.rho[sl]}
        vectors = {"velocity": self.u[(slice(None),) + sl]
                   * (units.phys_dl / units.phys_dt if units.phys_dt else 1.0)}
        return scalars, vectors

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
        if self.cfg.streaming == "AB":
            self._step = make_fused_step(cfg, self.domain, self.device)
            return
        from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa

        self._step = make_fused_step_aa(cfg, self.domain, self.device)

    def _ab_kernel(self) -> bool:
        """Every step goes through the A-B kernel, out of place."""
        return self.use_fused and self.cfg.streaming == "AB"

    def _build_pair(self):
        from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair2_aa

        if self._pair is None:
            self._pair = make_fused_pair2_aa(self.cfg, self.domain, self.device,
                                             store_dtype=self.cfg.storage_dtype)
        return self._pair

    def _pair_dispatch_capable(self) -> bool:
        """Static eligibility for the one-kernel A-A pair: its own code set
        (FLUID/WALL/NOTHING) and collision (CUM_WELL), narrower than the
        even/odd kernels'; a map or config the pair refuses runs per step."""
        return (self.use_fused
                and self.cfg.streaming == "AA"
                and self.cfg.forcing_hook is None
                and self.cfg.lat.D == 3
                and self.cfg.collision is collide_cum_well
                and not self._hooks_need_per_step_state()
                and supports(self.domain, self.cfg.streaming, pair=True))

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
        if self._ab_kernel() or (self._pair_dispatch_ok() and self.cfg.storage_dtype is None):
            self._spare = torch.empty_like(self.f)
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
        dtype, so the state takes two buffers, as on the per-step path.
        With nothing narrowed these are ``self.f`` and the persistent
        ``self._spare``; a 16-bit state gets its second buffer per chunk.
        ``self.f`` is None during the loop and is refreshed, widened to the
        compute dtype, after it; ``self.rho``/``self.u`` are fresh after
        every pair.  Hooks run once per pair; a hook that reads ``self.f``
        must be marked @needs_per_step_state, which turns pair dispatch off.
        """
        from tnl_lbm_tpu_torch.kernels.fused_aa import from_storage, to_storage

        fs = to_storage(self.f, self.cfg.storage_dtype)
        self.f = None
        spare = self._spare if self._spare is not None else torch.empty_like(fs)
        for _ in range(n_pairs):
            u_in = self.update_inflow(self.phys_time())
            force = self.body_force(self.phys_time())
            self.compute_before_step()
            f_new, self.rho, self.u = self._pair(fs, nu, u_in=u_in, force=force, out=spare)
            fs, spare = f_new, fs
            self.iterations += 2
            self.compute_after_step()
        self.f = from_storage(fs, self.cfg.compute_dtype)
        if self._spare is not None:
            self._spare = spare

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
            if self._ab_kernel():
                # A-B kernel: write into the spare buffer, keep the old state as the next spare
                f_new, self.rho, self.u = self._step(self.f, nu, u_in=u_in, force=force,
                                                     out=self._spare)
                self._spare, self.f = self.f, f_new
            else:
                self.f, self.rho, self.u = self._step(self.f, nu, u_in=u_in, force=force,
                                                      parity=parity)
            self.iterations += 1
            self.compute_after_step()
        synchronize(self.device)
        self._compute_time += time.perf_counter() - t0

    # ------------------------------------------------------------- actions
    def _nan_guard(self) -> bool:
        """NaN scan of density (reference state.hpp:1166-1188); dumps the
        output fields to the loose file ``vtk3D/data_<cycle>_nan_dump.vti``."""
        if not bool(torch.isnan(self.rho).any()):
            return False
        self.nan_detected = True
        self.terminate = True
        self.log.error("NaN detected in density at iteration %d - dumping state", self.iterations)
        self._write_vtk_3d(suffix="_nan_dump")
        return True

    def _series(self, subdir: str, name: str) -> VtiTimeSeries:
        """The .pvd-indexed stream of one output family (io/series.py)."""
        key = (subdir, name)
        s = self._vtk_series.get(key)
        if s is None:
            s = self._vtk_series[key] = VtiTimeSeries(self.results_dir / subdir, name)
        return s

    def _write_vtk_3d(self, suffix=""):
        """The whole lattice: a VTK3D series entry, or with ``suffix`` a loose
        diagnostic file outside the index."""
        scalars, vectors = self.output_data()
        scalars = {k: to_host(v) for k, v in scalars.items()}
        vectors = {k: to_host(v) for k, v in vectors.items()}
        units = self.domain.units
        cycle = self.cnt[VTK3D].count
        origin = units.lbm2phys_point([0] * self.cfg.lat.D)
        if suffix:
            path = self.results_dir / "vtk3D" / f"data_{cycle:06d}{suffix}.vti"
            write_vti(path, scalars=scalars, vectors=vectors, origin=origin,
                      spacing=units.phys_dl)
            return
        self._series("vtk3D", "data").append(
            scalars=scalars, vectors=vectors, time=self.phys_time(), origin=origin,
            spacing=units.phys_dl, cycle=cycle)

    def _write_vtk_2d(self):
        """One plane per ``Probe2DCut``: only the plane leaves the device."""
        units = self.domain.units
        D = self.cfg.lat.D
        for p in self.probes_2d:
            sl = [slice(None)] * D
            sl[p.axis] = slice(p.position, p.position + 1)
            start = [0] * D
            start[p.axis] = p.position
            scalars, vectors = self.output_data(tuple(sl))
            self._series("vtk2D", p.name).append(
                scalars={k: to_host(v) for k, v in scalars.items()},
                vectors={k: to_host(v) for k, v in vectors.items()},
                time=self.phys_time(), origin=units.lbm2phys_point([0] * D),
                spacing=units.phys_dl, start=start, cycle=p.cycle)
            p.cycle += 1

    def _write_vtk_3dcut(self):
        """One strided sub-box per ``Probe3DCut``."""
        units = self.domain.units
        for p in self.probes_3d:
            scalars, vectors = self.output_data(
                tuple(slice(o, o + L, p.step) for o, L in zip(p.origin, p.length)))
            self._series("vtk3Dcut", p.name).append(
                scalars={k: to_host(v) for k, v in scalars.items()},
                vectors={k: to_host(v) for k, v in vectors.items()},
                time=self.phys_time(), origin=units.lbm2phys_point(list(p.origin)),
                spacing=units.phys_dl * p.step, cycle=p.cycle)
            p.cycle += 1

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
        if c[VTK2D].action(t):
            c[VTK2D].count += 1
            self._write_vtk_2d()
        if c[VTK3D].action(t):
            self._write_vtk_3d()
            c[VTK3D].count += 1
        if c[VTK3DCUT].action(t):
            c[VTK3DCUT].count += 1
            self._write_vtk_3dcut()
