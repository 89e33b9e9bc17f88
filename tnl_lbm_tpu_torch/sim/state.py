"""Simulation loop: lifecycle, counters, probes, statistics, checkpoints.

Counterpart of ``tnl_lbm_tpu/sim/state.py`` (reference state.h:89-330,
state.hpp:906-1311, core.h:38-101):

- lifecycle ``sim_init`` -> loop { ``_advance`` (lattice steps),
  ``_after_sim_update`` (counter-gated actions) } -> ``after_sim_finished``;
- counters with periods in physical seconds (wall seconds for SAVESTATE;
  reference state.h:62-87) for PRINT, the two statistics resets, the app
  probes PROBE1-3, the 1D probes (VTK1D: ``Probe1DCut`` lines along an
  axis and ``Probe1DLine`` physical segments, appended to
  ``probes/<name>.dat``), the VTK output - 2D plane cuts (VTK2D,
  ``Probe2DCut``), the whole lattice (VTK3D) and strided 3D box cuts
  (VTK3DCUT, ``Probe3DCut``), each a ``.vti`` series with a ``.pvd`` index
  (reference state.hpp:123-511, lbm_block.hpp:799-1121) - and SAVESTATE,
  the periodic background checkpoint;
- two statistics windows of the velocity (``collect_stats``/``vm``/``vm2``
  and ``collect_stats2``/``vm_b``/``vm2_b``): a running mean and Welford
  covariance per window, reset by STAT_RESET and STAT2_RESET (reference
  D3Q27_MACRO_Mean, d3q27/macro.h:107-161);
- checkpoints (``save_state``, ``sim/checkpoint.py``; the JAX package's
  file format, so a run resumes in either package): the walltime stop
  saves and sets the ``loadstate`` flag, and ``sim_init`` resumes from it;
- run directory ``results_<id>`` with flock-based double-run protection and
  the ``flag.*`` files (reference state.hpp:12-66);
- GLUPS reporting, the NaN guard on density, the walltime limit.

Dispatch (``_advance``): with ``use_fused=True`` and A-B streaming every
step goes through the A-B kernel (``make_fused_step``; on a D2Q9 lattice
the D2Q9 kernel, ``make_fused_step_2d``, which raises for a config it does
not take).  A config with a forcing hook (the non-Newtonian force) runs
``make_hooked_fused_step`` (``kernels/hooked.py``): the one-kernel NN step
or the u*/hook/force-field pipeline; ``sample_phase_timers`` times its
phases.  With A-A streaming, pairs of steps go through one launch a pair
when pair dispatch is on - the one-kernel pair (``make_fused_pair2_aa``,
B1) on a FLUID/WALL/NOTHING map under CUM_WELL, the full-set pair
(``make_fused_pair_aa``, B1b) on the other A-A maps and variants - and
single steps - a leftover odd step, or every step when pair dispatch is
off or the map holds a code the A-A kernels refuse - through the even/odd
kernels (``make_fused_step_aa``); without ``use_fused`` every step is the plain
PyTorch step (``sim/step.py``).  ``pair_dispatch="auto"`` times both
dispatches on a CUDA device and keeps the pair unless per-step dispatch
is faster by more than ``PAIR_TIE``; half storage
(``cfg.storage_dtype``) forces pair dispatch.  Everything runs on the
``device`` given; asking for a CUDA device without one raises.

The kernel routes write into buffers made once at ``sim_init``: the state
and a spare that out-of-place launches ping-pong, rho and u, and for a
16-bit pair state two narrow buffers.  A dispatch chunk that
``_scan_chunk_args`` admits (the JAX ``lax.scan`` gate: at least 4 steps,
no per-step hook, even A-A parity, the same inflow and force at every
step) runs as one chunk (``_advance_scan``): on a CUDA device the kernel
routes capture it once as a CUDA graph per start buffer and input values
and replay it after that, the counterpart of the JAX scan's one device
program; elsewhere the same chunk runs eagerly, and so does a chunk whose
forcing hook reads the host (the IBM solve): there alone the chunk is not
one device program where the JAX scan is.

Under a ``plan`` (``parallel/sharded.py``; JAX ``Simulation(plan=...)``)
the state, rho, u and the statistics windows are ShardedFields, one block
per shard on its device, made at ``sim_init``; with ``use_fused`` the 3D
A-B steps run through the sharded A-B step (B4 on haloed blocks; a lattice
the mesh does not divide pads and crops) and the A-A steps through the
sharded even/odd steps (B2, and B3 on haloed blocks), the D2Q9 steps
through the sharded D2Q9 step (B5 on haloed blocks, padded and cropped as
the 3D A-B step is), else through the plain sharded step.  ``self.rho``
and ``self.u`` read the shards' blocks gathered on ``device`` (the
outputs, the probes, the NaN scan); each PRINT
logs the halo traffic to the profile log.  Under a plan every step is
dispatched from Python (no chunk, no CUDA graph: ``_scan_chunk_args``).
Pair dispatch under a plan that divides the lattice runs the sharded pair
(``make_sharded_fused_pair2_aa``: B1 or B1b on persistent haloed blocks,
the halo slabs exchanged once a pair), with the JAX rules: "on" and half
storage build it, "auto" times it against the sharded per-step route on
the card and stays per step on the CPU.  A run of pairs pads ``self.f``
into the pair's two haloed buffers once (narrowed for half storage) and
unpads the result into ``self.f``'s blocks at its end.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import time
import weakref
from pathlib import Path

import numpy as np
import torch

from tnl_lbm_tpu_torch.io import native
from tnl_lbm_tpu_torch.io.series import VtiTimeSeries
from tnl_lbm_tpu_torch.io.vtk import write_vti
from tnl_lbm_tpu_torch.kernels.fused import (NP_DTYPES, kernel_counters, make_fused_step,
                                             step_instance, supports)
from tnl_lbm_tpu_torch.kernels.fused_2d import make_fused_step_2d
from tnl_lbm_tpu_torch.ops import moments as mom
from tnl_lbm_tpu_torch.parallel.sharded import ShardedField
from tnl_lbm_tpu_torch.sim import checkpoint as ckpt
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig, initial_dfs
from tnl_lbm_tpu_torch.sim.step import make_step
from tnl_lbm_tpu_torch.utils.fileutils import FileLock, Flags, mkdir_p
from tnl_lbm_tpu_torch.utils.logging_utils import get_logger, init_logging, release_logging

# counter names (reference state.h:73-87)
STAT_RESET = "stat_reset"
STAT2_RESET = "stat2_reset"
PRINT = "print"
VTK1D = "vtk1d"
VTK2D = "vtk2d"
VTK3D = "vtk3d"
PROBE1 = "probe1"
PROBE2 = "probe2"
PROBE3 = "probe3"
SAVESTATE = "savestate"
VTK3DCUT = "vtk3dcut"
ALL_COUNTERS = (
    STAT_RESET, STAT2_RESET, PRINT, VTK1D, VTK2D, VTK3D,
    PROBE1, PROBE2, PROBE3, SAVESTATE, VTK3DCUT,
)

#: CUDA graphs one run keeps (start buffers x input values), oldest dropped first
GRAPH_CACHE = 8

#: "auto" keeps pair dispatch unless per-step dispatch is faster by more than
#: this share: a pair makes half the launches (and under a plan half the halo
#: exchanges), so where the two routes' device times tie the pair is the one
#: the host's load slows least (a 2-shard sim_2 res 8 A-A run on an H100 read
#: pair 0.81-0.82 ms, per step 0.80-1.23 ms from one run to the next)
PAIR_TIE = 0.05

# distinguishes "no inflow evaluated yet" from a None inflow
_UNSET = object()


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


@dataclasses.dataclass
class Probe1DCut:
    """A lattice line along ``axis`` written at every VTK1D action."""

    axis: int  # axis along which the line runs
    name: str
    pos: tuple  # fixed indices of the other axes, in axis order
    cycle: int = 0


@dataclasses.dataclass
class Probe1DLine:
    """Physical from->to line sampler (reference state.h:52-59 probe1Dlinecut)."""

    name: str
    start: tuple  # physical coordinates
    end: tuple
    n_samples: int = 100
    cycle: int = 0


@dataclasses.dataclass
class _Graph:
    """One captured chunk: the graph, the (f, spare) it leaves, the launches
    it makes per kernel record, and the inputs its kernels read by pointer
    (kept alive as long as the graph)."""

    graph: object
    end: tuple
    launches: list
    keep: tuple


def to_host(x) -> np.ndarray:
    """A field (tensor on any device, or array) as a host numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _ndim(x) -> int:
    return x.ndim if torch.is_tensor(x) else np.ndim(x)


def _same(a, b) -> bool:
    """Equal inflow/force values of two steps: the same object, else equal
    shapes and values (a tensor on the card is compared there)."""
    if a is b:
        return True
    if a is None or b is None:
        return False
    if torch.is_tensor(a) and torch.is_tensor(b) and a.device == b.device:
        return a.shape == b.shape and bool(torch.equal(a, b))
    a, b = to_host(a), to_host(b)
    if a.shape != b.shape:
        return False
    return (a.dtype == b.dtype and a.tobytes() == b.tobytes()) or np.array_equal(a, b)


def _value_key(v):
    """A graph cache key for an inflow or force: host values by value, a
    tensor on the card by its storage (its kernels read the pointer)."""
    if v is None:
        return None
    if torch.is_tensor(v) and v.device.type != "cpu":
        return ("device", v.data_ptr(), tuple(v.shape), tuple(v.stride()), str(v.dtype))
    arr = np.asarray(to_host(v), dtype=np.float64)
    return ("host", arr.shape, arr.tobytes())


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
        plan=None,
    ):
        self.cfg = cfg
        self.domain = domain
        self.device = resolve_device(device)
        #: the ShardPlan of a sharded run (parallel/sharded.py), or None
        self.plan = plan
        for dev in plan.devices if plan is not None else ():
            resolve_device(dev)
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
        self.probes_1d: list[Probe1DCut] = []
        self.probes_1d_line: list[Probe1DLine] = []
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
        # two independent statistics windows (reference D3Q27_MACRO_Mean
        # keeps two mean/covariance accumulator sets with separate reset
        # counters, d3q27/macro.h:117-160, reset at state.hpp:1231-1242)
        self.stat_counter = 0
        self.vm = None   # window-1 running mean velocity [D, *S]
        self.vm2 = None  # window-1 running (co)variance accumulators [D(D+1)/2, *S]
        self.stat2_counter = 0
        self.vm_b = None   # window-2 running mean
        self.vm2_b = None  # window-2 running (co)variance
        self.collect_stats = False
        self.collect_stats2 = False
        #: the two windows' sample counts on the device, which a replayed
        #: chunk advances (made at sim_init, set from the host counters
        #: before every dispatch)
        self._stat_n = None
        #: the arrays of the checkpoint sim_init resumed from, for subclasses
        self._restored_arrays = None

        self._lock = FileLock(self.results_dir / "lock")
        self.flags = Flags(self.results_dir)
        self._t_wall_start = time.time()
        self._glups_prev_iter = 0
        self._glups_prev_time = None
        self._compute_time = 0.0
        self._io_time = 0.0

        mkdir_p(self.results_dir)
        init_logging(self.results_dir)
        # the run's log files close when the run is collected
        weakref.finalize(self, release_logging, self.results_dir)
        self.log = get_logger("main")
        self.prof = get_logger("profile")
        self._step = None
        self._pair = None
        #: the second state buffer of the out-of-place launches' ping-pong
        #: (every kernel route but a 16-bit pair state's), made at sim_init
        self._spare = None
        #: a 16-bit pair state's two buffers in the store dtype; under a plan
        #: the sharded pair's two sets of haloed blocks
        self._narrow = None
        #: captured chunks by key (_graph_chunk), the memory pool they share
        #: and the stream they are captured on
        self._graphs = collections.OrderedDict()
        self._graph_pool = self._graph_stream = None
        #: chunk kinds whose route ran once eagerly, so a capture loads nothing
        self._graph_warm = set()
        #: chunks replayed from a CUDA graph
        self.graph_replays = 0
        #: host inflow profiles copied to the card once per value (a graph's input)
        self._device_inputs = {}
        self._vtk_series = {}

    # ------------------------------------------------------------------ hooks
    @property
    def rho(self):
        """Density [*S]; under a plan the shards' blocks gathered on ``device``."""
        return self._macro(0)

    @rho.setter
    def rho(self, value):
        self._rho, self._gathered = value, None

    @property
    def u(self):
        """Velocity [D, *S]; under a plan the shards' blocks gathered on ``device``."""
        return self._macro(1)

    @u.setter
    def u(self, value):
        self._u, self._gathered = value, None

    def _macro(self, i: int):
        if not isinstance(self._rho, ShardedField):
            return (self._rho, self._u)[i]
        if self._gathered is None:  # once per step at most
            self._gathered = (self._rho.gather(self.device), self._u.gather(self.device))
        return self._gathered[i]

    def update_inflow(self, phys_time: float):
        """Inflow velocity for this step, or None: a [D] vector, or a
        profile broadcastable to [D, *S] (a tensor on the run's device
        reaches the kernel without a copy)."""
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

    def checkpoint_arrays_extra(self) -> dict:
        """App-extension hook: extra arrays to checkpoint (analog of the
        reference's checkpointStateLocal, state.h:260)."""
        return {}

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

    def probe_values(self, cut: tuple | None = None) -> dict:
        """Fields probed by the 1D probes: name -> host array of ``cut`` (the
        scalars of ``output_data``, then each vector's components)."""
        scalars, vectors = self.output_data(cut)
        out = {k: to_host(v) for k, v in scalars.items()}
        for name, v in vectors.items():
            v = to_host(v)
            for a, ax in enumerate("xyz"[: v.shape[0]]):
                out[f"{name}_{ax}"] = v[a]
        return out

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
        if self.plan is not None:
            self._step = self._sharded_step(cfg)
            return
        if not self.use_fused:
            self._step = make_step(cfg, self.domain)
            return
        if self.cfg.forcing_hook is not None:
            # the non-Newtonian / IBM force: u* pass + hook + force-field
            # kernel, or the one-kernel NN step (reference kernels.h:92,
            # 178-218); a 2D config the D2Q9 kernel refuses raises there
            from tnl_lbm_tpu_torch.kernels.hooked import make_hooked_fused_step

            self._step = make_hooked_fused_step(cfg, self.domain, self.device)
            return
        if self.cfg.lat.D == 2:
            # a D2Q9 config the kernel refuses raises, where the JAX driver
            # runs its XLA step (ROADMAP §C)
            self._step = make_fused_step_2d(cfg, self.domain, self.device)
            return
        if self.cfg.streaming == "AB":
            self._step = make_fused_step(cfg, self.domain, self.device)
            return
        from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa

        self._step = make_fused_step_aa(cfg, self.domain, self.device)

    def _sharded_step(self, cfg):
        """The step of a sharded run (JAX ``Simulation.__init__`` under a
        plan): with the kernels, the 3D A-B step (B4 on haloed blocks), the
        A-A steps (B2, B3 on haloed blocks) or the D2Q9 step (B5 on haloed
        blocks; a D2Q9 config B5 refuses raises, ROADMAP §C), the A-B steps
        padded and cropped where the mesh does not divide the lattice;
        without them the plain sharded step.  A forcing hook takes the
        sharded hooked routes (JAX state.py:360-385): divisible plans through
        ``make_sharded_hooked_fused_step``, A-B plans that do not divide the
        lattice padded and cropped around it; a z cut raises naming A13b.
        The haloed kernels take a homogeneous inflow velocity; where the JAX
        ``Simulation``'s ``_vector_uin_only`` sends a per-site profile to its
        plain sharded step, they raise (ROADMAP A13b, Bprof): a plain step on
        the card is not a path."""
        from tnl_lbm_tpu_torch.parallel import sharded as sh

        if not self.use_fused:
            return sh.make_sharded_step(cfg, self.domain, self.plan)
        if cfg.forcing_hook is not None:
            from tnl_lbm_tpu_torch.kernels.hooked import make_sharded_hooked_fused_step

            sh._xy_only(self.plan, "the sharded hooked steps")
            if self.plan.divisible(self.domain):
                return make_sharded_hooked_fused_step(cfg, self.domain, self.plan)
            return sh._make_uneven_sharded_step(cfg, self.domain, self.plan,
                                                inner_builder=make_sharded_hooked_fused_step)
        if cfg.lat.D == 2:
            builder = sh.make_sharded_fused_step_2d
        elif cfg.streaming == "AA":
            return sh.make_sharded_fused_step_aa(cfg, self.domain, self.plan)
        else:
            builder = sh.make_sharded_fused_step
        if self.plan.divisible(self.domain):
            return builder(cfg, self.domain, self.plan)
        return sh._make_uneven_sharded_step(cfg, self.domain, self.plan, inner_builder=builder)

    def _build_pair(self):
        """The pair kernel of pair dispatch (``make_dispatch_pair``): B1 on a
        map of FLUID/WALL/NOTHING under CUM_WELL, in the store dtype; B1b,
        one launch a pair with the A-A codes and variants, elsewhere; under a
        plan the sharded pair over either (``make_sharded_fused_pair2_aa``).
        A config neither has an instance of raises."""
        from tnl_lbm_tpu_torch.kernels.fused_aa import make_dispatch_pair
        from tnl_lbm_tpu_torch.parallel.sharded import make_sharded_fused_pair2_aa

        if self._pair is None and self.plan is not None:
            self._pair = make_sharded_fused_pair2_aa(self.cfg, self.domain, self.plan,
                                                     store_dtype=self.cfg.storage_dtype)
        elif self._pair is None:
            self._pair = make_dispatch_pair(self.cfg, self.domain, self.device,
                                            store_dtype=self.cfg.storage_dtype)
        return self._pair

    def _pair_dispatch_capable(self) -> bool:
        """Static eligibility for pair dispatch, as the JAX package's: the
        kernels, A-A streaming, no forcing hook, 3D, no per-step-state hook,
        and every code of the map one the A-A kernels take.  Which pair
        kernel runs is ``_build_pair``'s, and "auto" asks
        ``_pair_has_instance`` whether one has an instance of the config;
        outside this set every step runs on its own.  Under a plan the plan
        must divide the lattice (JAX: the sharded pair's ``plan.divisible``)."""
        return ((self.plan is None or self.plan.divisible(self.domain))
                and self.use_fused
                and self.cfg.streaming == "AA"
                and self.cfg.forcing_hook is None
                and self.cfg.lat.D == 3
                and not self._hooks_need_per_step_state()
                and supports(self.domain, self.cfg.streaming))

    def _pair_has_instance(self) -> bool:
        """A pair kernel has an instance of the config on this map
        (``fused_aa.dispatch_pair_kind``): decided from the config, nothing
        is built; under a plan the sharded pair takes x/y meshes and B1b's
        cumulant instances only."""
        from tnl_lbm_tpu_torch.kernels.fused_aa import dispatch_pair_kind

        try:
            kind = dispatch_pair_kind(self.cfg, self.domain, self.cfg.storage_dtype)
        except NotImplementedError:
            return False
        if self.plan is None:
            return True
        return (self.plan.counts[2] == 1
                and (kind == "B1" or step_instance(self.cfg, "the sharded pair")[0] == "cum"))

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
        pair unless per-step is faster by more than ``PAIR_TIE``, and is
        per-step on the CPU (the plain versions are no
        production path).  A pair kernel that fails to build or launch
        raises: there is no fallback.  Under a plan the same rules hold for
        the sharded pair."""
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
        elif not self._pair_has_instance():
            self.pair_dispatch = False
            self.log.info("pair-dispatch auto: no pair kernel has an instance of this "
                          "collision and equilibrium -> per-step dispatch")
        else:
            self.pair_probe_ms = self.time_pair_routes()
            t_pair, t_steps = self.pair_probe_ms
            self.pair_dispatch = t_pair < t_steps * (1 + PAIR_TIE)
            self.log.info("pair-dispatch auto-probe: pair %.4f ms/pair vs per-step "
                          "%.4f ms/pair -> %s", t_pair, t_steps,
                          "pair dispatch" if self.pair_dispatch else "per-step dispatch")
        if self.pair_dispatch is True and self._pair_dispatch_capable():
            self._build_pair()

    def time_pair_routes(self, pairs: int = 10, chains: int = 5) -> tuple[float, float]:
        """Milliseconds per pair of (a) the pair kernel and (b) an even and an
        odd launch, as a run dispatches them: the median of each route's
        chains in :meth:`time_pair_chains`."""
        return tuple(float(np.median(t)) for t in self.time_pair_chains(pairs, chains))

    def time_pair_chains(self, pairs: int = 10, chains: int = 5) -> tuple[list, list]:
        """Milliseconds per pair of (a) the pair kernel and (b) an even and an
        odd launch, as a run dispatches them (the pair ping-pongs two
        buffers; the steps go through this run's step), per chain:
        ``chains`` chains of ``pairs`` pairs of each route, the two routes
        in turn after one chain each of warm-up, each timed with CUDA events
        around the chain, so the host's launch time counts where it exceeds
        the kernels'.  Each route runs on its own copy of a seeded
        near-equilibrium state (rho 1 +- 0.01, |u| ~ 0.02), not the run's:
        at rest every DF deviation is zero, and there the pair kernel ran
        13% slower than on a developed flow on an H100 (PERF.md).  The
        "auto" dispatch's probe; ``self.f`` is untouched."""
        from tnl_lbm_tpu_torch.kernels.fused_aa import to_storage

        nu = self.domain.units.lbm_viscosity()
        pair = self._build_pair()
        rng = np.random.default_rng(0)
        shape = self.domain.shape
        rho = torch.from_numpy((1 + 0.01 * rng.standard_normal(shape)).astype(np.float32))
        u = torch.from_numpy((0.02 * rng.standard_normal((3,) + shape)).astype(np.float32))
        state = self.cfg.eq(self.cfg.lat, rho.to(self.device), u.to(self.device))
        state = state.to(self.f.dtype).contiguous()
        del rho, u
        if self.plan is not None:  # the sharded pair's haloed blocks, the steps' blocks
            state = self.plan.shard_field(state, like_f=True)
            bufs = [pair.pad(state), None]
            bufs[1] = bufs[0].empty_like()
        else:
            bufs = [to_storage(state, self.cfg.storage_dtype).clone(), None]
            bufs[1] = torch.empty_like(bufs[0])
        work = [state]
        devices = self.plan.devices if self.plan is not None else [self.device]

        def run_pairs():
            for k in range(pairs):
                pair(bufs[k % 2], nu, out=bufs[1 - k % 2])
            if pairs % 2:
                bufs.reverse()

        def run_steps():
            for _ in range(pairs):
                f1, _, _ = self._step(work[0], nu, parity=0)
                work[0], _, _ = self._step(f1, nu, parity=1)

        def timed(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            for dev in set(devices) - {self.device}:  # every shard's card done
                synchronize(dev)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / pairs

        run_pairs(), run_steps()  # warm up (the first launch loads the library)
        times = [(timed(run_pairs), timed(run_steps)) for _ in range(chains)]
        return tuple(list(t) for t in zip(*times))

    def sim_init(self):
        self._build_step()
        self.estimate_memory_demands()
        loaded = ckpt.load_checkpoint(self.results_dir) if self.flags.exists("loadstate") else None
        if loaded is not None:
            self._resume(*loaded)
        else:
            self._restored_arrays = None
            self.f = initial_dfs(self.cfg, self.domain, self.device)
        if self.plan is not None:
            self._shard_state()
        self._alloc_stats()
        self._stat_n = torch.zeros(2, dtype=self.cfg.compute_dtype, device=self.device)
        self._initial_macro()
        self._resolve_pair_dispatch()
        if self.plan is not None:
            self._spare = self.f.empty_like() if self.use_fused else None
            if self._pair_dispatch_ok():  # the sharded pair's two haloed buffers
                first = self._pair.pad(self.f)
                self._narrow = (first, first.empty_like())
        elif self.use_fused:
            if self._pair_dispatch_ok() and self.cfg.storage_dtype is not None:
                self._narrow = tuple(torch.empty(self.f.shape, dtype=self.cfg.storage_dtype,
                                                 device=self.device) for _ in range(2))
            else:
                self._spare = torch.empty_like(self.f)
        self._glups_prev_time = time.time()
        self._t_wall_start = time.time()

    def _shard_state(self):
        """The state and any statistics window as the plan's ShardedFields
        (fields the mesh does not divide tile the step's padded extent)."""
        padded = self._step.padded_shape

        def shard(t):
            return None if t is None else self.plan.shard_field(t, like_f=True,
                                                                padded_shape=padded)

        self.f = shard(self.f)
        self.vm, self.vm2 = shard(self.vm), shard(self.vm2)
        self.vm_b, self.vm2_b = shard(self.vm_b), shard(self.vm2_b)

    def _resume(self, arrays: dict, meta: dict):
        """Take the state, counters and statistics of a checkpoint (either
        package's): ``sim_init`` with the ``loadstate`` flag set."""
        dev, dt = self.device, self.cfg.compute_dtype

        def tensor(a, dtype=dt):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

        self.f = tensor(arrays["f"]).contiguous()
        self.iterations = int(meta["iterations"])
        self.start_iterations = self.iterations
        self._glups_prev_iter = self.iterations
        self._last_nan_check = self.iterations
        self.stat_counter = int(meta.get("stat_counter", 0))
        self.stat2_counter = int(meta.get("stat2_counter", 0))
        for name in ALL_COUNTERS:
            if name in meta.get("counters", {}):
                self.cnt[name].count = int(meta["counters"][name])
        cycles = meta.get("probe_cycles", {})
        for key, probes in (("1d", self.probes_1d), ("1dline", self.probes_1d_line),
                            ("2d", self.probes_2d), ("3d", self.probes_3d)):
            for p, cyc in zip(probes, cycles.get(key, [])):
                p.cycle = int(cyc)
        if "vm" in arrays:
            self.vm, self.vm2 = tensor(arrays["vm"]), tensor(arrays["vm2"])
        if "vm_b" in arrays:
            self.vm_b, self.vm2_b = tensor(arrays["vm_b"]), tensor(arrays["vm2_b"])
        self._restored_arrays = arrays
        self.log.info("resumed from checkpoint at iteration %d", self.iterations)

    def _initial_macro(self):
        """Macro fields of the initial state without advancing (reference
        computeInitialMacro, lbm_block.hpp:252-277): the buffers the kernel
        routes write rho and u into from then on."""
        dt = self.cfg.compute_dtype

        def macro(f):
            rho, u = mom.density_velocity(self.cfg.lat, f, well=self.cfg.well,
                                          high_precision=self.cfg.high_precision_rho)
            return rho.to(dt).contiguous(), u.to(dt).contiguous()

        if isinstance(self.f, ShardedField):
            parts = [macro(b) for b in self.f.blocks]
            S, D = tuple(self.domain.shape), self.cfg.lat.D
            self.rho = ShardedField(self.plan, [p[0] for p in parts], S, self.f.padded)
            self.u = ShardedField(self.plan, [p[1] for p in parts], (D,) + S, self.f.padded)
        else:
            self.rho, self.u = macro(self.f)

    # ------------------------------------------------------------ statistics
    def _update_stats(self, u, vm, vm2, n):
        """Online mean + Welford covariance of the velocity, in place
        (reference d3q27/macro.h:107-161): ``vm`` and ``vm2`` take the
        sample ``u``; ``n`` is the window's sample count as a 0-d tensor on
        the device, advanced by one, so that a replayed chunk divides by
        the count of its own step."""
        D = self.cfg.lat.D
        if isinstance(u, ShardedField):  # block by block, the host's count
            for ub, vb, v2b in zip(u.blocks, vm.blocks, vm2.blocks):
                self._update_stats(ub, vb, v2b, torch.tensor(float(n), dtype=ub.dtype))
            return
        denom = 1.0 / (n + 1.0)
        delta = u - vm
        vm.add_(delta * denom)
        delta_new = u - vm
        i = 0
        for a in range(D):
            for b in range(a, D):
                vm2[i].add_(delta_new[a] * delta[b])
                i += 1
        n.add_(1.0)

    def _alloc_stats(self):
        """Zeroed accumulators for each window that is on and has none."""
        D, shape = self.cfg.lat.D, tuple(self.domain.shape)
        for on, vm, vm2 in ((self.collect_stats, "vm", "vm2"),
                            (self.collect_stats2, "vm_b", "vm2_b")):
            if on and getattr(self, vm) is None:
                for name, rows in ((vm, D), (vm2, D * (D + 1) // 2)):
                    if self.plan is not None:  # zero blocks like the state's
                        blocks = [b.new_zeros((rows,) + b.shape[1:]) for b in self.f.blocks]
                        setattr(self, name, ShardedField(self.plan, blocks, (rows,) + shape,
                                                         self.f.padded))
                        continue
                    setattr(self, name, torch.zeros((rows,) + shape, dtype=self.cfg.compute_dtype,
                                                    device=self.device))

    def _stats_sample(self, counts: bool = True):
        """Both windows take ``self.u`` (``counts``: advance the host counters
        too; a chunk advances them once for all its samples).  A window
        switched on after sim_init starts here."""
        for on, vm, vm2, k, name in ((self.collect_stats, "vm", "vm2", 0, "stat_counter"),
                                     (self.collect_stats2, "vm_b", "vm2_b", 1, "stat2_counter")):
            if not on:
                continue
            if getattr(self, vm) is None:
                self._alloc_stats()
            n = getattr(self, name) if self.plan is not None else self._stat_n[k]
            self._update_stats(self._u, getattr(self, vm), getattr(self, vm2), n)
            if counts:
                setattr(self, name, getattr(self, name) + 1)

    def _sync_stat_counts(self):
        """The device sample counts from the host counters, before a dispatch."""
        if self.collect_stats or self.collect_stats2:
            self._stat_n[0].fill_(float(self.stat_counter))
            self._stat_n[1].fill_(float(self.stat2_counter))

    # -------------------------------------------------------------- dispatch
    def _advance_pairs(self, n_pairs: int, nu: float, uin0=_UNSET):
        """Advance 2 * n_pairs steps through the one-kernel A-A pair, one
        pair per call.

        The pair loop owns the state: it ping-pongs two buffers in the store
        dtype, ``self.f`` and ``self._spare``, or for a 16-bit state the two
        narrow buffers, the float32 ``self.f`` narrowed into the first at
        the start and the result widened into it at the end (both exact).
        ``self.f`` is None during the loop; ``self.rho``/``self.u`` are
        fresh after every pair.  Hooks run once per pair; a hook that reads
        ``self.f`` must be marked @needs_per_step_state, which turns pair
        dispatch off.  The statistics take one sample per pair.
        """
        wide = self.f
        cur, spare = self._pair_buffers()
        self.f = None
        for i in range(n_pairs):
            u_in = uin0 if i == 0 and uin0 is not _UNSET else self.update_inflow(self.phys_time())
            force = self.body_force(self.phys_time())
            self.compute_before_step()
            cur, spare = self._one_pair(cur, spare, nu, u_in, force)
            self._stats_sample()
            self.iterations += 2
            self.compute_after_step()
        self._pair_done(wide, cur, spare)

    def _pair_buffers(self):
        """(state, spare) of a pair loop, the state narrowed into its buffer
        (under a plan: padded into the sharded pair's first haloed buffer)."""
        if self._narrow is None:
            return self.f, self._spare
        if self.plan is not None:
            self._pair.pad(self.f, out=self._narrow[0])
        else:
            self._narrow[0].copy_(self.f)
        return self._narrow

    def _one_pair(self, cur, spare, nu, u_in, force):
        self._gathered = None
        f_new, _, _ = self._pair(cur, nu, u_in=u_in, force=force, out=spare,
                                 macro_out=(self._rho, self._u))
        return f_new, cur

    def _pair_done(self, wide, cur, spare):
        if self._narrow is None:
            self.f, self._spare = cur, spare
        elif self.plan is not None:  # the interiors into the state's blocks, widened
            self.f = self._pair.unpad(cur, out=wide)
        else:
            self.f = wide.copy_(cur)

    def _one_step(self, nu, u_in, force, parity, kw):
        """One step of the single-step dispatch.  The kernel routes write
        the state into the spare (the A-A even step in place) and rho and u
        into their buffers; the plain step returns new tensors."""
        if not self.use_fused:
            self.f, self.rho, self.u = self._step(self.f, nu, u_in=u_in, force=force,
                                                  parity=parity, **kw)
            return
        self._gathered = None
        f_new, _, _ = self._step(self.f, nu, u_in=u_in, force=force, parity=parity,
                                 out=self._spare, macro_out=(self._rho, self._u), **kw)
        if f_new is not self.f:  # out of place: the old state is the next spare
            self._spare, self.f = self.f, f_new

    def _advance(self, n_steps: int):
        """Run n_steps lattice updates: pairs through the pair kernel when
        pair dispatch is on and the parity is even, the rest one step per
        dispatch; a chunk the gate admits (``_scan_chunk_args``) runs as
        one chunk (``_advance_scan``)."""
        nu = self.domain.units.lbm_viscosity()
        t0 = time.perf_counter()
        self._sync_stat_counts()
        # update_inflow may be stateful: evaluated once here, for the pair
        # check and the first step (JAX state.py _advance)
        uin0 = self.update_inflow(self.phys_time())
        if (n_steps >= 2 and self.iterations % 2 == 0 and self._pair_dispatch_ok()
                and (uin0 is None or _ndim(uin0) <= 1)):
            n_pairs, n_steps = divmod(n_steps, 2)
            args = self._scan_chunk_args(2 * n_pairs, uin0)
            if args is not None:
                self._advance_scan(2 * n_pairs, nu, *args, pairs=True)
            else:
                self._advance_pairs(n_pairs, nu, uin0=uin0)
            uin0 = _UNSET  # phys_time moved on; a leftover step evaluates again
        if n_steps:
            args = self._scan_chunk_args(n_steps, uin0)
            if args is not None:
                self._advance_scan(n_steps, nu, *args)
            else:
                self._advance_steps(n_steps, nu, uin0)
        for dev in {self.device, *(self.plan.devices if self.plan is not None else ())}:
            synchronize(dev)
        self._compute_time += time.perf_counter() - t0

    def _advance_steps(self, n_steps: int, nu: float, uin0=_UNSET):
        """n_steps single steps from Python, the hooks around each."""
        kw = self._hook_kwargs()
        for _ in range(n_steps):
            u_in = uin0 if uin0 is not _UNSET else self.update_inflow(self.phys_time())
            uin0 = _UNSET
            force = self.body_force(self.phys_time())
            parity = (self.iterations % 2) if self.cfg.streaming == "AA" else 0
            self.compute_before_step()
            self._one_step(nu, u_in, force, parity, kw)
            self._stats_sample()
            self.iterations += 1
            self.compute_after_step()

    def _scan_chunk_args(self, n_steps: int, uin0=_UNSET):
        """The gate of the chunked dispatch (JAX ``_scan_chunk_args``):
        ``(u_in, force)`` of the chunk when it may run as one chunk, else
        None.  It refuses fewer than 4 steps, a statistics window that is on
        but not allocated yet, an overridden ``compute_before_step`` or
        ``compute_after_step``, a @needs_per_step_state hook, an A-A chunk
        from an odd iteration or of an odd length, and an inflow or force
        that is not the same at every step of the chunk (each hook is
        evaluated at each step's time, or each pair's under pair dispatch,
        as often as the loop the chunk replaces would, until two differ;
        sameness is identity first - sim2d_3's cached profile on the card
        needs no read-back - then equal values)."""
        if (n_steps < 4 or self.plan is not None
                or (self.collect_stats and self.vm is None)
                or (self.collect_stats2 and self.vm_b is None)):
            return None
        base = Simulation
        if (type(self).compute_before_step is not base.compute_before_step
                or type(self).compute_after_step is not base.compute_after_step
                or self._hooks_need_per_step_state()):
            return None
        if self.cfg.streaming == "AA" and (self.iterations % 2 != 0 or n_steps % 2 != 0):
            return None
        dt_phys = self.domain.units.phys_dt
        # a pair chunk replaces the pair loop, which evaluates the hooks once a pair
        pairs = (self._pair_dispatch_ok()
                 and (uin0 is _UNSET or uin0 is None or _ndim(uin0) <= 1))
        u0 = f0 = None
        for i in range(0, n_steps, 2 if pairs else 1):
            ti = (self.iterations + i) * dt_phys
            ui = uin0 if (i == 0 and uin0 is not _UNSET) else self.update_inflow(ti)
            fi = self.body_force(ti)
            if i == 0:
                u0, f0 = ui, fi
            elif not (_same(u0, ui) and _same(f0, fi)):
                return None
        return u0, f0

    def _advance_scan(self, n_steps: int, nu: float, u_in, force, pairs: bool = False):
        """Advance n_steps as one chunk with the same ``u_in`` and ``force``
        at every step: ``n_steps // 2`` pairs when ``pairs``, else single
        steps from an even A-A parity; the statistics take their samples
        inside the chunk.  On a CUDA device the kernel routes run it as a
        CUDA graph (:meth:`_graph_chunk`), the counterpart of the JAX
        package's one ``lax.scan`` program, unless the forcing hook reads
        the host (``hook.reads_host``: the IBM solve reads its CG condition,
        which no capture can); elsewhere, for such a hook, and for the
        plain step, it runs eagerly."""
        s1, s2 = self.collect_stats, self.collect_stats2
        if self._chunk_as_graph():
            self._graph_chunk(n_steps, nu, u_in, force, pairs, s1, s2)
        else:
            self._chunk(n_steps, nu, u_in, force, pairs, s1, s2)
        samples = n_steps // 2 if pairs else n_steps
        if s1:
            self.stat_counter += samples
        if s2:
            self.stat2_counter += samples
        self.iterations += n_steps

    def _chunk_as_graph(self) -> bool:
        """True if a chunk runs as a CUDA graph: the kernel routes on a CUDA
        device, with no forcing hook that reads the host during a step."""
        return (self.device.type == "cuda" and self.use_fused
                and not getattr(self.cfg.forcing_hook, "reads_host", False))

    def _chunk(self, n_steps, nu, u_in, force, pairs, s1, s2):
        """The chunk's device work, and nothing else on the host but the
        buffer swaps: what a graph captures.  The statistics' host counters
        are the caller's."""
        if pairs:
            wide = self.f
            cur, spare = self._pair_buffers()
            for _ in range(n_steps // 2):
                cur, spare = self._one_pair(cur, spare, nu, u_in, force)
                self._stats_sample(counts=False)
            self._pair_done(wide, cur, spare)
            return
        kw = self._hook_kwargs()
        aa = self.cfg.streaming == "AA"
        for i in range(n_steps):
            self._one_step(nu, u_in, force, i % 2 if aa else 0, kw)
            self._stats_sample(counts=False)

    def _graph_chunk(self, n_steps, nu, u_in, force, pairs, s1, s2):
        """The chunk on the card as a CUDA graph: the first chunk of a kind
        runs eagerly once (it loads the library and sets the kernels'
        attributes, so nothing of that happens during a capture); after
        that each key (the kind, ``nu``, the inflow and force values, the
        buffers: the one the state starts in, rho, u, the windows) is
        captured once and replayed.  The kernels take ``u_in``, ``force``
        and ``nu`` by value, so other values need another graph; an
        out-of-place route that swaps its buffers an odd number of times per
        chunk gets one graph per start buffer.  A replay adds the launches
        the capture recorded to each kernel's count.  A capture or replay
        that fails raises."""
        kind = (n_steps, pairs, u_in is not None, force is not None, s1, s2)
        if kind not in self._graph_warm:
            self._chunk(n_steps, nu, u_in, force, pairs, s1, s2)
            self._graph_warm.add(kind)
            return
        u_in = self._device_input(u_in)
        key = kind + (float(nu), _value_key(u_in), _value_key(force), self._buffer_key())
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(key, n_steps, nu, u_in, force, pairs, s1, s2)
        else:
            self._graphs.move_to_end(key)
        entry.graph.replay()
        self.graph_replays += 1
        self.f, self._spare = entry.end
        for kernel, n in entry.launches:
            kernel.launches += n

    def _buffer_key(self) -> tuple:
        """The addresses a captured chunk reads and writes: the state and its
        spare (or narrow buffers), rho, u and the statistics windows."""
        bufs = (self.f, self._spare, *(self._narrow or ()), self.rho, self.u, self.vm,
                self.vm2, self.vm_b, self.vm2_b)
        return tuple(None if t is None else t.data_ptr() for t in bufs)

    def _device_input(self, u_in):
        """A host inflow profile ([D, ...]) as a tensor on the card in the
        compute dtype, made once per value: a capture may copy nothing from
        the host, and a float64 run's profile keeps its double values."""
        if u_in is None or torch.is_tensor(u_in) and u_in.device.type != "cpu":
            return u_in
        if _ndim(u_in) <= 1:
            return u_in  # a vector reaches the kernels as host floats
        arr = np.ascontiguousarray(to_host(u_in), dtype=NP_DTYPES[self.cfg.compute_dtype])
        key = (arr.shape, arr.tobytes())
        hit = self._device_inputs.get(key)
        if hit is None:
            if len(self._device_inputs) >= GRAPH_CACHE:
                self._device_inputs.clear()
            hit = self._device_inputs[key] = torch.as_tensor(arr, device=self.device)
        return hit

    def _capture(self, key, n_steps, nu, u_in, force, pairs, s1, s2) -> _Graph:
        kernels = kernel_counters(self._step, self._pair)
        before = [k.launches for k in kernels]
        start = (self.f, self._spare)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._graph_stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        # captured on a side stream, as torch.cuda.graph does, without its
        # cache release, which costs more than the run it would serve at
        # small lattices.  The cyclic garbage collector is off meanwhile: an
        # object it frees may release CUDA resources, a call that
        # invalidates the capture (seen on an H100: error 901 in a later
        # launch of the chunk)
        current = torch.cuda.current_stream(self.device)
        self._graph_stream.wait_stream(current)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self._graph_stream):
                graph.capture_begin(pool=self._graph_pool)
                try:
                    self._chunk(n_steps, nu, u_in, force, pairs, s1, s2)
                finally:
                    graph.capture_end()
            current.wait_stream(self._graph_stream)
        except Exception as exc:
            self.f, self._spare = start
            raise RuntimeError(f"capturing a {n_steps}-step chunk as a CUDA graph failed "
                               f"({'pairs' if pairs else 'steps'}, key {key[:6]})") from exc
        finally:
            if collecting:
                gc.enable()
        launches = [(k, k.launches - b) for k, b in zip(kernels, before) if k.launches != b]
        for k, b in zip(kernels, before):
            k.launches = b  # the capture ran nothing: a replay counts them
        entry = _Graph(graph, (self.f, self._spare), launches, (u_in, force))
        self._graphs[key] = entry
        while len(self._graphs) > GRAPH_CACHE:
            self._graphs.popitem(last=False)
        return entry

    def _hook_kwargs(self) -> dict:
        """The step's ``hook_consts`` argument: a hook's constant arrays
        (IBM's) are handed to every step (JAX ``state.py``: ``hook_consts``)."""
        consts = getattr(self.cfg.forcing_hook, "consts", None)
        return {} if consts is None else {"hook_consts": consts}

    def sample_phase_timers(self, repeats: int = 3) -> dict | None:
        """Per-phase times of the hooked step on the current state, in ms
        (``HookedStep.phase_times``: the u* pass, the hook and the main
        kernel, or the one-kernel NN step), logged to the profile log - the
        analog of the reference's IBM phase-timing JSON
        (lagrange_3D.hpp:368-378,856-859).  None when the step has no
        phases (no hook, or the plain step).  Its launches count as any
        other."""
        pt = getattr(self._step, "phase_times", None)
        if pt is None or self.f is None:
            return None
        force = self.body_force(self.phys_time())
        parity = (self.iterations % 2) if self.cfg.streaming == "AA" else 0
        out = pt(self.f, self.domain.units.lbm_viscosity(), force=force, parity=parity,
                 repeats=repeats)
        line = ", ".join(f"{k} {v:.4f} ms" for k, v in out.items())
        self.prof.info("hooked phases (sampled): %s", line)
        self.log.info("hooked phases (sampled): %s", line)
        return out

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

    def _write_probes_1d(self):
        """One line per ``Probe1DCut``, appended to ``probes/<name>.dat``:
        a header at the first cycle, then ``time index value...`` rows
        (JAX ``_write_probes_1d``).  Only the line leaves the device."""
        D = self.cfg.lat.D
        t = self.phys_time()
        for p in self.probes_1d:
            pos = iter(p.pos)
            cut = []
            for a in range(D):
                k = None if a == p.axis else next(pos)
                cut.append(slice(None) if k is None else slice(k, k + 1))
            vals = {k: v.reshape(-1) for k, v in self.probe_values(tuple(cut)).items()}
            path = self.results_dir / "probes" / f"{p.name}.dat"
            mkdir_p(path.parent)
            with open(path, "a") as fh:
                if p.cycle == 0:
                    fh.write("# time index " + " ".join(vals.keys()) + "\n")
                arrays = list(vals.values())
                for i in range(len(arrays[0])):
                    fh.write(f"{t} {i} " + " ".join(str(float(a[i])) for a in arrays) + "\n")
            p.cycle += 1

    def _write_probes_1d_line(self):
        """``n_samples`` points per ``Probe1DLine`` from ``start`` to ``end``
        (physical coordinates), each the nearest site, appended to
        ``probes/<name>.dat`` as ``time s value...`` rows (JAX
        ``_write_probes_1d_line``; reference state.hpp:174-372).  Only the
        box around the line leaves the device."""
        units = self.domain.units
        D = self.cfg.lat.D
        t = self.phys_time()
        for p in self.probes_1d_line:
            ts = np.linspace(0.0, 1.0, p.n_samples)
            pts = np.outer(1 - ts, p.start) + np.outer(ts, p.end)
            idx = np.stack([np.clip(np.round(units.phys2lbm_x(pts[:, a], a)).astype(int), 0,
                                    self.domain.shape[a] - 1) for a in range(D)])
            lo, hi = idx.min(axis=1), idx.max(axis=1) + 1
            vals = self.probe_values(tuple(slice(a, b) for a, b in zip(lo, hi)))
            cols = [v[tuple(idx - lo[:, None])] for v in vals.values()]
            path = self.results_dir / "probes" / f"{p.name}.dat"
            mkdir_p(path.parent)
            with open(path, "a") as fh:
                if p.cycle == 0:
                    fh.write("# time s " + " ".join(vals.keys()) + "\n")
                for k in range(p.n_samples):
                    fh.write(f"{t} {ts[k]} " + " ".join(str(float(c[k])) for c in cols) + "\n")
            p.cycle += 1

    def save_state(self, background: bool = False):
        """Checkpoint and the ``loadstate`` flag (reference
        state.hpp:739-770; JAX ``save_state``): the state (a 16-bit pair
        state widened, as ``self.f`` holds it between dispatches), both
        statistics windows, ``checkpoint_arrays_extra``, and the counters,
        probe cycles and iteration in the meta.  Each tensor is copied to
        the host once.  ``background=True`` hands the file to the native
        writer (``io/native.py``), which ``after_sim_finished`` flushes."""
        arrays = {"f": self.f}
        if self.vm is not None:
            arrays["vm"], arrays["vm2"] = self.vm, self.vm2
        if self.vm_b is not None:
            arrays["vm_b"], arrays["vm2_b"] = self.vm_b, self.vm2_b
        arrays.update(self.checkpoint_arrays_extra())
        meta = {
            "iterations": self.iterations,
            "stat_counter": self.stat_counter,
            "stat2_counter": self.stat2_counter,
            "counters": {k: c.count for k, c in self.cnt.items()},
            "probe_cycles": {
                "1d": [p.cycle for p in self.probes_1d],
                "1dline": [p.cycle for p in self.probes_1d_line],
                "2d": [p.cycle for p in self.probes_2d],
                "3d": [p.cycle for p in self.probes_3d],
            },
            "phys_time": self.phys_time(),
        }
        ckpt.save_checkpoint(self.results_dir, arrays, meta, background=background)
        self.flags.create("loadstate")
        self.log.info("checkpoint saved at iteration %d%s", self.iterations,
                      " (background write)" if background else "")

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
        if self.plan is not None and d_it > 0 and d_t > 0:
            # the halo bytes of the plan's exchange (JAX state.py: the
            # reference's MPI statistics, lbm.hpp:238-279)
            from tnl_lbm_tpu_torch.parallel.profiling import halo_traffic, pair_halo_traffic

            if self._pair_dispatch_ok():  # the pair's slabs, once a pair, in the store dtype
                traffic = pair_halo_traffic(self.domain, self.plan,
                                            itemsize=self._narrow[0].dtype.itemsize)
            else:
                traffic = halo_traffic(self.domain, self.plan, itemsize=self._rho.dtype.itemsize,
                                       subset=not self.use_fused)
            self.prof.info(traffic.log_line(d_it, d_t))
        self._glups_prev_iter = it
        self._glups_prev_time = now

    def after_sim_finished(self):
        #: one sampled phase breakdown per hooked run; opt out by setting
        #: sample_phases_at_finish = False before run()
        if getattr(self, "sample_phases_at_finish", True):
            self.sample_phase_timers()
        native.flush()  # drain the background checkpoint writes
        if native.errors():
            self.log.error("%d background writes failed", native.errors())
        wall = time.time() - self._t_wall_start
        it = self.iterations - self.start_iterations
        sites = self.domain.units.num_sites
        avg = sites * it / wall / 1e9 if wall > 0 else 0.0
        comp = sites * it / self._compute_time / 1e9 if self._compute_time > 0 else 0.0
        self.log.info("finished: %d iterations, wall %.2fs, avg GLUPS %.4f, compute GLUPS %.4f",
                      it, wall, avg, comp)
        self.prof.info("timers: compute %.2fs, io %.2fs, other (host/actions) %.2fs",
                       self._compute_time, self._io_time,
                       max(wall - self._compute_time - self._io_time, 0.0))

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
                    self.log.info("walltime limit reached - saving state")
                    self.save_state()
                    break
            self.after_sim_finished()
            return not self.nan_detected
        finally:
            self._lock.release()

    def _after_sim_update(self):
        """The counter-gated actions, in the JAX package's order: the NaN
        scan, PRINT, STAT_RESET, STAT2_RESET, PROBE1-3, VTK1D, VTK2D, VTK3D,
        VTK3DCUT, SAVESTATE."""
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
        if c[STAT_RESET].action(t):
            c[STAT_RESET].count += 1
            if self.vm is not None:
                self.vm.zero_()
                self.vm2.zero_()
            self.stat_counter = 0
        if c[STAT2_RESET].action(t):
            c[STAT2_RESET].count += 1
            if self.vm_b is not None:
                self.vm_b.zero_()
                self.vm2_b.zero_()
            self.stat2_counter = 0
        for name, hook in ((PROBE1, self.probe1), (PROBE2, self.probe2), (PROBE3, self.probe3)):
            if c[name].action(t):
                c[name].count += 1
                hook()
        for name, write in ((VTK1D, (self._write_probes_1d, self._write_probes_1d_line)),
                            (VTK2D, (self._write_vtk_2d,)), (VTK3D, (self._write_vtk_3d,)),
                            (VTK3DCUT, (self._write_vtk_3dcut,))):
            if not c[name].action(t):
                continue
            if name != VTK3D:  # VTK3D names its file by the count before the write
                c[name].count += 1
            t_io = time.perf_counter()
            for fn in write:
                fn()
            self._io_time += time.perf_counter() - t_io
            if name == VTK3D:
                c[name].count += 1
        if c[SAVESTATE].period > 0:
            wall = time.time() - self._t_wall_start
            if wall >= c[SAVESTATE].count * c[SAVESTATE].period:
                c[SAVESTATE].count += 1
                if c[SAVESTATE].count > 1:  # skip the initial save (reference state.hpp:948)
                    self.save_state(background=True)
