"""The D2Q9 A-B step (B5): the 2D boundary set with the Bouzidi curved walls
and per-site inflow profiles, SRT or CLBM.

Counterpart of ``tnl_lbm_tpu/kernels/fused_2d.py`` ``make_fused_step_2d``.
:class:`FusedStep2D` launches ``csrc/d2q9_step.cu`` on CUDA tensors and runs
its plain version on CPU tensors: ``kernels/fused.py`` ``_stream_bc_collide``
(the per-site logic of the fused kernels, on whole arrays) with the D2Q9
collisions of ``ops/collision_2d.py``.  It never runs the plain version in
the kernel's place.  The JAX kernel holds the whole field in VMEM, which
bounds it to 409 600 sites (``supports_2d``'s VMEM estimate); one thread
per site has no such bound, so the estimate is not ported.

:class:`FusedChunk2D` is B5's second kernel, the counterpart of the JAX
driver's ``lax.scan`` over that whole-field kernel: ``n`` steps in one
launch on a lattice resident in the shared memory of one thread-block
cluster, for lattices within ``resident_fits`` (the golden sweep's
128 x 32).  Its plain version is ``n`` plain steps.  ``Simulation`` runs
its chunks per step: at 128 x 32 the host's dispatch of a chunk, not the
kernel, sets the time, and the resident chunk gained nothing end to end
(PERF.md §6).
"""

from __future__ import annotations

import ctypes
import functools
import re

import numpy as np
import torch

from tnl_lbm_tpu_torch.kernels.build import CSRC, load_library
from tnl_lbm_tpu_torch.kernels.fused import (
    CudaKernel,
    _stream_bc_collide,
    check_force_field,
    check_out,
    into,
    macro_buffers,
    site_force,
)
from tnl_lbm_tpu_torch.ops import boundary as bc
from tnl_lbm_tpu_torch.ops import collision_2d as col2
from tnl_lbm_tpu_torch.ops import equilibrium as eqlib
from tnl_lbm_tpu_torch.ops import streaming as stream
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig

#: GEO codes the D2Q9 kernel handles (JAX fused_2d.py:31-34)
SUPPORTED_CODES_2D = frozenset({GEO.FLUID, GEO.WALL, GEO.NOTHING, GEO.INFLOW, GEO.OUTFLOW_EQ,
                                GEO.OUTFLOW_RIGHT, GEO.FLUID_NEAR_WALL})
#: ``tnl_lbm_d2q9_step`` variant per (collision, a force was passed)
_VARIANTS = {(col2.collide_srt_2d, False): 0, (col2.collide_srt_2d, True): 1,
             (col2.collide_clbm_2d, False): 2, (col2.collide_clbm_2d, True): 2}
#: its force_field variant per collision: the per-site force (SRT with Guo's term)
_FF_VARIANTS = {col2.collide_srt_2d: 3, col2.collide_clbm_2d: 4}
#: CUDA grid limit on the y block index, which carries X
_MAX_GRID_Y = 65535


def _refusal(cfg: LBMConfig, domain: Domain, codes=None) -> str | None:
    """Why the D2Q9 kernel does not take (cfg, domain), or None: it takes
    D2Q9 A-B steps with SRT or CLBM, ``eq_quadratic`` on total DFs, float32,
    no forcing hook (``kernels/hooked.py`` builds the force_field variant
    on the config without it) and the codes of ``SUPPORTED_CODES_2D``."""
    if cfg.lat.name != "D2Q9":
        return f"lattice {cfg.lat.name}, not D2Q9"
    if cfg.streaming != "AB":
        return f"streaming {cfg.streaming!r} (the kernel is A-B)"
    if cfg.well or cfg.eq is not eqlib.eq_quadratic:
        return "an equilibrium other than eq_quadratic on total DFs (well=False)"
    if (cfg.collision, False) not in _VARIANTS:
        return f"collision {getattr(cfg.collision, '__name__', cfg.collision)} (SRT and CLBM only)"
    if cfg.compute_dtype != torch.float32 or cfg.storage_dtype is not None:
        return "a state other than float32 (its float64 instances: ROADMAP Bf64)"
    if cfg.forcing_hook is not None:
        return "a forcing hook (make_hooked_fused_step runs it)"
    codes = domain.codes_present() if codes is None else codes
    extra = codes - SUPPORTED_CODES_2D
    if extra:
        return "GEO codes " + ", ".join(sorted(c.name for c in extra))
    return None


def supports_2d(cfg: LBMConfig, domain: Domain) -> bool:
    """True when the D2Q9 kernel takes (cfg, domain) (JAX fused_2d.py:41-56,
    without its VMEM-fit bound).  Scans the host map."""
    return _refusal(cfg, domain) is None


def _vector2(value, what: str) -> tuple[float, float]:
    """A [2] host vector as two float32-rounded floats; None is zero."""
    if value is None:
        return (0.0, 0.0)
    if torch.is_tensor(value):
        if value.device.type != "cpu":
            raise ValueError(f"{what} must be given as host values, not a tensor on {value.device}")
        value = value.detach().numpy()
    arr = np.asarray(value)
    if arr.shape != (2,):
        if what == "force" and arr.ndim > 1:
            raise NotImplementedError("a per-site force goes to B5's force_field variant "
                                      "(make_fused_step_2d(force_field=True))")
        raise ValueError(f"{what} must be a [2] vector, got shape {arr.shape}")
    return tuple(float(v) for v in arr.astype(np.float32))


@functools.cache
def resident_limits() -> dict:
    """The resident chunk's size rule as ``csrc/d2q9_step.cu`` states it,
    read from that source: ``CLUSTER_MAX`` blocks, each holding a band of
    x rows in at most ``CHUNK_SMEM_MAX`` bytes of shared memory, at
    ``CHUNK_BYTES_PER_SITE`` a site plus ``CHUNK_THETA_BYTES`` with Bouzidi
    thetas."""
    src = (CSRC / "d2q9_step.cu").read_text()
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (CLUSTER_MAX|CHUNK_\w+) = (\d+);", src)}


def resident_band(shape) -> int:
    """The x rows of one block's band in the resident chunk."""
    return -(-int(shape[0]) // resident_limits()["CLUSTER_MAX"])


def resident_bytes(shape, thetas: bool = False) -> int:
    """Shared memory of one block of the resident chunk (128 x 32 with
    thetas takes 26 880 B, 256 x 64 107 520 B)."""
    lim = resident_limits()
    per_site = lim["CHUNK_BYTES_PER_SITE"] + (lim["CHUNK_THETA_BYTES"] if thetas else 0)
    return resident_band(shape) * int(shape[1]) * per_site


def resident_fits(shape, thetas: bool = False) -> bool:
    """The size rule of the resident chunk: a block's band fits
    ``CHUNK_SMEM_MAX`` (the largest square lattice is 176 x 176 with
    thetas, 208 x 208 without)."""
    return resident_bytes(shape, thetas) <= resident_limits()["CHUNK_SMEM_MAX"]


class FusedStep2D:
    """``step(f, nu, u_in=None, force=None, parity=0, out=None, macro_out=None)
    -> (f_new, rho, u)``.

    One D2Q9 A-B step out of place: into a new tensor, or into ``out`` (a
    second state buffer, not ``f``), so a caller can ping-pong two buffers;
    rho and u into new tensors, or into ``macro_out`` (a pair of buffers).
    ``force`` is a [2] host vector; SRT adds Guo's term only when a force is
    passed, as the JAX kernel does.  ``u_in`` is None, a [2] host vector, or
    a profile broadcastable to [2, X, Y] (sim2d_2's parabolic [2, 1, Y]); a
    profile already on the kernel's device is read in place through its
    strides, one on the host is copied there at each call.  ``parity`` is
    accepted for the common step contract and ignored.  ``kernel`` counts
    the launches, ``plain_calls`` the CPU-path calls.

    ``force_field`` (JAX ``make_fused_step_2d``'s flag, the carrier of the
    2D forcing hooks): ``force`` is a per-site [2, X, Y] float32 tensor on
    f's device, plus the [2] host vector ``force_add`` at every site; SRT
    always adds Guo's term with that per-site force.

    ``prepadded=True`` is the sharded step's B5 (JAX ``make_fused_step_2d``
    with ``local_shape``, which its sharded step gives the haloed extent):
    f is a shard's block of ``local_shape`` with a 1-wide ring, [9, X+2,
    Y+2], every pull read from the ring (no wrap, no clamp); each call gives
    the block's map (``map_arr_in``, uint8 [X, Y] on f's device) and, where
    the domain has Bouzidi thetas, the block's thetas (``bouzidi_arr_in``,
    float32 [8, X, Y]); a profile is the block's [2, X, Y] view.  The step
    writes the block's f, rho and u (``kernel`` counts the launches of
    ``tnl_lbm_d2q9_step_halo``, every variant).  No site update reads a
    neighbour's map code or theta (the Bouzidi and OUTFLOW_RIGHT pulls read
    f alone), so the block's own map and thetas are all it needs.
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, device, force_field: bool = False,
                 prepadded: bool = False, local_shape=None):
        codes = domain.codes_present()
        reason = _refusal(cfg, domain, codes)
        if reason is not None:
            raise NotImplementedError(
                f"the D2Q9 step kernel (B5) does not take {reason}; the JAX driver runs its "
                f"XLA step there, the port raises (ROADMAP §C: no plain fallback on the card)")
        self.cfg = cfg
        self.lat = cfg.lat
        self.device = torch.device(device)
        self.codes = codes
        self.do_coll_codes = sorted(int(c) for c in (bc.collision_mask_codes(2) & codes))
        self.prepadded = prepadded
        self.shape = tuple(local_shape) if local_shape is not None else domain.shape
        self.periodic = domain.periodic
        self.force_field = force_field
        #: the step reads Bouzidi thetas (at FLUID_NEAR_WALL sites)
        self.has_thetas = GEO.FLUID_NEAR_WALL in codes and domain.bouzidi is not None
        name = "d2q9_step_halo" if prepadded else "d2q9_step"
        self.kernel = CudaKernel(name + ("_force_field" if force_field and not prepadded else ""),
                                 "tnl_lbm_tpu_torch/csrc/d2q9_step.cu",
                                 "tnl_lbm_tpu/kernels/fused_2d.py:244")
        self.plain_calls = 0
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {device} requested but no CUDA device is available")
            if self.shape[0] > _MAX_GRID_Y:
                raise ValueError(f"X must be <= {_MAX_GRID_Y} for the kernel grid")
        self.map = self.thetas = None
        if not prepadded:
            self.map = torch.as_tensor(np.ascontiguousarray(domain.map, np.uint8),
                                       device=self.device)
            if self.has_thetas:
                self.thetas = torch.as_tensor(np.ascontiguousarray(domain.bouzidi, np.float32),
                                              device=self.device)

    def reset_counts(self) -> None:
        self.kernel.launches = self.plain_calls = 0

    def _profile(self, u_in, device):
        """(the profile as a [2, X, Y] view on ``device``, or None for a
        vector; the vector (ux, uy))."""
        if u_in is None:
            return None, (0.0, 0.0)
        if not torch.is_tensor(u_in) or u_in.device.type == "cpu":
            arr = np.asarray(u_in.detach() if torch.is_tensor(u_in) else u_in)
            if arr.ndim == 1:
                return None, _vector2(arr, "inflow velocity")
            u_in = torch.as_tensor(arr, device=device)
        elif u_in.device != device:
            raise ValueError(f"the inflow profile is on {u_in.device}, f on {device}")
        prof = u_in.to(torch.float32)
        if prof.ndim == 1:
            prof = prof.reshape(2, 1, 1)
        return prof.expand((2,) + tuple(self.shape)), (0.0, 0.0)

    def _forces(self, f, force, force_add):
        """(the per-site field or None, the homogeneous two floats)."""
        if self.force_field:
            return check_force_field(force, 2, self.shape, f.device), _vector2(force_add,
                                                                                "force")
        if force_add is not None:
            raise ValueError("force_add belongs to the force_field variant")
        return None, _vector2(force, "force")

    def __call__(self, f, nu, u_in=None, force=None, parity: int = 0, out=None,
                 force_add=None, macro_out=None, map_arr_in=None, bouzidi_arr_in=None):
        del parity
        field, fvec = self._forces(f, force, force_add)
        prof, uvec = self._profile(u_in, f.device)
        if self.prepadded:
            return self._halo_step(f, float(nu), field, fvec, force is not None, prof, uvec, out,
                                   macro_out, *self._block_inputs(f, map_arr_in, bouzidi_arr_in))
        check_out(out, f)
        if f.device.type == "cuda":
            return self._launch(f, float(nu), field, fvec, force is not None, prof, uvec, out,
                                macro_out)
        self.plain_calls += 1
        f_new, rho, u = self._plain(f, nu, field, fvec, force is not None, prof, uvec)
        if out is not None:
            f_new = out.copy_(f_new)
        return (f_new, *into(macro_out, rho, u))

    def plain(self, f, nu, u_in=None, force=None, force_add=None, map_arr_in=None,
              bouzidi_arr_in=None):
        """The step's plain PyTorch version on f's device: (f_new, rho, u),
        f untouched.  The CPU path, and the oracle the kernel is held
        against on the card; it counts no call."""
        prof, uvec = self._profile(u_in, f.device)
        field, fvec = self._forces(f, force, force_add)
        if self.prepadded:
            self._check_halo(f, None)
            return self._plain(f, nu, field, fvec, force is not None, prof, uvec,
                               *self._block_inputs(f, map_arr_in, bouzidi_arr_in))
        return self._plain(f, nu, field, fvec, force is not None, prof, uvec)

    def _block_inputs(self, f, map_arr_in, bouzidi_arr_in):
        """(map, thetas) of a haloed step's call, checked: the block's own."""
        X, Y = self.shape
        m = map_arr_in
        if (not torch.is_tensor(m) or m.dtype != torch.uint8 or m.device != f.device
                or tuple(m.shape) != (X, Y) or not m.is_contiguous()):
            raise ValueError(f"the haloed step takes the block's map at each call (map_arr_in): "
                             f"a contiguous uint8 [{X}, {Y}] tensor on {f.device}")
        t = bouzidi_arr_in
        if self.has_thetas != (t is not None):
            raise ValueError("the haloed step takes the block's thetas (bouzidi_arr_in) exactly "
                             "where the domain has Bouzidi thetas")
        if t is not None and (t.dtype != torch.float32 or t.device != f.device
                              or tuple(t.shape) != (8, X, Y) or not t.is_contiguous()):
            raise ValueError(f"bouzidi_arr_in must be a contiguous float32 [8, {X}, {Y}] tensor "
                             f"on {f.device}")
        return m, t

    def _check_halo(self, f, out) -> None:
        X, Y = self.shape
        if tuple(f.shape) != (self.lat.Q, X + 2, Y + 2) or not f.is_contiguous():
            raise ValueError(f"f must be a contiguous [{self.lat.Q}, {X + 2}, {Y + 2}] haloed "
                             f"block, got {tuple(f.shape)}")
        if out is not None and (tuple(out.shape) != (self.lat.Q, X, Y) or out.dtype != f.dtype
                                or out.device != f.device or not out.is_contiguous()):
            raise ValueError("out must be a contiguous state block of the local shape")

    def _halo_step(self, f, nu, field, fvec, has_force, prof, uvec, out, macro_out, m, thetas):
        """The haloed step: its kernel on a CUDA tensor, else its plain version."""
        self._check_halo(f, out)
        if f.device.type != "cuda":
            self.plain_calls += 1
            f_new, rho, u = self._plain(f, nu, field, fvec, has_force, prof, uvec, m, thetas)
            rho, u = into(macro_out, rho, u)
            return (f_new if out is None else out.copy_(f_new)), rho, u
        if f.dtype != torch.float32:
            raise NotImplementedError("the CUDA kernels take float32 state only")
        X, Y = self.shape
        f_new = torch.empty((self.lat.Q, X, Y), dtype=f.dtype, device=f.device) if out is None \
            else out
        rho, u = macro_buffers(macro_out, (X, Y), 2, f.dtype, f.device)
        variant, ff, bz, uin, strides = self._launch_args(field, has_force, thetas, prof)
        stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
        rc = load_library().tnl_lbm_d2q9_step_halo(
            f.data_ptr(), f_new.data_ptr(), m.data_ptr(), ff, bz, uin, *strides, rho.data_ptr(),
            u.data_ptr(), X, Y, variant, nu, *fvec, *uvec, stream_ptr)
        if rc != 0:
            raise RuntimeError(f"{self.kernel.name} launch failed: CUDA error {rc}")
        self.kernel.launches += 1
        return f_new, rho, u

    def _plain(self, f, nu, field, fvec, has_force, prof, uvec, m=None, thetas=None):
        """The step on whole arrays, f untouched: pulled from the lattice's
        edge/wrap pad of f, or for a haloed block (``m``: its map) from its
        ring."""
        if m is None:
            S = tuple(f.shape[1:])
            fpad = stream.pad_halo(f, self.periodic)
            m = self.map.to(f.device)
            thetas = None if self.thetas is None else self.thetas.to(f.device)
        else:
            S, fpad = self.shape, f

        def shifted(q, offs):
            return stream._shift_slices(fpad[q], offs, S)

        if field is not None:
            fvec = site_force(field, fvec)
            force_col = torch.stack(fvec)
        else:
            force_col = (torch.tensor(fvec, dtype=f.dtype, device=f.device).reshape(2, 1, 1)
                         if has_force else None)
        return _stream_bc_collide(self.lat, self.cfg, self.codes, self.do_coll_codes, shifted,
                                  m, nu, fvec,
                                  u_in=uvec if prof is None else prof, thetas=thetas,
                                  collision_force=force_col)

    def check_state(self, f) -> None:
        """f must be a contiguous float32 [9, X, Y] state on the kernel's card."""
        if self.device.type != "cuda" or f.device != self.map.device:
            raise ValueError(f"f is on {f.device}, the step was built for {self.device}")
        if f.dtype != torch.float32:
            raise NotImplementedError("the CUDA kernels take float32 state only")
        X, Y = self.shape
        if tuple(f.shape) != (self.lat.Q, X, Y) or not f.is_contiguous():
            raise ValueError(f"f must be a contiguous [{self.lat.Q}, {X}, {Y}] tensor, "
                             f"got {tuple(f.shape)}")

    def pbits(self) -> int:
        """The periodic axes as the kernels take them: bit 0 x, bit 1 y."""
        return sum(1 << a for a, p in enumerate(self.periodic) if p)

    def _launch(self, f, nu, field, fvec, has_force, prof, uvec, out, macro_out):
        self.check_state(f)
        X, Y = self.shape
        lib = load_library()
        f_new = torch.empty_like(f) if out is None else out
        rho, u = macro_buffers(macro_out, (X, Y), 2, f.dtype, f.device)
        variant, ff, bz, uin, strides = self._launch_args(field, has_force, self.thetas, prof)
        stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
        rc = lib.tnl_lbm_d2q9_step(f.data_ptr(), f_new.data_ptr(), self.map.data_ptr(), ff, bz, uin,
                                   *strides, rho.data_ptr(), u.data_ptr(), X, Y, self.pbits(),
                                   variant, nu, *fvec, *uvec, stream_ptr)
        if rc != 0:
            raise RuntimeError(f"{self.kernel.name} launch failed: CUDA error {rc}")
        self.kernel.launches += 1
        return f_new, rho, u

    def _launch_args(self, field, has_force, thetas, prof) -> tuple:
        """(variant, per-site force pointer or None, thetas pointer or 0,
        profile pointer or 0, its strides) of a launch of either entry."""
        bz = 0 if thetas is None else thetas.data_ptr()
        uin, strides = (0, (0, 0, 0)) if prof is None else (prof.data_ptr(), prof.stride())
        if field is None:
            return _VARIANTS[(self.cfg.collision, has_force)], None, bz, uin, strides
        return _FF_VARIANTS[self.cfg.collision], field.data_ptr(), bz, uin, strides


class FusedChunk2D:
    """``chunk(f, nu, n_steps, u_in=None, force=None, out=None, macro_out=None)
    -> (f_new, rho, u)``: ``n_steps`` A-B steps of ``step`` (a
    :class:`FusedStep2D` without ``force_field``; its map, thetas, inflow
    and force arguments) in one launch of ``csrc/d2q9_step.cu``'s resident
    chunk: a cluster of 16 blocks holds the lattice in its shared memory for
    the whole chunk.

    The state after the last step lands where the per-step ping-pong of f
    and ``out`` leaves it: in ``out`` after an odd ``n_steps``, in ``f``
    itself after an even one (``out`` None: a new tensor, f untouched); rho
    and u are the last step's, into new tensors or ``macro_out``.  The
    result equals ``n_steps`` launches of the step kernel bit for bit.  On
    CPU tensors it runs ``step`` ``n_steps`` times (its plain version, each
    counted as the step's plain call); on a CUDA tensor it launches the
    kernel or raises, for a lattice over the size rule (``resident_fits``)
    too.  ``kernel`` counts its launches, ``steps`` the steps they ran,
    ``plain_calls`` the CPU-path chunks."""

    def __init__(self, step: FusedStep2D):
        if step.force_field:
            raise NotImplementedError("the resident chunk takes the plain variants; the "
                                      "force_field step runs per step (its hook runs between "
                                      "steps)")
        thetas = step.thetas is not None
        if not resident_fits(step.shape, thetas):
            lim = resident_limits()
            raise ValueError(
                f"a {step.shape[0]}x{step.shape[1]} lattice does not fit the resident chunk's "
                f"cluster of {lim['CLUSTER_MAX']} blocks: {resident_band(step.shape)} rows of "
                f"{step.shape[1]} sites take {resident_bytes(step.shape, thetas)} B a block, "
                f"over {lim['CHUNK_SMEM_MAX']} B")
        self.step = step
        self.kernel = CudaKernel("d2q9_chunk", "tnl_lbm_tpu_torch/csrc/d2q9_step.cu",
                                 "tnl_lbm_tpu/kernels/fused_2d.py:244")
        self.steps = 0
        self.plain_calls = 0

    def reset_counts(self) -> None:
        self.kernel.launches = self.steps = self.plain_calls = 0

    def __call__(self, f, nu, n_steps: int, u_in=None, force=None, out=None, macro_out=None):
        n = int(n_steps)
        if n < 1:
            raise ValueError(f"a chunk runs at least one step, got {n_steps}")
        check_out(out, f)
        if f.device.type != "cuda":
            self.plain_calls += 1
            if out is None:  # f untouched: the steps ping-pong a copy and a new buffer
                f, out = f.clone(), torch.empty_like(f)
            cur, nxt = f, out
            for _ in range(n):
                new, rho, u = self.step(cur, nu, u_in=u_in, force=force, out=nxt,
                                        macro_out=macro_out)
                cur, nxt = new, cur
            return cur, rho, u
        fout = torch.empty_like(f) if out is None else (out if n % 2 else f)
        return self._launch(f, fout, float(nu), n, u_in, force, macro_out)

    def plain(self, f, nu, n_steps: int, u_in=None, force=None):
        """The chunk's plain version on f's device: ``n_steps`` plain steps
        (``FusedStep2D.plain``), (f_new, rho, u), f untouched; it counts
        nothing.  The oracle the kernel is held against on the card."""
        for _ in range(int(n_steps)):
            f, rho, u = self.step.plain(f, nu, u_in=u_in, force=force)
        return f, rho, u

    def geometry(self) -> dict:
        """The launch on the card: the band's rows, threads and shared memory
        per block, and how many such clusters the card holds at once (0:
        it cannot launch one)."""
        out = (ctypes.c_int * 4)()
        X, Y = self.step.shape
        rc = load_library().tnl_lbm_d2q9_chunk_info(X, Y, int(self.step.thetas is not None), out)
        if rc != 0:
            raise RuntimeError(f"d2q9_chunk_info failed: CUDA error {rc}")
        return {"cluster": resident_limits()["CLUSTER_MAX"], "rows": out[0], "threads": out[1],
                "smem_bytes": out[2], "active_clusters": out[3]}

    def _launch(self, f, fout, nu, n, u_in, force, macro_out):
        step = self.step
        step.check_state(f)
        X, Y = step.shape
        prof, uvec = step._profile(u_in, f.device)
        fvec = _vector2(force, "force")
        rho, u = macro_buffers(macro_out, (X, Y), 2, f.dtype, f.device)
        bz = 0 if step.thetas is None else step.thetas.data_ptr()
        uin, strides = (0, (0, 0, 0)) if prof is None else (prof.data_ptr(), prof.stride())
        variant = _VARIANTS[(step.cfg.collision, force is not None)]
        stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
        rc = load_library().tnl_lbm_d2q9_chunk(
            f.data_ptr(), fout.data_ptr(), step.map.data_ptr(), bz, uin, *strides,
            rho.data_ptr(), u.data_ptr(), X, Y, step.pbits(), variant, nu, *fvec, *uvec, n,
            stream_ptr)
        if rc != 0:
            raise RuntimeError(
                f"{self.kernel.name} launch failed (a cluster of "
                f"{resident_limits()['CLUSTER_MAX']} blocks, {resident_band(step.shape)} rows "
                f"each): CUDA error {rc}")
        self.kernel.launches += 1
        self.steps += n
        return fout, rho, u


def make_fused_step_2d(cfg: LBMConfig, domain: Domain, device, force_field: bool = False,
                       local_shape=None) -> FusedStep2D:
    """D2Q9 A-B step for (cfg, domain) on ``device``: see :class:`FusedStep2D`.
    Raises NotImplementedError for a config that :func:`supports_2d`
    refuses.  ``force_field`` builds the per-site-force variant.
    ``local_shape`` (X, Y) is the sharded step's block: the step takes the
    block with its 1-wide ring, [9, X+2, Y+2] (JAX's ``local_shape`` is that
    haloed extent, whose ring outputs it crops; the port computes the block
    alone)."""
    return FusedStep2D(cfg, domain, device, force_field=force_field,
                       prepadded=local_shape is not None, local_shape=local_shape)
