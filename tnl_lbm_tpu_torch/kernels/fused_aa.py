"""The A-A steps: CUDA kernels on CUDA tensors, plain PyTorch on CPU tensors.

Counterpart of ``tnl_lbm_tpu/kernels/fused_aa.py``: ``make_fused_step_aa``
(Pallas kernels ``even_kernel`` and ``_build_odd_call``) and
``make_fused_pair2_aa`` (the one-kernel pair).  The A-A pattern (reference
d3q27/streaming_AA.h) alternates two parities on one state:

- **even**: read same-site same-direction, collide, write the opposite
  slots of the same site.  The CUDA kernel (``csrc/aa_even.cu``) updates
  the state in place; so does the CPU path, so callers see one contract.
- **odd**: read the opposite components of the neighbours, collide, push
  to the neighbours, with edge replication at non-periodic boundaries and
  NOTHING sites keeping their DFs.  The CUDA kernel (``csrc/aa_odd.cu``)
  writes a new buffer.
- **pair**: an even step and then an odd step in one launch
  (``csrc/aa_pair.cu``), the intermediate kept on chip in float32, the
  state optionally stored in float16 or bfloat16 (half storage, see
  :class:`FusedPairAA`).  It writes a new buffer.
- **two-kernel pair** (:class:`FusedPairAATwoKernel`, ``csrc/aa_pair_pad.cu``):
  the even step writes its result into a buffer padded by one site in x
  and y, ring included, and the odd step pulls from it.  It takes the
  even/odd steps' codes and variants.

The even and odd steps take the A-B step's boundary set but
OUTFLOW_RIGHT_INTERP (JAX ``fused_aa.py`` runs ``_stream_bc_collide`` on the
A-B config) and its three variants: CUM_WELL, CUM with ``eq_quadratic``,
CUM with ``eq_inv_cum``.  The pair takes FLUID/WALL/NOTHING and CUM_WELL
(``kernels/fused.py PAIR_CODES``; the rest is ROADMAP B1).

``even_step_plain`` / ``odd_step_plain`` (and their composition,
``FusedPairAA.plain``) are the plain versions: the CPU path and the oracle
the kernels are held against on the card.  A step on CUDA tensors launches
its kernel or raises; it never runs the plain version in the kernel's place.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tnl_lbm_tpu_torch.kernels.build import load_library
from tnl_lbm_tpu_torch.kernels.fused import (
    CudaKernel,
    _check_kernel_config,
    _force3,
    _periodic_bits,
    _prep,
    _stream_bc_collide,
    _u_in3,
    aa_variant,
    check_force_field,
    site_force,
    variant_mode,
)
from tnl_lbm_tpu_torch.ops import streaming as stream
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig

#: the pair kernel's output tile of one block (csrc/pair_window.cuh TX, TY, TZ)
PAIR_TILE = (4, 4, 32)

#: store dtype -> the ``store`` code of ``tnl_lbm_aa_pair`` and a short tag
_STORE_CODES = {torch.float32: (0, "f32"), torch.float16: (1, "f16"),
                torch.bfloat16: (2, "bf16")}


def to_storage(f: torch.Tensor, store_dtype) -> torch.Tensor:
    """The state in its at-rest dtype: narrowed with round-to-nearest-even,
    or ``f`` itself when ``store_dtype`` is None or already f's dtype."""
    return f if store_dtype is None or f.dtype == store_dtype else f.to(store_dtype)


def from_storage(f: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The state widened to ``compute_dtype`` (``f`` itself when it is)."""
    return f if f.dtype == compute_dtype else f.to(compute_dtype)


def even_step_plain(cfg: LBMConfig, codes, do_coll_codes, f, m, nu, force,
                    u_in=(0.0, 0.0, 0.0), macro_only: bool = False):
    """A-A even step in plain PyTorch: returns (f_new, rho, u), f untouched.
    ``force`` is 3 scalars or 3 per-site fields, ``u_in`` 3 scalars;
    ``macro_only`` returns the u* moments (None, rho0, u0)."""
    opp = np.asarray(cfg.lat.opp)

    def shifted(q, offs):
        del offs  # no streaming on the even step: every pull rule reads the site
        return f[q]

    return _stream_bc_collide(cfg.lat, cfg, codes, do_coll_codes, shifted, m, nu, force,
                              u_in=u_in, out_perm=opp, macro_only=macro_only)


def odd_step_plain(cfg: LBMConfig, codes, do_coll_codes, periodic, f, m, nu, force,
                   u_in=(0.0, 0.0, 0.0), macro_only: bool = False):
    """A-A odd step in plain PyTorch: returns (f_new, rho, u), f untouched
    (``macro_only``: (None, rho0, u0)).  Each site collides with its own
    force; the push then edge-replicates the post-collision field."""
    lat = cfg.lat
    opp = np.asarray(lat.opp)
    S = tuple(f.shape[1:])
    fpad = stream.pad_halo(f, periodic)

    def shifted(q, offs):
        # odd-step read: neighbour, opposite direction (streaming_AA.h:47-60)
        return stream._shift_slices(fpad[int(opp[q])], offs, S)

    f_post, rho, u = _stream_bc_collide(lat, cfg, codes, do_coll_codes, shifted, m, nu, force,
                                        u_in=u_in, defer_nothing=True, macro_only=macro_only)
    if macro_only:
        return None, rho, u
    # push = pull of the edge/wrap-padded post-collision field
    pushed = stream.pull(lat, stream.pad_halo(f_post, periodic), S)
    if GEO.NOTHING in codes:
        pushed = torch.where(m == int(GEO.NOTHING), f, pushed)
    return pushed, rho, u


class FusedStepAA:
    """``step(f, nu, u_in=None, force=None, parity=0) -> (f, rho, u)``.

    ``parity`` 0 is the even step (in place: the returned f is the input
    tensor), 1 the odd step (a new tensor).  ``u_in`` and ``force`` are
    homogeneous [3] vectors, given as host values.  ``even`` and ``odd``
    count the kernel launches, ``plain_calls`` the CPU-path calls.
    ``lean=False`` keeps the kernels' full-set CUM_WELL instance on a map of
    FLUID/WALL/NOTHING, where the odd step would take its lean one
    (``kernels/fused.py aa_variant``).

    Variants (JAX ``make_fused_step_aa``'s flags), each its own instance of
    both kernels; neither has a lean instance, so they take the full-set
    CUM_WELL one:

    - ``force_field``: ``force`` is a per-site [3, X, Y, Z] float32 tensor on
      f's device plus the [3] host vector ``force_add`` at every site.  The
      odd step collides each site with the force of that site and pushes
      as the plain odd step does, so the edge-replicated layers carry the
      edge site's own post-collision DFs, which reproduces the JAX kernel's
      edge-replicated force ring (``_pad_force_ring``) with no ring tensor;
    - ``macro_only``: the u* pre-pass, ``step(...) -> (rho0, u0)``, the
      parity's read, the WALL swap, the symmetry mirrors and the moments
      with the homogeneous force; f is not written.
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, device, lean: bool = True,
                 force_field: bool = False, macro_only: bool = False):
        if cfg.streaming != "AA":
            raise ValueError("make_fused_step_aa needs streaming='AA'")
        self.cfg = cfg
        self.device = torch.device(device)
        self.lat, self.codes, self.do_coll_codes = _prep(cfg, domain)
        self.shape = domain.shape
        self.periodic = domain.periodic
        self.force_field, self.macro_only = force_field, macro_only
        self._mode, suffix = variant_mode(force_field, macro_only)
        self.even = CudaKernel("aa_even" + suffix, "tnl_lbm_tpu_torch/csrc/aa_even.cu",
                               "tnl_lbm_tpu/kernels/fused_aa.py:408")
        self.odd = CudaKernel("aa_odd" + suffix, "tnl_lbm_tpu_torch/csrc/aa_odd.cu",
                              "tnl_lbm_tpu/kernels/fused_aa.py:287")
        self.plain_calls = 0
        if self.device.type == "cuda":
            _check_kernel_config(cfg, domain, self.device)
            self.variant = aa_variant(cfg, self.codes, lean and not (force_field or macro_only))
        self.map = torch.as_tensor(np.ascontiguousarray(domain.map, np.uint8), device=self.device)

    def reset_counts(self) -> None:
        self.even.launches = self.odd.launches = self.plain_calls = 0

    def _forces(self, f, force, force_add):
        """(the per-site field or None, the homogeneous three floats)."""
        if self.force_field:
            return check_force_field(force, 3, self.shape, f.device), _force3(force_add)
        if force_add is not None:
            raise ValueError("force_add belongs to the force_field variant")
        return None, _force3(force)

    def __call__(self, f, nu, u_in=None, force=None, parity: int = 0, force_add=None):
        field, fvec = self._forces(f, force, force_add)
        uvec = _u_in3(u_in)
        if f.device.type == "cuda":
            return self._launch(f, float(nu), field, fvec, uvec, parity)
        self.plain_calls += 1
        f_new, rho, u = self._plain(f, nu, fvec, uvec, parity, field)
        if self.macro_only:
            return rho, u
        if parity == 0:
            f.copy_(f_new)
            return f, rho, u
        return f_new, rho, u

    def plain(self, f, nu, u_in=None, force=None, parity: int = 0, force_add=None):
        """The step's plain PyTorch version on f's device: (f_new, rho, u),
        or (rho0, u0) for the u* pass; f untouched.  The CPU path, and the
        oracle the kernels are held against on the card; it counts no call."""
        field, fvec = self._forces(f, force, force_add)
        f_new, rho, u = self._plain(f, nu, fvec, _u_in3(u_in), parity, field)
        return (rho, u) if self.macro_only else (f_new, rho, u)

    def _plain(self, f, nu, fvec, uvec, parity, field=None):
        m = self.map.to(f.device)
        force = fvec if field is None else site_force(field, fvec)
        if parity == 0:
            return even_step_plain(self.cfg, self.codes, self.do_coll_codes, f, m, nu, force,
                                   uvec, macro_only=self.macro_only)
        return odd_step_plain(self.cfg, self.codes, self.do_coll_codes, self.periodic,
                              f, m, nu, force, uvec, macro_only=self.macro_only)

    def _launch(self, f, nu, field, fvec, uvec, parity):
        if self.device.type != "cuda" or f.device != self.map.device:
            raise ValueError(f"f is on {f.device}, the step was built for {self.device}")
        if f.dtype != torch.float32:
            raise NotImplementedError("the CUDA kernels take float32 state only")
        X, Y, Z = self.shape
        if tuple(f.shape) != (self.lat.Q, X, Y, Z) or not f.is_contiguous():
            raise ValueError(f"f must be a contiguous [{self.lat.Q}, {X}, {Y}, {Z}] tensor, "
                             f"got {tuple(f.shape)}")
        lib = load_library()
        rho = torch.empty((X, Y, Z), dtype=f.dtype, device=f.device)
        u = torch.empty((3, X, Y, Z), dtype=f.dtype, device=f.device)
        stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
        neumaier = int(self.cfg.high_precision_rho)
        ff = None if field is None else field.data_ptr()
        if parity == 0:
            rc = lib.tnl_lbm_aa_even(f.data_ptr(), self.map.data_ptr(), ff, rho.data_ptr(),
                                     u.data_ptr(), X, Y, Z, self.variant, self._mode, nu, *fvec,
                                     *uvec, neumaier, stream_ptr)
            kernel, f_new = self.even, f
        else:
            f_new = None if self.macro_only else torch.empty_like(f)
            rc = lib.tnl_lbm_aa_odd(f.data_ptr(), None if f_new is None else f_new.data_ptr(),
                                    self.map.data_ptr(), ff, rho.data_ptr(), u.data_ptr(),
                                    X, Y, Z, _periodic_bits(self.periodic),
                                    int(GEO.NOTHING in self.codes), self.variant, self._mode,
                                    nu, *fvec, *uvec, neumaier, stream_ptr)
            kernel = self.odd
        if rc != 0:
            raise RuntimeError(f"{kernel.name} launch failed: CUDA error {rc}")
        kernel.launches += 1
        return (rho, u) if self.macro_only else (f_new, rho, u)


def make_fused_step_aa(cfg: LBMConfig, domain: Domain, device, force_field: bool = False,
                       macro_only: bool = False, lean: bool = True) -> FusedStepAA:
    """A-A step for (cfg, domain) on ``device``: see :class:`FusedStepAA`,
    with its ``force_field`` (per-site force) and ``macro_only`` (u*
    pre-pass) variants."""
    return FusedStepAA(cfg, domain, device, lean=lean, force_field=force_field,
                       macro_only=macro_only)


class FusedPairAA:
    """``pair(f, nu, u_in=None, force=None, out=None) -> (f_new, rho, u)``.

    Two A-A steps, even then odd, from an even parity.  ``f`` is the state
    in the store dtype (``to_storage``); rho and u come from the odd step,
    in the compute dtype (None with ``with_macro=False``).  The result goes
    to a new tensor, or into ``out`` (a second state buffer, not ``f``),
    so a caller can ping-pong two buffers.  ``kernel`` counts the launches
    of this store dtype's kernel, ``plain_calls`` the CPU-path calls.

    Half storage (``store_dtype`` float16 or bfloat16, FluidX3D's FP16S):
    the state rests in 16 bits and every operation runs in float32; the
    intermediate between the two steps is never narrowed, and NOTHING sites
    keep their stored bits.  It needs well-conditioned (deviation) DFs.
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, device, store_dtype=None,
                 with_macro: bool = True):
        if cfg.streaming != "AA":
            raise ValueError("make_fused_pair2_aa needs streaming='AA'")
        store = cfg.compute_dtype if store_dtype is None else store_dtype
        if store != cfg.compute_dtype:
            if store not in (torch.float16, torch.bfloat16):
                raise ValueError(f"store_dtype must be float16/bfloat16 or the compute "
                                 f"dtype, got {store}")
            if not cfg.well:
                raise ValueError("half storage needs well-conditioned (deviation) DFs: set "
                                 "cfg.well=True so the 16-bit mantissa applies to the small "
                                 "signal, not the O(w_q) rest-state carrier")
        self.cfg = cfg
        self.store_dtype = store
        self.with_macro = with_macro
        self.device = torch.device(device)
        self.lat, self.codes, self.do_coll_codes = _prep(cfg, domain, pair=True)
        self.shape = domain.shape
        self.periodic = domain.periodic
        self._store_code, tag = _STORE_CODES.get(store, (None, str(store)))
        self.kernel = CudaKernel(f"aa_pair_{tag}", "tnl_lbm_tpu_torch/csrc/aa_pair.cu",
                                 "tnl_lbm_tpu/kernels/fused_aa.py:1115")
        self.plain_calls = 0
        if self.device.type == "cuda":
            _check_kernel_config(cfg, domain, self.device, pair=True)
        self.map = torch.as_tensor(np.ascontiguousarray(domain.map, np.uint8), device=self.device)

    def reset_counts(self) -> None:
        self.kernel.launches = self.plain_calls = 0

    def __call__(self, f, nu, u_in=None, force=None, out=None, bflags=None):
        if bflags is not None:
            raise NotImplementedError("per-shard boundary flags are not ported yet "
                                      "(ROADMAP A13)")
        if u_in is not None and np.ndim(u_in) > 1:
            raise NotImplementedError("per-site inflow profiles are not ported yet (ROADMAP A8)")
        if out is not None and (out is f or out.shape != f.shape or out.dtype != f.dtype
                                or out.device != f.device or not out.is_contiguous()):
            raise ValueError("out must be a second contiguous state buffer like f")
        if f.dtype != self.store_dtype:
            raise ValueError(f"f is {f.dtype}, the pair stores {self.store_dtype}")
        if f.device.type == "cuda":
            return self._launch(f, float(nu), _force3(force), out)
        self.plain_calls += 1
        f_new, rho, u = self.plain(f, nu, force=force)
        if out is not None:
            f_new = out.copy_(f_new)
        return f_new, rho, u

    def plain(self, f, nu, force=None):
        """The pair's plain PyTorch version on f's device: the odd step of
        the even step of the widened state, narrowed (f untouched, no call
        counted)."""
        fvec = _force3(force)
        m = self.map.to(f.device)
        fw = from_storage(f, self.cfg.compute_dtype)
        ev, _, _ = even_step_plain(self.cfg, self.codes, self.do_coll_codes, fw, m, nu, fvec)
        f_new, rho, u = odd_step_plain(self.cfg, self.codes, self.do_coll_codes, self.periodic,
                                       ev, m, nu, fvec)
        f_new = to_storage(f_new, self.store_dtype)
        return (f_new, rho, u) if self.with_macro else (f_new, None, None)

    def _launch(self, f, nu, fvec, out):
        if self.device.type != "cuda" or f.device != self.map.device:
            raise ValueError(f"f is on {f.device}, the pair was built for {self.device}")
        X, Y, Z = self.shape
        if tuple(f.shape) != (self.lat.Q, X, Y, Z) or not f.is_contiguous():
            raise ValueError(f"f must be a contiguous [{self.lat.Q}, {X}, {Y}, {Z}] tensor, "
                             f"got {tuple(f.shape)}")
        lib = load_library()
        f_new = torch.empty_like(f) if out is None else out
        rho = u = None
        if self.with_macro:
            rho = torch.empty((X, Y, Z), dtype=self.cfg.compute_dtype, device=f.device)
            u = torch.empty((3, X, Y, Z), dtype=self.cfg.compute_dtype, device=f.device)
        stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
        rc = lib.tnl_lbm_aa_pair(f.data_ptr(), f_new.data_ptr(), self.map.data_ptr(),
                                 rho.data_ptr() if rho is not None else None,
                                 u.data_ptr() if u is not None else None, X, Y, Z,
                                 _periodic_bits(self.periodic), int(GEO.NOTHING in self.codes),
                                 int(self.with_macro), self._store_code, nu, *fvec,
                                 int(self.cfg.high_precision_rho), stream_ptr)
        if rc != 0:
            raise RuntimeError(f"{self.kernel.name} launch failed: CUDA error {rc}")
        self.kernel.launches += 1
        return f_new, rho, u


def make_fused_pair2_aa(cfg: LBMConfig, domain: Domain, device, store_dtype=None,
                        with_macro: bool = True, *, local_shape=None, prepadded: bool = False,
                        z_halo: int = 0) -> FusedPairAA:
    """One-kernel A-A pair for (cfg, domain) on ``device``: see :class:`FusedPairAA`.

    The JAX function's TPU knobs (``tile``, ``tiles_per_program``, ``window``,
    ``map_mode``, ``zprofile``, ``even_band``, ``vmem_limit_mb``,
    ``_debug_dma``) shape its padded VMEM pipeline and have no counterpart
    here; its sharded knobs (``local_shape``, ``prepadded``, ``z_halo`` and
    the call's ``bflags``) are not ported yet (ROADMAP A13).
    """
    if local_shape is not None or prepadded or z_halo:
        raise NotImplementedError("the sharded pair (local_shape, prepadded, z_halo) is not "
                                  "ported yet (ROADMAP A13)")
    return FusedPairAA(cfg, domain, device, store_dtype=store_dtype, with_macro=with_macro)


class FusedPairAATwoKernel:
    """``pair(f, nu, u_in=None, force=None) -> (f2, rho, u)``: two A-A steps,
    even then odd, in two launches (JAX ``make_fused_pair_aa``, B1b).

    ``even_step(f, ...)`` writes the even step's result into a new
    [Q, X+2, Y+2, Z] buffer whose one-site ring in x and y equals
    ``pad_halo`` of that result (wrapped on periodic axes, edge-replicated
    otherwise), so no halo-fill pass runs between the launches;
    ``odd_step(fpad, ...)`` pulls from it and pushes into a new [Q, X, Y, Z]
    state, with rho and u of this step (None with ``with_macro=False``).
    ``f`` is never written.  ``u_in`` and ``force`` are homogeneous [3]
    vectors given as host values.  ``even`` and ``odd`` count the launches
    of the two kernels, ``plain_calls`` the CPU-path calls.  The codes and
    variants are the A-A even/odd steps' (all but OUTFLOW_RIGHT_INTERP;
    CUM_WELL, CUM with eq_quadratic or eq_inv_cum); on a map of FLUID, WALL
    and NOTHING the odd kernel runs its lean CUM_WELL instance.
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, device, with_macro: bool = True):
        if cfg.streaming != "AA":
            raise ValueError("make_fused_pair_aa needs streaming='AA'")
        self.cfg = cfg
        self.with_macro = with_macro
        self.device = torch.device(device)
        self.lat, self.codes, self.do_coll_codes = _prep(cfg, domain)
        self.shape = domain.shape
        self.periodic = domain.periodic
        src = "tnl_lbm_tpu_torch/csrc/aa_pair_pad.cu"
        self.even = CudaKernel("aa_pair_pad_even", src, "tnl_lbm_tpu/kernels/fused_aa.py:1274")
        self.odd = CudaKernel("aa_pair_pad_odd", src, "tnl_lbm_tpu/kernels/fused_aa.py:287")
        self.plain_calls = 0
        self.variant = None  # the kernels' instance, on a CUDA device
        if self.device.type == "cuda":
            _check_kernel_config(cfg, domain, self.device)
            self.variant = aa_variant(cfg, self.codes)
        self.map = torch.as_tensor(np.ascontiguousarray(domain.map, np.uint8), device=self.device)

    def reset_counts(self) -> None:
        self.even.launches = self.odd.launches = self.plain_calls = 0

    @property
    def padded_shape(self) -> tuple[int, int, int, int]:
        X, Y, Z = self.shape
        return (self.lat.Q, X + 2, Y + 2, Z)

    def __call__(self, f, nu, u_in=None, force=None):
        if f.device.type == "cuda":
            return self.odd_step(self.even_step(f, nu, u_in, force), nu, u_in, force)
        self.plain_calls += 1
        return self.plain(f, nu, u_in, force)

    def plain(self, f, nu, u_in=None, force=None):
        """The pair's plain PyTorch version on f's device: ``even_step_plain``
        then ``odd_step_plain`` (through the padded buffer); f untouched, no
        call counted."""
        return self.plain_odd_step(self.plain_even_step(f, nu, u_in, force), nu, u_in, force)

    def plain_even_step(self, f, nu, u_in=None, force=None):
        """The even kernel's plain version: the padded buffer, its ring
        ``pad_halo`` of the even step's result."""
        self._check(f, (self.lat.Q,) + tuple(self.shape))
        ev, _, _ = even_step_plain(self.cfg, self.codes, self.do_coll_codes, f,
                                   self.map.to(f.device), nu, _force3(force), _u_in3(u_in))
        return stream.pad_halo(ev, self.periodic[:2])

    def plain_odd_step(self, fpad, nu, u_in=None, force=None):
        """The odd kernel's plain version: ``odd_step_plain`` of the buffer's
        interior (whose ``pad_halo`` is the ring the kernel reads)."""
        self._check(fpad, self.padded_shape)
        f2, rho, u = odd_step_plain(self.cfg, self.codes, self.do_coll_codes, self.periodic,
                                    fpad[:, 1:-1, 1:-1], self.map.to(fpad.device), nu,
                                    _force3(force), _u_in3(u_in))
        return (f2, rho, u) if self.with_macro else (f2, None, None)

    def _check(self, f, shape) -> None:
        if tuple(f.shape) != tuple(shape) or not f.is_contiguous():
            raise ValueError(f"expected a contiguous {list(shape)} tensor, got {tuple(f.shape)}")
        if f.dtype != self.cfg.compute_dtype:
            raise ValueError(f"f is {f.dtype}, the pair computes in {self.cfg.compute_dtype}")

    def _launch_prep(self, f, shape):
        if self.device.type != "cuda" or f.device != self.map.device:
            raise ValueError(f"f is on {f.device}, the pair was built for {self.device}")
        self._check(f, shape)
        return load_library(), ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)

    def even_step(self, f, nu, u_in=None, force=None):
        """The even kernel (plain version on CPU tensors): f -> the padded buffer."""
        if f.device.type != "cuda":
            return self.plain_even_step(f, nu, u_in, force)
        lib, stream_ptr = self._launch_prep(f, (self.lat.Q,) + tuple(self.shape))
        X, Y, Z = self.shape
        fpad = torch.empty(self.padded_shape, dtype=f.dtype, device=f.device)
        rc = lib.tnl_lbm_aa_pair_pad_even(f.data_ptr(), fpad.data_ptr(), self.map.data_ptr(),
                                          X, Y, Z, _periodic_bits(self.periodic), self.variant,
                                          float(nu), *_force3(force), *_u_in3(u_in),
                                          int(self.cfg.high_precision_rho), stream_ptr)
        if rc != 0:
            raise RuntimeError(f"{self.even.name} launch failed: CUDA error {rc}")
        self.even.launches += 1
        return fpad

    def odd_step(self, fpad, nu, u_in=None, force=None):
        """The odd kernel (plain version on CPU tensors): the padded buffer
        -> (f2, rho, u)."""
        if fpad.device.type != "cuda":
            return self.plain_odd_step(fpad, nu, u_in, force)
        lib, stream_ptr = self._launch_prep(fpad, self.padded_shape)
        X, Y, Z = self.shape
        f2 = torch.empty((self.lat.Q, X, Y, Z), dtype=fpad.dtype, device=fpad.device)
        rho = u = None
        if self.with_macro:
            rho = torch.empty((X, Y, Z), dtype=fpad.dtype, device=fpad.device)
            u = torch.empty((3, X, Y, Z), dtype=fpad.dtype, device=fpad.device)
        rc = lib.tnl_lbm_aa_pair_pad_odd(fpad.data_ptr(), f2.data_ptr(), self.map.data_ptr(),
                                         None if rho is None else rho.data_ptr(),
                                         None if u is None else u.data_ptr(), X, Y, Z,
                                         _periodic_bits(self.periodic),
                                         int(GEO.NOTHING in self.codes), self.variant, float(nu),
                                         *_force3(force), *_u_in3(u_in),
                                         int(self.cfg.high_precision_rho), stream_ptr)
        if rc != 0:
            raise RuntimeError(f"{self.odd.name} launch failed: CUDA error {rc}")
        self.odd.launches += 1
        return f2, rho, u


def make_fused_pair_aa(cfg: LBMConfig, domain: Domain, device,
                       with_macro: bool = True) -> FusedPairAATwoKernel:
    """Two-kernel A-A pair for (cfg, domain) on ``device``: see
    :class:`FusedPairAATwoKernel`.

    The JAX function's TPU knobs (``tile_even``, ``k_even``, ``tile_odd``,
    ``k_odd``) shape its VMEM tiles and have no counterpart here, nor has
    its ``Z % 128 == 0`` condition (its even kernel's output DMA).
    """
    return FusedPairAATwoKernel(cfg, domain, device, with_macro=with_macro)
