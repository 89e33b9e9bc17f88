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
                    u_in=(0.0, 0.0, 0.0)):
    """A-A even step in plain PyTorch: returns (f_new, rho, u), f untouched.
    ``force`` and ``u_in`` are 3 scalars each."""
    opp = np.asarray(cfg.lat.opp)

    def shifted(q, offs):
        del offs  # no streaming on the even step: every pull rule reads the site
        return f[q]

    return _stream_bc_collide(cfg.lat, cfg, codes, do_coll_codes, shifted, m, nu, force,
                              u_in=u_in, out_perm=opp)


def odd_step_plain(cfg: LBMConfig, codes, do_coll_codes, periodic, f, m, nu, force,
                   u_in=(0.0, 0.0, 0.0)):
    """A-A odd step in plain PyTorch: returns (f_new, rho, u), f untouched."""
    lat = cfg.lat
    opp = np.asarray(lat.opp)
    S = tuple(f.shape[1:])
    fpad = stream.pad_halo(f, periodic)

    def shifted(q, offs):
        # odd-step read: neighbour, opposite direction (streaming_AA.h:47-60)
        return stream._shift_slices(fpad[int(opp[q])], offs, S)

    f_post, rho, u = _stream_bc_collide(lat, cfg, codes, do_coll_codes, shifted, m, nu, force,
                                        u_in=u_in, defer_nothing=True)
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
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, device, lean: bool = True):
        if cfg.streaming != "AA":
            raise ValueError("make_fused_step_aa needs streaming='AA'")
        self.cfg = cfg
        self.device = torch.device(device)
        self.lat, self.codes, self.do_coll_codes = _prep(cfg, domain)
        self.shape = domain.shape
        self.periodic = domain.periodic
        self.even = CudaKernel("aa_even", "tnl_lbm_tpu_torch/csrc/aa_even.cu",
                               "tnl_lbm_tpu/kernels/fused_aa.py:408")
        self.odd = CudaKernel("aa_odd", "tnl_lbm_tpu_torch/csrc/aa_odd.cu",
                              "tnl_lbm_tpu/kernels/fused_aa.py:287")
        self.plain_calls = 0
        if self.device.type == "cuda":
            _check_kernel_config(cfg, domain, self.device)
            self.variant = aa_variant(cfg, self.codes, lean)
        self.map = torch.as_tensor(np.ascontiguousarray(domain.map, np.uint8), device=self.device)

    def reset_counts(self) -> None:
        self.even.launches = self.odd.launches = self.plain_calls = 0

    def __call__(self, f, nu, u_in=None, force=None, parity: int = 0):
        uvec, fvec = _u_in3(u_in), _force3(force)
        if f.device.type == "cuda":
            return self._launch(f, float(nu), fvec, uvec, parity)
        self.plain_calls += 1
        f_new, rho, u = self._plain(f, nu, fvec, uvec, parity)
        if parity == 0:
            f.copy_(f_new)
            return f, rho, u
        return f_new, rho, u

    def plain(self, f, nu, u_in=None, force=None, parity: int = 0):
        """The step's plain PyTorch version on f's device: (f_new, rho, u),
        f untouched.  The CPU path, and the oracle the kernels are held
        against on the card; it counts no call."""
        return self._plain(f, nu, _force3(force), _u_in3(u_in), parity)

    def _plain(self, f, nu, fvec, uvec, parity):
        m = self.map.to(f.device)
        if parity == 0:
            return even_step_plain(self.cfg, self.codes, self.do_coll_codes, f, m, nu, fvec,
                                   uvec)
        return odd_step_plain(self.cfg, self.codes, self.do_coll_codes, self.periodic,
                              f, m, nu, fvec, uvec)

    def _launch(self, f, nu, fvec, uvec, parity):
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
        if parity == 0:
            rc = lib.tnl_lbm_aa_even(f.data_ptr(), self.map.data_ptr(), rho.data_ptr(),
                                     u.data_ptr(), X, Y, Z, self.variant, nu, *fvec, *uvec,
                                     neumaier, stream_ptr)
            kernel, f_new = self.even, f
        else:
            f_new = torch.empty_like(f)
            rc = lib.tnl_lbm_aa_odd(f.data_ptr(), f_new.data_ptr(), self.map.data_ptr(),
                                    rho.data_ptr(), u.data_ptr(), X, Y, Z,
                                    _periodic_bits(self.periodic),
                                    int(GEO.NOTHING in self.codes), self.variant, nu, *fvec,
                                    *uvec, neumaier, stream_ptr)
            kernel = self.odd
        if rc != 0:
            raise RuntimeError(f"{kernel.name} launch failed: CUDA error {rc}")
        kernel.launches += 1
        return f_new, rho, u


def make_fused_step_aa(cfg: LBMConfig, domain: Domain, device, force_field: bool = False,
                       macro_only: bool = False, lean: bool = True) -> FusedStepAA:
    """A-A step for (cfg, domain) on ``device``: see :class:`FusedStepAA`.

    The ``force_field`` (per-site force) and ``macro_only`` (u* pre-pass)
    variants of the JAX kernels are not ported yet (ROADMAP A11).
    """
    if force_field or macro_only:
        raise NotImplementedError("force_field / macro_only are not ported yet (ROADMAP A11)")
    return FusedStepAA(cfg, domain, device, lean=lean)


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
