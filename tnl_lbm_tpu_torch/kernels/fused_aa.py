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
  (``csrc/aa_pair.cu``): column tiles march along x, the even output of
  each plane kept on chip in float32 in a ring of the slots later odd pulls
  read, the input planes staged ahead by bulk copies (TMA); the state
  optionally stored in float16 or bfloat16 (half storage, see
  :class:`FusedPairAA`), or computed and stored in float64
  (``csrc/f64_pair.cu``).  It writes a new buffer.
- **full-set pair** (:class:`FusedPairAAFull`, ``csrc/aa_pair_full.cu`` and
  ``csrc/pair_coll_*.cu``): the pair's x-march in one launch over the
  even/odd steps' site updates, with their codes and collisions.

The even and odd steps (also in float64 under CUM_WELL, ``csrc/f64_aa.cu``)
take the A-B step's boundary set but
OUTFLOW_RIGHT_INTERP (JAX ``fused_aa.py`` runs ``_stream_bc_collide`` on the
A-B config) and its collisions (``kernels/fused.py step_instance``):
CUM_WELL, CUM with ``eq_quadratic`` or ``eq_inv_cum``, and in the family
sources (``csrc/coll_*.cu``) the collisions of ``kernels/fused.py
COLLISION_INSTANCES`` and CUM with ``eq_entropic``, in both modes (the step
and force_field).  The pair takes FLUID/WALL/NOTHING and CUM_WELL
(``kernels/fused.py PAIR_CODES``), the full-set pair the even and odd
steps' codes and collisions, in float32; :func:`make_dispatch_pair` picks the
one a run's pair dispatch launches.

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
    F64_INSTANCE,
    F64_ROADMAP,
    HALF_F64_ROADMAP,
    MODE_STEP,
    PAIR_VARIANT,
    PATTERN_EVEN,
    PATTERN_ODD,
    HALO_ODD_VARIANTS,
    PROFILE_ROADMAP,
    SHARDED_ROADMAP,
    _AA_LEAN_VARIANT,
    CudaKernel,
    _described,
    _check_kernel_config,
    _force3,
    _periodic_bits,
    _prep,
    _stream_bc_collide,
    _u_in3,
    aa_variant,
    check_dtype,
    check_force_field,
    check_out,
    check_pair_variant,
    collision_id,
    family_entry,
    into,
    kernel_instance,
    launch_collision,
    macro_buffers,
    site_force,
    step_instance,
    supports,
    variant_key,
    variant_mode,
)
from tnl_lbm_tpu_torch.ops import streaming as stream
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig

#: the pair kernel's y-z column tile of one block and its staged input
#: planes (csrc/pair_march.cuh TY, TZ, NSTAGES)
PAIR_COLUMN = (8, 32)
PAIR_STAGES = 2
#: keys of :meth:`FusedPairAA.geometry` (csrc/aa_pair.cu tnl_lbm_aa_pair_info,
#: csrc/f64_pair.cu tnl_lbm_aa_pair_f64_info)
_GEOMETRY_KEYS = ("smem_bytes", "stages", "ty", "tz", "seg_len", "segments", "columns",
                  "staged", "threads")
#: keys of :meth:`FusedPairAAFull.geometry` (csrc/aa_pair_full.cu tnl_lbm_aa_pair_full_info)
_FULL_GEOMETRY_KEYS = ("smem_bytes", "ring_groups", "ty", "tz", "seg_len", "segments",
                       "columns", "threads")

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


def odd_step_halo_plain(cfg: LBMConfig, codes, do_coll_codes, periodic, fpad, ring, faces, nu,
                        force, u_in=(0.0, 0.0, 0.0)):
    """The A-A odd step on a shard's haloed block in plain PyTorch (B3's
    haloed mode): ``fpad`` is the block with a 2-wide x/y halo [Q, X+4,
    Y+4, Z], ``ring`` the map of the block and its 1-wide ring [X+2, Y+2,
    Z], ``faces`` (x low, x high, y low, y high) the block's faces that are
    non-periodic faces of the domain.  The block and its ring collide from
    the halo; on those faces the ring's post-collision layer becomes the
    edge layer's (the edge replication of the unsharded push); the push
    into the block is then the pull of the ring block, z padded as the
    domain says.  Returns the block's (f_new, rho, u); fpad untouched."""
    lat = cfg.lat
    opp = np.asarray(lat.opp)
    Xr, Yr, Z = ring.shape
    fz = stream.pad_halo(fpad, (True, True, periodic[2]))[:, 1:-1, 1:-1]

    def shifted(q, offs):
        ox, oy, oz = offs
        return fz[int(opp[q]), 1 + ox : 1 + ox + Xr, 1 + oy : 1 + oy + Yr, 1 + oz : 1 + oz + Z]

    f_post, rho, u = _stream_bc_collide(lat, cfg, codes, do_coll_codes, shifted, ring, nu, force,
                                        u_in=u_in, defer_nothing=True)
    xl, xh, yl, yh = faces
    if xl:
        f_post[:, 0] = f_post[:, 1]
    if xh:
        f_post[:, -1] = f_post[:, -2]
    if yl:
        f_post[:, :, 0] = f_post[:, :, 1]
    if yh:
        f_post[:, :, -1] = f_post[:, :, -2]
    post = stream.pad_halo(f_post, (True, True, periodic[2]))[:, 1:-1, 1:-1]
    pushed = stream.pull(lat, post, (Xr - 2, Yr - 2, Z))
    if GEO.NOTHING in codes:
        pushed = torch.where(ring[1:-1, 1:-1] == int(GEO.NOTHING), fpad[:, 2:-2, 2:-2], pushed)
    return pushed, rho[1:-1, 1:-1], u[:, 1:-1, 1:-1]


class FusedStepAA:
    """``step(f, nu, u_in=None, force=None, parity=0, out=None, macro_out=None)
    -> (f, rho, u)``.

    ``parity`` 0 is the even step (in place: the returned f is the input
    tensor, and ``out`` is not used), 1 the odd step (a new tensor, or
    ``out``, a second state buffer).  rho and u go to new tensors, or into
    ``macro_out`` (a pair of buffers).  ``u_in`` and ``force`` are
    homogeneous [3] vectors, given as host values.  ``even`` and ``odd``
    count the kernel launches, ``plain_calls`` the CPU-path calls.
    ``lean=False`` keeps the kernels' full-set CUM_WELL instance on a map of
    FLUID/WALL/NOTHING, where the odd step would take its lean one
    (``kernels/fused.py aa_variant``).  The state computes in the config's
    dtype: float32, or float64 in the CUM_WELL step, full-set and lean
    (``csrc/f64_aa.cu``; the other float64 instances raise on the card
    naming ``F64_ROADMAP``).

    Variants (JAX ``make_fused_step_aa``'s flags), each its own instance of
    both kernels; neither has a lean instance, so CUM_WELL takes the
    full-set one:

    - ``force_field``: ``force`` is a per-site [3, X, Y, Z] float32 tensor on
      f's device plus the [3] host vector ``force_add`` at every site, the
      collision's force too (every collision of ``step_instance``).  The
      odd step collides each site with the force of that site and pushes
      as the plain odd step does, so the edge-replicated layers carry the
      edge site's own post-collision DFs, which reproduces the JAX kernel's
      edge-replicated force ring (``_pad_force_ring``) with no ring tensor;
    - ``macro_only``: the u* pre-pass, ``step(...) -> (rho0, u0)``, the
      parity's read, the WALL swap, the symmetry mirrors and the moments
      with the homogeneous force; f is not written.

    ``prepadded=True`` is the sharded step's (JAX ``make_fused_step_aa``
    with ``prepadded`` and ``local_shape``, its call's ``map_ring_in`` and
    ``bflags``): the even step (B2, unchanged) on a shard's block of
    ``local_shape`` with the block's map (``map_arr_in``, uint8 [X, Y, Z] on
    f's device); the odd step (B3's haloed mode, ``csrc/halo_step.cu``,
    counted by ``odd``) on the block with a 2-wide x/y halo [Q, X+4, Y+4, Z],
    the map of the block and its 1-wide ring (``map_ring_in`` [X+2, Y+2, Z])
    and six face flags (``bflags``: x low, x high, y low, y high, z low, z
    high, 1 where the block holds the domain's face), writing the block.  It
    has the float32 cumulant instances, lean and full set; the rest raises
    naming ``SHARDED_ROADMAP``.
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, device, lean: bool = True,
                 force_field: bool = False, macro_only: bool = False, prepadded: bool = False,
                 local_shape=None):
        if cfg.streaming != "AA":
            raise ValueError("make_fused_step_aa needs streaming='AA'")
        self.cfg = cfg
        self.device = torch.device(device)
        self.lat, self.codes, self.do_coll_codes = _prep(cfg, domain)
        self.prepadded = prepadded
        self.shape = tuple(local_shape) if local_shape is not None else domain.shape
        self.periodic = domain.periodic
        self.force_field, self.macro_only = force_field, macro_only
        self._mode, suffix = variant_mode(force_field, macro_only)
        self.plain_calls = 0
        self._instance = kernel_instance(cfg, force_field, macro_only,
                                         "the A-A even/odd steps (B2, B3)")
        #: the CUM_WELL step, whose instances have float64 ones
        cum_well_step = self._instance == F64_INSTANCE and self._mode == MODE_STEP
        if self._instance[0] == "cum" and not (force_field or macro_only):
            self._instance = ("cum", aa_variant(cfg, self.codes, lean))
        #: the C variant of a cumulant instance, or the id of another collision
        self.variant = self._instance[1] if self._instance[0] == "cum" else collision_id(cfg)
        self._f64 = cfg.compute_dtype == torch.float64 and cum_well_step
        even_src, odd_src, tag = (("f64_aa.cu", "f64_aa.cu", "_f64") if self._f64
                                  else ("aa_even.cu", "aa_odd.cu", ""))
        self.even = CudaKernel("aa_even" + tag + suffix, "tnl_lbm_tpu_torch/csrc/" + even_src,
                               "tnl_lbm_tpu/kernels/fused_aa.py:408")
        if prepadded:
            if (self._mode != MODE_STEP or self._instance[0] != "cum" or self._f64
                    or self.variant not in HALO_ODD_VARIANTS):
                raise NotImplementedError(
                    f"the sharded A-A step (B3 on a haloed block) has the float32 cumulant "
                    f"instances, lean and full set, not {_described(cfg)} in "
                    f"{cfg.compute_dtype}"
                    + (" or the force_field / macro_only variants" if self._mode != MODE_STEP
                       else "") + f" ({SHARDED_ROADMAP})")
            suffix, odd_src = "_halo", "halo_step.cu"
        self.odd = CudaKernel("aa_odd" + tag + suffix, "tnl_lbm_tpu_torch/csrc/" + odd_src,
                              "tnl_lbm_tpu/kernels/fused_aa.py:287")
        if self.device.type == "cuda":
            _check_kernel_config(cfg, domain, self.device, "the A-A even/odd steps (B2, B3)",
                                 f64=cum_well_step)
        self.map = (None if prepadded else
                    torch.as_tensor(np.ascontiguousarray(domain.map, np.uint8), device=self.device))

    def reset_counts(self) -> None:
        self.even.launches = self.odd.launches = self.plain_calls = 0

    def _forces(self, f, force, force_add):
        """(the per-site field or None, the homogeneous three floats)."""
        dt = self.cfg.compute_dtype
        if self.force_field:
            return check_force_field(force, 3, self.shape, f.device), _force3(force_add, dt)
        if force_add is not None:
            raise ValueError("force_add belongs to the force_field variant")
        return None, _force3(force, dt)

    def __call__(self, f, nu, u_in=None, force=None, parity: int = 0, force_add=None,
                 out=None, macro_out=None, map_arr_in=None, map_ring_in=None, bflags=None):
        field, fvec = self._forces(f, force, force_add)
        uvec = _u_in3(u_in, self.cfg.compute_dtype)
        if out is not None and self.macro_only:
            raise ValueError("the u* pass writes no state")
        if self.prepadded and parity == 1:
            return self._odd_halo(f, nu, fvec, uvec, out, macro_out,
                                  self._block_map(f, map_ring_in, 2), bflags)
        m = self._block_map(f, map_arr_in, 0) if self.prepadded else self.map
        check_out(out, f)
        if f.device.type == "cuda":
            return self._launch(f, float(nu), field, fvec, uvec, parity, out, macro_out, m)
        self.plain_calls += 1
        f_new, rho, u = self._plain(f, nu, fvec, uvec, parity, field, m)
        rho, u = into(macro_out, rho, u)
        if self.macro_only:
            return rho, u
        if parity == 0:
            f.copy_(f_new)
            return f, rho, u
        if out is not None:
            f_new = out.copy_(f_new)
        return f_new, rho, u

    def plain(self, f, nu, u_in=None, force=None, parity: int = 0, force_add=None,
              map_arr_in=None, map_ring_in=None, bflags=None):
        """The step's plain PyTorch version on f's device: (f_new, rho, u),
        or (rho0, u0) for the u* pass; f untouched.  The CPU path, and the
        oracle the kernels are held against on the card; it counts no call."""
        field, fvec = self._forces(f, force, force_add)
        uvec = _u_in3(u_in, self.cfg.compute_dtype)
        if self.prepadded and parity == 1:
            self._check_halo(f, None)
            return self._plain_odd_halo(f, nu, fvec, uvec, self._block_map(f, map_ring_in, 2),
                                        bflags)
        m = self._block_map(f, map_arr_in, 0) if self.prepadded else self.map
        f_new, rho, u = self._plain(f, nu, fvec, uvec, parity, field, m)
        return (rho, u) if self.macro_only else (f_new, rho, u)

    def _block_map(self, f, m, ring: int):
        """A haloed call's map: the block's (``ring`` 0) or the block's with
        its 1-wide ring (``ring`` 2), a contiguous uint8 tensor on f's device."""
        want = (self.shape[0] + ring, self.shape[1] + ring, self.shape[2])
        if (not torch.is_tensor(m) or m.dtype != torch.uint8 or m.device != f.device
                or tuple(m.shape) != want or not m.is_contiguous()):
            raise ValueError(f"the haloed step takes the block's map at each call: "
                             f"{'map_ring_in' if ring else 'map_arr_in'}, a contiguous uint8 "
                             f"{list(want)} tensor on {f.device}")
        return m

    def _faces(self, bflags) -> tuple:
        """(x low, x high, y low, y high): the block's faces that are
        non-periodic faces of the domain, from the six ``bflags``."""
        if bflags is None or len(bflags) != 6:
            raise ValueError("the haloed odd step takes six face flags (bflags)")
        return tuple(bool(float(bflags[i]) > 0) and not self.periodic[i // 2] for i in range(4))

    def _check_halo(self, f, out) -> None:
        X, Y, Z = self.shape
        want = (self.lat.Q, X + 4, Y + 4, Z)
        if tuple(f.shape) != want or not f.is_contiguous():
            raise ValueError(f"f must be a contiguous {list(want)} block with its 2-wide halo, "
                             f"got {tuple(f.shape)}")
        if out is not None and (tuple(out.shape) != (self.lat.Q, X, Y, Z) or out.dtype != f.dtype
                                or out.device != f.device or not out.is_contiguous()):
            raise ValueError("out must be a contiguous state block of the local shape")

    def _plain_odd_halo(self, f, nu, fvec, uvec, ring, bflags):
        return odd_step_halo_plain(self.cfg, self.codes, self.do_coll_codes, self.periodic, f,
                                   ring, self._faces(bflags), nu, fvec, uvec)

    def _odd_halo(self, f, nu, fvec, uvec, out, macro_out, ring, bflags):
        """The haloed odd step: its kernel on a CUDA tensor, else its plain version."""
        self._check_halo(f, out)
        faces = self._faces(bflags)
        if f.device.type != "cuda":
            self.plain_calls += 1
            f_new, rho, u = self._plain_odd_halo(f, nu, fvec, uvec, ring, bflags)
            rho, u = into(macro_out, rho, u)
            return (f_new if out is None else out.copy_(f_new)), rho, u
        check_dtype(f, self.cfg)
        X, Y, Z = self.shape
        lib = load_library()
        f_new = (torch.empty((self.lat.Q, X, Y, Z), dtype=f.dtype, device=f.device)
                 if out is None else out)
        rho, u = macro_buffers(macro_out, (X, Y, Z), 3, f.dtype, f.device)
        stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
        gbits = sum(1 << i for i, g in enumerate(faces) if g)
        rc = lib.tnl_lbm_aa_odd_halo(f.data_ptr(), f_new.data_ptr(), ring.data_ptr(),
                                     rho.data_ptr(), u.data_ptr(), X, Y, Z,
                                     int(self.periodic[2]), gbits,
                                     int(GEO.NOTHING in self.codes), self.variant, float(nu),
                                     *fvec, *uvec, int(self.cfg.high_precision_rho), stream_ptr)
        if rc != 0:
            raise RuntimeError(f"{self.odd.name} launch failed: CUDA error {rc}")
        self.odd.launches += 1
        return f_new, rho, u

    def _plain(self, f, nu, fvec, uvec, parity, field=None, m=None):
        m = (self.map if m is None else m).to(f.device)
        force = fvec if field is None else site_force(field, fvec)
        if parity == 0:
            return even_step_plain(self.cfg, self.codes, self.do_coll_codes, f, m, nu, force,
                                   uvec, macro_only=self.macro_only)
        return odd_step_plain(self.cfg, self.codes, self.do_coll_codes, self.periodic,
                              f, m, nu, force, uvec, macro_only=self.macro_only)

    def _launch(self, f, nu, field, fvec, uvec, parity, out, macro_out, m):
        if self.device.type != "cuda" or f.device != m.device:
            raise ValueError(f"f is on {f.device}, the step was built for {self.device}")
        check_dtype(f, self.cfg)
        X, Y, Z = self.shape
        if tuple(f.shape) != (self.lat.Q, X, Y, Z) or not f.is_contiguous():
            raise ValueError(f"f must be a contiguous [{self.lat.Q}, {X}, {Y}, {Z}] tensor, "
                             f"got {tuple(f.shape)}")
        lib = load_library()
        rho, u = macro_buffers(macro_out, (X, Y, Z), 3, f.dtype, f.device)
        stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
        neumaier = int(self.cfg.high_precision_rho)
        ff = None if field is None else field.data_ptr()
        pbits, has_nothing = _periodic_bits(self.periodic), int(GEO.NOTHING in self.codes)
        kernel = self.even if parity == 0 else self.odd
        if parity == 0:
            f_new = f
        else:
            f_new = None if self.macro_only else (torch.empty_like(f) if out is None else out)
        if self._f64:  # the CUM_WELL step, the only float64 instances (_check_kernel_config)
            if parity == 0:
                rc = lib.tnl_lbm_aa_even_f64(f.data_ptr(), m.data_ptr(), rho.data_ptr(),
                                             u.data_ptr(), X, Y, Z, nu, *fvec, *uvec, neumaier,
                                             stream_ptr)
            else:
                rc = lib.tnl_lbm_aa_odd_f64(f.data_ptr(), f_new.data_ptr(), m.data_ptr(),
                                            rho.data_ptr(), u.data_ptr(), X, Y, Z, pbits,
                                            has_nothing, int(self.variant == _AA_LEAN_VARIANT),
                                            nu, *fvec, *uvec, neumaier, stream_ptr)
        elif self._instance[0] != "cum":
            rc = launch_collision(lib, self._instance, PATTERN_EVEN if parity == 0 else PATTERN_ODD,
                                  f, f_new, m, rho, u, self.shape, self.periodic,
                                  has_nothing, nu, fvec, uvec, neumaier, stream_ptr, field)
        elif parity == 0:
            rc = lib.tnl_lbm_aa_even(f.data_ptr(), m.data_ptr(), ff, rho.data_ptr(),
                                     u.data_ptr(), X, Y, Z, self.variant, self._mode, nu, *fvec,
                                     *uvec, neumaier, stream_ptr)
        else:
            rc = lib.tnl_lbm_aa_odd(f.data_ptr(), None if f_new is None else f_new.data_ptr(),
                                    m.data_ptr(), ff, rho.data_ptr(), u.data_ptr(),
                                    X, Y, Z, pbits, has_nothing, self.variant, self._mode,
                                    nu, *fvec, *uvec, neumaier, stream_ptr)
        if rc != 0:
            raise RuntimeError(f"{kernel.name} launch failed: CUDA error {rc}")
        kernel.launches += 1
        return (rho, u) if self.macro_only else (f_new, rho, u)


def make_fused_step_aa(cfg: LBMConfig, domain: Domain, device, force_field: bool = False,
                       macro_only: bool = False, lean: bool = True, prepadded: bool = False,
                       local_shape=None) -> FusedStepAA:
    """A-A step for (cfg, domain) on ``device``: see :class:`FusedStepAA`,
    with its ``force_field`` (per-site force) and ``macro_only`` (u*
    pre-pass) variants, and with ``prepadded`` (and the block's
    ``local_shape``) the sharded step's haloed mode.  The JAX function's
    ``z_halo`` (z-sharded meshes) and force ring are not ported yet
    (ROADMAP A13b)."""
    if local_shape is not None and not prepadded:
        raise ValueError("local_shape is the haloed block's shape: it needs prepadded=True")
    return FusedStepAA(cfg, domain, device, lean=lean, force_field=force_field,
                       macro_only=macro_only, prepadded=prepadded, local_shape=local_shape)


class FusedPairAA:
    """``pair(f, nu, u_in=None, force=None, out=None, macro_out=None) -> (f_new, rho, u)``.

    Two A-A steps, even then odd, from an even parity.  ``f`` is the state
    in the store dtype (``to_storage``); rho and u come from the odd step,
    in the compute dtype (None with ``with_macro=False``), in new tensors
    or in ``macro_out`` (a pair of buffers).  The result goes
    to a new tensor, or into ``out`` (a second state buffer, not ``f``),
    so a caller can ping-pong two buffers.  ``kernel`` counts the launches
    of this store dtype's kernel, ``plain_calls`` the CPU-path calls.

    Half storage (``store_dtype`` float16 or bfloat16, FluidX3D's FP16S):
    the state rests in 16 bits and every operation runs in float32; the
    intermediate between the two steps is never narrowed, and NOTHING sites
    keep their stored bits.  It needs well-conditioned (deviation) DFs.
    A float64 config runs the float64 pair (``csrc/f64_pair.cu``), its state
    stored in float64; 16-bit storage under float64 compute raises on the
    card naming ``HALF_F64_ROADMAP``.

    ``seg_len`` is the x extent each block of the kernel marches (None: the
    kernel's own choice, 32 planes, fewer where the column tiles alone do
    not fill the card); the result does not depend on it.
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, device, store_dtype=None,
                 with_macro: bool = True, seg_len: int | None = None):
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
        if seg_len is not None and seg_len < 1:
            raise ValueError(f"seg_len must be a positive number of x planes, got {seg_len}")
        self.seg_len = seg_len
        self.device = torch.device(device)
        self.lat, self.codes, self.do_coll_codes = _prep(cfg, domain, pair=True)
        check_pair_variant(cfg)
        self.shape = domain.shape
        self.periodic = domain.periodic
        self._f64 = cfg.compute_dtype == torch.float64
        self._store_code, tag = _STORE_CODES.get(store, (None, str(store)))
        source = "aa_pair.cu"
        if self._f64 and store == torch.float64:
            tag, source = "f64", "f64_pair.cu"
        self.kernel = CudaKernel(f"aa_pair_{tag}", "tnl_lbm_tpu_torch/csrc/" + source,
                                 "tnl_lbm_tpu/kernels/fused_aa.py:1115")
        self.plain_calls = 0
        if self.device.type == "cuda":
            if self._f64 and store != torch.float64:
                raise NotImplementedError(
                    f"the A-A pair (B1) has no {store} storage under float64 compute: its "
                    f"float64 instance stores the state in float64 ({HALF_F64_ROADMAP})")
            _check_kernel_config(cfg, domain, self.device, "the A-A pair (B1)", f64=True)
        self.map = torch.as_tensor(np.ascontiguousarray(domain.map, np.uint8), device=self.device)

    def reset_counts(self) -> None:
        self.kernel.launches = self.plain_calls = 0

    def geometry(self) -> dict:
        """The kernel's launch geometry for this shape and store dtype:
        shared memory per block, stages, column tile, x segment length and
        count, column tiles, and whether a 16-byte aligned state is staged
        (CUDA only; the x segment is the kernel's own choice unless
        ``seg_len`` is set)."""
        if self.device.type != "cuda":
            raise ValueError("the pair kernel's geometry exists on a CUDA device only")
        lib = load_library()
        out = (ctypes.c_int * len(_GEOMETRY_KEYS))()
        if self._f64:
            lib.tnl_lbm_aa_pair_f64_info(*self.shape, out)
        else:
            lib.tnl_lbm_aa_pair_info(self._store_code, *self.shape, out)
        geo = dict(zip(_GEOMETRY_KEYS, out))
        if self.seg_len is not None:
            X = self.shape[0]
            geo.update(seg_len=self.seg_len, segments=-(-X // self.seg_len))
        return geo

    def __call__(self, f, nu, u_in=None, force=None, out=None, bflags=None, macro_out=None):
        if bflags is not None:
            raise NotImplementedError("per-shard boundary flags are not ported yet "
                                      "(ROADMAP A13b)")
        if u_in is not None and np.ndim(u_in) > 1:
            raise NotImplementedError(f"the A-A pair (B1) takes no per-site inflow profile "
                                      f"({PROFILE_ROADMAP})")
        check_out(out, f)
        if macro_out is not None and not self.with_macro:
            raise ValueError("a pair built with_macro=False writes no rho and u")
        if f.dtype != self.store_dtype:
            raise ValueError(f"f is {f.dtype}, the pair stores {self.store_dtype}")
        if f.device.type == "cuda":
            return self._launch(f, float(nu), _force3(force, self.cfg.compute_dtype), out,
                                macro_out)
        self.plain_calls += 1
        f_new, rho, u = self.plain(f, nu, force=force)
        if out is not None:
            f_new = out.copy_(f_new)
        if self.with_macro:
            rho, u = into(macro_out, rho, u)
        return f_new, rho, u

    def plain(self, f, nu, force=None):
        """The pair's plain PyTorch version on f's device: the odd step of
        the even step of the widened state, narrowed (f untouched, no call
        counted)."""
        fvec = _force3(force, self.cfg.compute_dtype)
        m = self.map.to(f.device)
        fw = from_storage(f, self.cfg.compute_dtype)
        ev, _, _ = even_step_plain(self.cfg, self.codes, self.do_coll_codes, fw, m, nu, fvec)
        f_new, rho, u = odd_step_plain(self.cfg, self.codes, self.do_coll_codes, self.periodic,
                                       ev, m, nu, fvec)
        f_new = to_storage(f_new, self.store_dtype)
        return (f_new, rho, u) if self.with_macro else (f_new, None, None)

    def _launch(self, f, nu, fvec, out, macro_out):
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
            rho, u = macro_buffers(macro_out, (X, Y, Z), 3, self.cfg.compute_dtype, f.device)
        stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
        ptrs = (f.data_ptr(), f_new.data_ptr(), self.map.data_ptr(),
                rho.data_ptr() if rho is not None else None,
                u.data_ptr() if u is not None else None, X, Y, Z,
                _periodic_bits(self.periodic), int(GEO.NOTHING in self.codes),
                int(self.with_macro))
        neumaier = int(self.cfg.high_precision_rho)
        if self._f64:  # stored in float64 (the constructor refused 16-bit storage)
            rc = lib.tnl_lbm_aa_pair_f64(*ptrs, nu, *fvec, neumaier, self.seg_len or 0,
                                         stream_ptr)
        elif self.seg_len is None:
            rc = lib.tnl_lbm_aa_pair(*ptrs, self._store_code, nu, *fvec, neumaier, stream_ptr)
        else:
            rc = lib.tnl_lbm_aa_pair_segmented(*ptrs, self._store_code, nu, *fvec, neumaier,
                                               self.seg_len, stream_ptr)
        if rc != 0:
            raise RuntimeError(f"{self.kernel.name} launch failed: CUDA error {rc}")
        self.kernel.launches += 1
        return f_new, rho, u


def make_fused_pair2_aa(cfg: LBMConfig, domain: Domain, device, store_dtype=None,
                        with_macro: bool = True, *, local_shape=None, prepadded: bool = False,
                        z_halo: int = 0, seg_len: int | None = None) -> FusedPairAA:
    """One-kernel A-A pair for (cfg, domain) on ``device``: see :class:`FusedPairAA`
    (``seg_len``: the kernel's x segment, a knob of the port's own).

    The JAX function's TPU knobs (``tile``, ``tiles_per_program``, ``window``,
    ``map_mode``, ``zprofile``, ``even_band``, ``vmem_limit_mb``,
    ``_debug_dma``) shape its padded VMEM pipeline and have no counterpart
    here; its sharded knobs (``local_shape``, ``prepadded``, ``z_halo`` and
    the call's ``bflags``) are not ported yet (ROADMAP A13b).
    """
    if local_shape is not None or prepadded or z_halo:
        raise NotImplementedError("the sharded pair (local_shape, prepadded, z_halo) is not "
                                  "ported yet (ROADMAP A13b)")
    return FusedPairAA(cfg, domain, device, store_dtype=store_dtype, with_macro=with_macro,
                       seg_len=seg_len)


class FusedPairAAFull:
    """``pair(f, nu, u_in=None, force=None, out=None, macro_out=None) -> (f2, rho, u)``:
    two A-A steps, even then odd, in one launch with the A-A steps' codes
    and variants (JAX ``make_fused_pair_aa``, B1b).

    The kernel (``csrc/aa_pair_full.cu``) is the one-kernel pair's x-march
    (``csrc/pair_march.cuh``) over the even and odd steps' site updates: the
    even output stays on chip, and an OUTFLOW_RIGHT site's pull of every
    component from x - 1 reads the ring's whole previous plane.  rho and u
    come from the odd step (None with ``with_macro=False``), in new tensors
    or in ``macro_out`` (a pair of buffers); f2 goes to a new tensor or into
    ``out`` (a second state buffer, not ``f``, which is never written), so
    a caller can ping-pong two buffers and a CUDA graph replay the launch
    on fixed ones.  ``u_in`` and ``force`` are homogeneous [3] vectors given
    as host values.  The codes and collisions are the A-A even/odd steps'
    (all but OUTFLOW_RIGHT_INTERP; ``kernels/fused.py step_instance``: the
    cumulant instances in ``csrc/aa_pair_full.cu``, the rest in the family
    sources ``csrc/pair_coll_*.cu``); on a map of FLUID, WALL and NOTHING
    CUM_WELL runs the lean instance.  ``variant`` is the C variant of a
    cumulant instance (a caller may set it to another one before a launch)
    or the collision's id.  ``kernel`` counts the launches,
    ``plain_calls`` the CPU-path calls; ``seg_len`` is the x extent each
    block marches (None: the kernel's own choice), which the result does not
    depend on.
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, device, with_macro: bool = True,
                 seg_len: int | None = None):
        if cfg.streaming != "AA":
            raise ValueError("make_fused_pair_aa needs streaming='AA'")
        if seg_len is not None and seg_len < 1:
            raise ValueError(f"seg_len must be a positive number of x planes, got {seg_len}")
        self.cfg = cfg
        self.with_macro = with_macro
        self.seg_len = seg_len
        self.device = torch.device(device)
        self.lat, self.codes, self.do_coll_codes = _prep(cfg, domain)
        self.shape = domain.shape
        self.periodic = domain.periodic
        self.kernel = CudaKernel("aa_pair_full", "tnl_lbm_tpu_torch/csrc/aa_pair_full.cu",
                                 "tnl_lbm_tpu/kernels/fused_aa.py:1274")
        self.plain_calls = 0
        self._instance = step_instance(cfg, "the full-set A-A pair (B1b)")
        self.variant = (aa_variant(cfg, self.codes) if self._instance[0] == "cum"
                        else collision_id(cfg))
        if self.device.type == "cuda":
            _check_kernel_config(cfg, domain, self.device, "the full-set A-A pair (B1b)")
        self.map = torch.as_tensor(np.ascontiguousarray(domain.map, np.uint8), device=self.device)

    def reset_counts(self) -> None:
        self.kernel.launches = self.plain_calls = 0

    def geometry(self) -> dict:
        """The kernel's launch geometry for this shape and instance: shared
        memory per block, ring groups, column tile, x segment length and
        count, column tiles and threads per block (CUDA only)."""
        if self.device.type != "cuda":
            raise ValueError("the pair kernel's geometry exists on a CUDA device only")
        out = (ctypes.c_int * len(_FULL_GEOMETRY_KEYS))()
        # a family instance has the full-set cumulant instances' geometry
        variant = self.variant if self._instance[0] == "cum" else 0
        rc = load_library().tnl_lbm_aa_pair_full_info(variant, *self.shape, out)
        if rc != 0:
            raise RuntimeError(f"tnl_lbm_aa_pair_full_info failed: CUDA error {rc}")
        geo = dict(zip(_FULL_GEOMETRY_KEYS, out))
        if self.seg_len is not None:
            geo.update(seg_len=self.seg_len, segments=-(-self.shape[0] // self.seg_len))
        return geo

    def __call__(self, f, nu, u_in=None, force=None, out=None, macro_out=None):
        dt = self.cfg.compute_dtype
        uvec, fvec = _u_in3(u_in, dt), _force3(force, dt)
        self._check(f)
        check_out(out, f)
        if macro_out is not None and not self.with_macro:
            raise ValueError("a pair built with_macro=False writes no rho and u")
        if f.device.type == "cuda":
            return self._launch(f, float(nu), uvec, fvec, out, macro_out)
        self.plain_calls += 1
        f2, rho, u = self.plain(f, nu, u_in, force)
        if out is not None:
            f2 = out.copy_(f2)
        if self.with_macro:
            rho, u = into(macro_out, rho, u)
        return f2, rho, u

    def plain(self, f, nu, u_in=None, force=None):
        """The pair's plain PyTorch version on f's device: ``even_step_plain``
        then ``odd_step_plain`` on the unpadded state; f untouched, no call
        counted."""
        self._check(f)
        m = self.map.to(f.device)
        dt = self.cfg.compute_dtype
        uvec, fvec = _u_in3(u_in, dt), _force3(force, dt)
        ev, _, _ = even_step_plain(self.cfg, self.codes, self.do_coll_codes, f, m, nu, fvec, uvec)
        f2, rho, u = odd_step_plain(self.cfg, self.codes, self.do_coll_codes, self.periodic, ev,
                                    m, nu, fvec, uvec)
        return (f2, rho, u) if self.with_macro else (f2, None, None)

    def _check(self, f) -> None:
        shape = (self.lat.Q,) + tuple(self.shape)
        if tuple(f.shape) != shape or not f.is_contiguous():
            raise ValueError(f"expected a contiguous {list(shape)} tensor, got {tuple(f.shape)}")
        if f.dtype != self.cfg.compute_dtype:
            raise ValueError(f"f is {f.dtype}, the pair computes in {self.cfg.compute_dtype}")

    def _launch(self, f, nu, uvec, fvec, out, macro_out):
        if self.device.type != "cuda" or f.device != self.map.device:
            raise ValueError(f"f is on {f.device}, the pair was built for {self.device}")
        X, Y, Z = self.shape
        f2 = torch.empty_like(f) if out is None else out
        rho = u = None
        if self.with_macro:
            rho, u = macro_buffers(macro_out, (X, Y, Z), 3, f.dtype, f.device)
        lib = load_library()
        ptrs = (f.data_ptr(), f2.data_ptr(), self.map.data_ptr(),
                None if rho is None else rho.data_ptr(), None if u is None else u.data_ptr())
        rest = (X, Y, Z, _periodic_bits(self.periodic), int(GEO.NOTHING in self.codes),
                int(self.with_macro))
        tail = (*fvec, *uvec, int(self.cfg.high_precision_rho), self.seg_len or 0,
                ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream))
        if self._instance[0] == "cum":
            rc = lib.tnl_lbm_aa_pair_full(*ptrs, *rest, self.variant, nu, *tail)
        else:
            _, index, eq_code, kbc = self._instance
            rc = getattr(lib, family_entry(self._instance, "pair"))(
                index, eq_code, kbc, *ptrs, *rest, nu, *tail)
        if rc != 0:
            raise RuntimeError(f"{self.kernel.name} launch failed: CUDA error {rc}")
        self.kernel.launches += 1
        return f2, rho, u


def make_fused_pair_aa(cfg: LBMConfig, domain: Domain, device, with_macro: bool = True,
                       seg_len: int | None = None) -> FusedPairAAFull:
    """The A-A pair with the A-A steps' codes for (cfg, domain) on
    ``device``, one launch per pair: see :class:`FusedPairAAFull`
    (``seg_len``: the kernel's x segment, a knob of the port's own).

    The JAX function's TPU knobs (``tile_even``, ``k_even``, ``tile_odd``,
    ``k_odd``) shape its VMEM tiles and have no counterpart here, nor has
    its ``Z % 128 == 0`` condition (its even kernel's output DMA).
    """
    return FusedPairAAFull(cfg, domain, device, with_macro=with_macro, seg_len=seg_len)


def dispatch_pair_kind(cfg: LBMConfig, domain: Domain, store_dtype=None) -> str:
    """Which pair kernel pair dispatch runs for (cfg, domain): "B1" (the
    one-kernel pair) on a map of FLUID/WALL/NOTHING under its one instance
    (``PAIR_VARIANT``), in any store dtype under float32 compute and stored
    in float64 under float64 compute; "B1b" (the full-set pair) for every
    other config of ``step_instance`` on an A-A map, in float32.  A config
    neither has an instance of raises NotImplementedError, naming its
    ROADMAP item (16-bit storage under float64: ``HALF_F64_ROADMAP``;
    float64 on B1b's maps and collisions: ``F64_ROADMAP``).  Decided from
    the config and the map, on any device; nothing is built."""
    if variant_key(cfg) == PAIR_VARIANT and supports(domain, "AA", pair=True):
        if (cfg.compute_dtype == torch.float64 and store_dtype is not None
                and store_dtype != torch.float64):
            raise NotImplementedError(
                f"16-bit storage under float64 compute: the A-A pair (B1) stores a float64 "
                f"state in float64 ({HALF_F64_ROADMAP})")
        return "B1"
    if store_dtype is not None and store_dtype != cfg.compute_dtype:
        raise NotImplementedError(
            "half storage runs through the one-kernel pair, which takes FLUID, WALL and "
            "NOTHING under CUM_WELL; the full-set pair (B1b) that takes this map or "
            "collision has float32 instances only (16-bit B1b instances: ROADMAP B1h)")
    step_instance(cfg, "the full-set A-A pair (B1b)")
    if cfg.compute_dtype != torch.float32:
        raise NotImplementedError(f"the full-set pair (B1b) computes in float32 only: its "
                                  f"float64 instances are {F64_ROADMAP}")
    return "B1b"


def make_dispatch_pair(cfg: LBMConfig, domain: Domain, device, store_dtype=None):
    """The pair kernel that ``Simulation``'s pair dispatch runs for (cfg,
    domain), as :func:`dispatch_pair_kind` picks it: the one-kernel pair
    (B1, :func:`make_fused_pair2_aa`) or the full-set pair (B1b,
    :func:`make_fused_pair_aa`).  The JAX package's pair takes every A-A map
    but OUTFLOW_RIGHT_INTERP under every collision, and so do the two
    together in float32; a config neither kernel has an instance of raises,
    on any device."""
    if dispatch_pair_kind(cfg, domain, store_dtype) == "B1":
        return make_fused_pair2_aa(cfg, domain, device, store_dtype=store_dtype)
    return make_fused_pair_aa(cfg, domain, device)
