"""The one-kernel non-Newtonian step (B10): u*, strain rate, rheology, NN
force and the full site update in one launch per step.

Counterpart of ``tnl_lbm_tpu/kernels/fused_nn_step.py``
``make_fused_nn_step`` and ``supports``.  :class:`FusedNNStep` launches
``csrc/nn_step.cu`` (the cumulant instances) or ``csrc/nn_coll_*.cu`` (the
other collisions and CUM with eq_entropic, ``kernels/fused.py
step_instance``) - one kernel per mode: A-B, A-A even, A-A odd - on CUDA
tensors, and runs its plain version on CPU tensors: the plain hooked step
(``sim/step.py`` with ``make_nn_forcing_hook(model, periodic=
nn_periodic)``), whose collision takes the body force plus the NN force, as
the kernel's does.  It never runs the plain version in the kernel's place.

The stencil's periodicity (``nn_periodic``) and the domain's are two flags:
the DF reads follow the domain, the u*/S/mask stencil the hook.  The JAX
kernel shares one padded window between them, so ``supports`` requires them
equal on x and y; the port keeps that routing rule.

With ``prepadded`` the step is B10 halo (``csrc/nn_step_halo.cu``), the
sharded NN step's kernel on a shard's block (``parallel/sharded.py
make_sharded_fused_nn_step``): f and the map carry the halo the stencil
chain reads (``HALO_WIDTHS``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from tnl_lbm_tpu_torch.kernels.build import load_library
from tnl_lbm_tpu_torch.kernels.fused import (
    SHARDED_ROADMAP,
    CudaKernel,
    _check_kernel_config,
    _periodic_bits,
    _prep,
    _u_in3,
    check_out,
    family_entry,
    host_vector3,
    into,
    kernel_codes,
    macro_buffers,
    step_instance,
)
from tnl_lbm_tpu_torch.kernels.fused_aa import domain_faces, face_bits
from tnl_lbm_tpu_torch.kernels.fused_nn import nn_bits, rheology_args
from tnl_lbm_tpu_torch.ops import streaming as stream
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.ops.non_newtonian import make_nn_forcing_hook, nn_force_haloed
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.step import as_vector, make_step

#: the ``mode`` of ``tnl_lbm_nn_step`` per (streaming, parity)
_MODES = {("AB", 0): 0, ("AA", 0): 1, ("AA", 1): 2}
#: B10 halo's x/y halo of f and the map per mode (csrc/nn_step.cu
#: NN_HALO_*): F at the sites the mode updates, S one site beyond them, u*
#: two beyond and f as far as u* reads - A-B 3 (u* pulls one more), even 2
#: (u* reads the site itself), odd 4 (the ring around the block collides
#: and pushes into it, so F reaches one site beyond the block)
HALO_WIDTHS = {0: 3, 1: 2, 2: 4}


def supports(cfg: LBMConfig, domain: Domain, nn_periodic) -> bool:
    """True when the single-kernel NN step replaces the three-phase
    pipeline (JAX fused_nn_step.py:64-76): D3Q27, A-B or A-A, the codes of
    the pattern's kernels, and the stencil's wrap equal to the domain's on
    x and y."""
    per = (tuple(bool(p) for p in nn_periodic) if nn_periodic is not None
           else (False, False, False))
    if per[:2] != tuple(bool(p) for p in domain.periodic[:2]):
        return False
    if cfg.lat.D != 3 or cfg.streaming not in ("AB", "AA"):
        return False
    return domain.codes_present() <= kernel_codes(cfg.streaming)


class FusedNNStep:
    """``step(f, nu, u_in=None, force=None, parity=0, out=None, macro_out=None)
    -> (f_new, rho, u)``.

    One hooked step with the non-Newtonian force of ``model`` (stencil
    periodicity ``nn_periodic``), out of place in every mode: into a new
    tensor or into ``out`` (a second state buffer, not ``f``); rho and u
    into new tensors or into ``macro_out`` (a pair of buffers).  ``force``
    and ``u_in`` are homogeneous [3] host vectors; a per-site force raises
    (the hooked pipeline takes one).  ``ab``, ``even`` and ``odd`` count
    the launches, ``plain_calls`` the CPU-path calls.

    ``prepadded=True`` is B10 halo, the step on a shard's block of
    ``local_shape``: f is the block with the mode's x/y halo (``halo_width``)
    and the call gives the block's map with the same halo (``map_pad_in``,
    uint8) and its six face flags (``bflags``); the step writes the block's
    f (into ``out``, [27, X, Y, Z]), rho and u.  The cumulant instances
    only; the others raise naming ROADMAP A13b.
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, model, nn_periodic, device,
                 prepadded: bool = False, local_shape=None):
        hook = cfg.forcing_hook
        if hook is not None and getattr(hook, "nn_model", None) is None:
            raise ValueError("the NN step computes a make_nn_forcing_hook hook, not this one")
        self.nn_periodic = None if nn_periodic is None else tuple(bool(p) for p in nn_periodic)
        if not supports(cfg, domain, self.nn_periodic):
            raise NotImplementedError("the single-kernel NN step needs D3Q27, the kernel codes "
                                      "of the pattern and the stencil's x/y wrap equal to the "
                                      "domain's (else the hooked pipeline runs)")
        plain_cfg = dataclasses.replace(cfg, forcing_hook=None)
        self.lat, self.codes, _ = _prep(plain_cfg, domain)
        rheology_args(model, 0.0)  # refuses another model at build time
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.prepadded = prepadded
        self.shape = tuple(local_shape) if local_shape is not None else domain.shape
        self.domain = domain
        self.periodic = domain.periodic
        self.streaming = cfg.streaming
        self._plain_cfg = plain_cfg
        self._plain_step = make_step(dataclasses.replace(
            cfg, forcing_hook=make_nn_forcing_hook(model, periodic=self.nn_periodic)), domain)
        source = "tnl_lbm_tpu_torch/csrc/" + ("nn_step_halo.cu" if prepadded else "nn_step.cu")
        replaces = "tnl_lbm_tpu/kernels/fused_nn_step.py:522"
        tag = "nn_step_halo" if prepadded else "nn_step"
        self.ab = CudaKernel(f"{tag}_ab", source, replaces)
        self.even = CudaKernel(f"{tag}_even", source, replaces)
        self.odd = CudaKernel(f"{tag}_odd", source, replaces)
        self.plain_calls = 0
        self._instance = step_instance(plain_cfg, "the one-kernel NN step (B10)")
        #: the C variant of a cumulant instance (None for a family instance)
        self._variant = self._instance[1] if self._instance[0] == "cum" else None
        if prepadded and self._variant is None:
            raise NotImplementedError(
                f"the sharded one-kernel NN step (B10 on a haloed block) has the cumulant "
                f"instances (CUM_WELL; CUM with eq_quadratic or eq_inv_cum) only "
                f"({SHARDED_ROADMAP})")
        if self.device.type == "cuda":
            _check_kernel_config(plain_cfg, domain, self.device, "the one-kernel NN step (B10)")
        self.map = (None if prepadded else
                    torch.as_tensor(np.ascontiguousarray(domain.map, np.uint8), device=self.device))
        self._halo_steps = {}  # (local shape) -> the plain step without the hook, haloed plain

    def reset_counts(self) -> None:
        self.ab.launches = self.even.launches = self.odd.launches = self.plain_calls = 0

    def halo_width(self, parity: int = 0) -> int:
        """The x/y halo of f and the map that the haloed step reads at ``parity``."""
        return HALO_WIDTHS[_MODES[(self.streaming, parity if self.streaming == "AA" else 0)]]

    def __call__(self, f, nu, u_in=None, force=None, parity: int = 0, out=None,
                 macro_out=None, map_pad_in=None, bflags=None):
        parity = parity if self.streaming == "AA" else 0
        # a homogeneous [3] force only (JAX fused_nn_step.py:589-590)
        fvec = host_vector3(force, "force", "the hooked pipeline takes one")
        uvec = _u_in3(u_in)
        if self.prepadded:
            mpad, closed = self._halo_args(f, out, parity, map_pad_in, bflags)
            if f.device.type == "cuda":
                return self._launch(f, float(nu), fvec, uvec, parity, out, macro_out, mpad,
                                    face_bits(closed))
            self.plain_calls += 1
            f_new, rho, u = self._plain_halo(f, nu, u_in, force, parity, mpad, closed)
            if out is not None:
                f_new = out.copy_(f_new)
            return (f_new, *into(macro_out, rho, u))
        check_out(out, f)
        if f.device.type == "cuda":
            return self._launch(f, float(nu), fvec, uvec, parity, out, macro_out)
        self.plain_calls += 1
        f_new, rho, u = self.plain(f, nu, u_in=u_in, force=force, parity=parity)
        if out is not None:
            f_new = out.copy_(f_new)
        return (f_new, *into(macro_out, rho, u))

    def plain(self, f, nu, u_in=None, force=None, parity: int = 0, map_pad_in=None,
              bflags=None):
        """The plain hooked step on f's device: (f_new, rho, u), f
        untouched; it counts no call.  Haloed: the same on the block from
        its halo (``_plain_halo``)."""
        parity = parity if self.streaming == "AA" else 0
        if self.prepadded:
            mpad, closed = self._halo_args(f, None, parity, map_pad_in, bflags)
            return self._plain_halo(f, nu, u_in, force, parity, mpad, closed)
        return self._plain_step(f, nu, u_in=u_in, force=force, parity=parity)

    def _halo_args(self, f, out, parity, mpad, bflags):
        """(the haloed map, the closed faces) of a haloed call, its inputs checked."""
        X, Y, Z = self.shape
        H = self.halo_width(parity)
        want = (X + 2 * H, Y + 2 * H, Z)
        if tuple(f.shape) != (self.lat.Q,) + want or not f.is_contiguous():
            raise ValueError(f"f must be a contiguous {[self.lat.Q, *want]} block with its "
                             f"{H}-wide halo, got {tuple(f.shape)}")
        if (not torch.is_tensor(mpad) or mpad.dtype != torch.uint8 or mpad.device != f.device
                or tuple(mpad.shape) != want or not mpad.is_contiguous()):
            raise ValueError(f"the haloed NN step takes the block's map with its {H}-wide halo "
                             f"at each call: map_pad_in, a contiguous uint8 {list(want)} tensor "
                             f"on {f.device}")
        if out is not None and (tuple(out.shape) != (self.lat.Q, X, Y, Z) or out.dtype != f.dtype
                                or out.device != f.device or not out.is_contiguous()):
            raise ValueError("out must be a contiguous state block of the local shape")
        return mpad, domain_faces(bflags, self.periodic)

    def _local_step(self, shape):
        """The plain step without the hook on a region of ``shape``."""
        step = self._halo_steps.get(shape)
        if step is None:
            step = self._halo_steps[shape] = make_step(self._plain_cfg, self.domain,
                                                       local_shape=shape)
        return step

    def _plain_halo(self, f, nu, u_in, force, parity, mpad, closed):
        """The haloed step in plain PyTorch, the plain hooked step's
        arithmetic site by site: u* on the block and the sites within E = R
        + 2 of it (R = 1 on the odd step, whose ring around the block
        collides and pushes into it, else 0), the hook on the block and its
        R-ring (``nn_force_haloed``, clamped on the closed faces), then the
        collision of those sites with the body force plus the hook's and the
        mode's write: the block's (f_new, rho, u)."""
        X, Y, Z = self.shape
        mode = _MODES[(self.streaming, parity)]
        H, R = HALO_WIDTHS[mode], int(mode == 2)
        E = R + 2
        pz = (True, True, self.periodic[2])
        m = mpad.to(torch.int64)

        def zpad(t):
            return stream.pad_halo(t, pz)[:, 1:-1, 1:-1]

        def inner(t, k):  # t without its k outer x/y layers, contiguous (as the plain step's
            # inputs are: a strided sum may add in another order)
            return t[..., k:t.shape[-3] - k, k:t.shape[-2] - k, :].contiguous()

        pull = mode != 1
        shape_u = (X + 2 * E, Y + 2 * E, Z)
        rho0, u0, fluid = self._local_step(shape_u).ustar(
            inner(f, H - E), force=force, parity=parity, map_arr=inner(m, H - E),
            fpad=zpad(f) if pull else None)
        F = nn_force_haloed(self.model, inner(rho0, E - R), u0, nu, fluid, closed,
                            bool(self.nn_periodic[2]) if self.nn_periodic else False, ring=R)
        total = F if force is None else as_vector(self.lat, force, F.dtype, F.device) + F
        shape_c = (X + 2 * R, Y + 2 * R, Z)
        fc = inner(f, H - R)
        step = self._local_step(shape_c)
        f_post, rho, u, masks = step.collide(fc, nu, u_in=u_in, force=total, parity=parity,
                                             map_arr=inner(m, H - R),
                                             fpad=zpad(inner(f, H - R - 1)) if pull else None)
        if mode != 2:
            return step.stream_out(fc, f_post, masks, parity), rho, u
        # the odd push: on a closed face the ring's layer is the edge's
        # (the unsharded edge replication), then the pull of the ring block
        xl, xh, yl, yh = closed
        if xl:
            f_post[:, 0] = f_post[:, 1]
        if xh:
            f_post[:, -1] = f_post[:, -2]
        if yl:
            f_post[:, :, 0] = f_post[:, :, 1]
        if yh:
            f_post[:, :, -1] = f_post[:, :, -2]
        pushed = stream.pull(self.lat, zpad(f_post), (X, Y, Z))
        if GEO.NOTHING in self.codes:
            pushed = torch.where(inner(m, H) == int(GEO.NOTHING), inner(f, H), pushed)
        return pushed.contiguous(), rho[1:-1, 1:-1], u[:, 1:-1, 1:-1]

    def _launch(self, f, nu, fvec, uvec, parity, out, macro_out, mpad=None, gbits: int = 0):
        m = self.map if mpad is None else mpad
        if self.device.type != "cuda" or f.device != m.device:
            raise ValueError(f"f is on {f.device}, the step was built for {self.device}")
        if f.dtype != torch.float32:
            raise NotImplementedError("the CUDA kernels take float32 state only")
        X, Y, Z = self.shape
        if not self.prepadded and (tuple(f.shape) != (self.lat.Q, X, Y, Z)
                                   or not f.is_contiguous()):
            raise ValueError(f"f must be a contiguous [{self.lat.Q}, {X}, {Y}, {Z}] tensor, "
                             f"got {tuple(f.shape)}")
        lib = load_library()
        f_new = (torch.empty((self.lat.Q, X, Y, Z), dtype=f.dtype, device=f.device)
                 if out is None else out)
        rho, u = macro_buffers(macro_out, (X, Y, Z), 3, f.dtype, f.device)
        mode = _MODES[(self.streaming, parity)]
        stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
        kind, nu32, *consts = rheology_args(self.model, nu)
        ptrs = (f.data_ptr(), f_new.data_ptr(), m.data_ptr(), rho.data_ptr(), u.data_ptr())
        bits = (X, Y, Z, _periodic_bits(self.periodic), nn_bits(self.nn_periodic),
                int(GEO.NOTHING in self.codes))
        tail = (nu32, *fvec, *uvec, int(self.cfg.high_precision_rho), kind, *consts, stream_ptr)
        if self.prepadded:
            rc = lib.tnl_lbm_nn_step_halo(*ptrs, *bits[:5], gbits, bits[5], self._variant, mode,
                                          *tail)
        elif self._variant is not None:
            rc = lib.tnl_lbm_nn_step(*ptrs, *bits, self._variant, mode, *tail)
        else:
            _, index, eq_code, kbc = self._instance
            rc = getattr(lib, family_entry(self._instance, "nn"))(mode, index, eq_code, kbc,
                                                                  *ptrs, *bits, *tail)
        kernel = (self.ab, self.even, self.odd)[mode]
        if rc != 0:
            raise RuntimeError(f"{kernel.name} launch failed: CUDA error {rc}")
        kernel.launches += 1
        return f_new, rho, u


def make_fused_nn_step(cfg: LBMConfig, domain: Domain, model, nn_periodic, device,
                       with_macro: bool = True, prepadded: bool = False,
                       local_shape=None) -> FusedNNStep:
    """Single-kernel NN step for (cfg, domain) on ``device``: see
    :class:`FusedNNStep`; ``prepadded`` (with the block's ``local_shape``)
    is B10 halo.  The JAX function's TPU knobs (``tile``,
    ``tiles_per_program``, ``vmem_budget``) shape its VMEM windows and have
    no counterpart here.  Not ported yet: ``with_macro=False`` (ROADMAP
    A7)."""
    if local_shape is not None and not prepadded:
        raise ValueError("local_shape is the haloed block's shape: it needs prepadded=True")
    if not with_macro:
        raise NotImplementedError("with_macro=False is not ported yet (ROADMAP A7)")
    return FusedNNStep(cfg, domain, model, nn_periodic, device, prepadded=prepadded,
                       local_shape=local_shape)
