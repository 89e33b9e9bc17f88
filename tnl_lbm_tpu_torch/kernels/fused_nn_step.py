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
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from tnl_lbm_tpu_torch.kernels.build import load_library
from tnl_lbm_tpu_torch.kernels.fused import (
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
from tnl_lbm_tpu_torch.kernels.fused_nn import nn_bits, rheology_args
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.ops.non_newtonian import make_nn_forcing_hook
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.step import make_step

#: the ``mode`` of ``tnl_lbm_nn_step`` per (streaming, parity)
_MODES = {("AB", 0): 0, ("AA", 0): 1, ("AA", 1): 2}


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
    """

    def __init__(self, cfg: LBMConfig, domain: Domain, model, nn_periodic, device):
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
        self.shape = domain.shape
        self.periodic = domain.periodic
        self.streaming = cfg.streaming
        self._plain_step = make_step(dataclasses.replace(
            cfg, forcing_hook=make_nn_forcing_hook(model, periodic=self.nn_periodic)), domain)
        source = "tnl_lbm_tpu_torch/csrc/nn_step.cu"
        replaces = "tnl_lbm_tpu/kernels/fused_nn_step.py:522"
        self.ab = CudaKernel("nn_step_ab", source, replaces)
        self.even = CudaKernel("nn_step_even", source, replaces)
        self.odd = CudaKernel("nn_step_odd", source, replaces)
        self.plain_calls = 0
        self._instance = step_instance(plain_cfg, "the one-kernel NN step (B10)")
        #: the C variant of a cumulant instance (None for a family instance)
        self._variant = self._instance[1] if self._instance[0] == "cum" else None
        if self.device.type == "cuda":
            _check_kernel_config(plain_cfg, domain, self.device, "the one-kernel NN step (B10)")
        self.map = torch.as_tensor(np.ascontiguousarray(domain.map, np.uint8), device=self.device)

    def reset_counts(self) -> None:
        self.ab.launches = self.even.launches = self.odd.launches = self.plain_calls = 0

    def __call__(self, f, nu, u_in=None, force=None, parity: int = 0, out=None,
                 macro_out=None):
        parity = parity if self.streaming == "AA" else 0
        # a homogeneous [3] force only (JAX fused_nn_step.py:589-590)
        fvec = host_vector3(force, "force", "the hooked pipeline takes one")
        uvec = _u_in3(u_in)
        check_out(out, f)
        if f.device.type == "cuda":
            return self._launch(f, float(nu), fvec, uvec, parity, out, macro_out)
        self.plain_calls += 1
        f_new, rho, u = self.plain(f, nu, u_in=u_in, force=force, parity=parity)
        if out is not None:
            f_new = out.copy_(f_new)
        return (f_new, *into(macro_out, rho, u))

    def plain(self, f, nu, u_in=None, force=None, parity: int = 0):
        """The plain hooked step on f's device: (f_new, rho, u), f
        untouched; it counts no call."""
        return self._plain_step(f, nu, u_in=u_in, force=force,
                                parity=parity if self.streaming == "AA" else 0)

    def _launch(self, f, nu, fvec, uvec, parity, out, macro_out):
        if self.device.type != "cuda" or f.device != self.map.device:
            raise ValueError(f"f is on {f.device}, the step was built for {self.device}")
        if f.dtype != torch.float32:
            raise NotImplementedError("the CUDA kernels take float32 state only")
        X, Y, Z = self.shape
        if tuple(f.shape) != (self.lat.Q, X, Y, Z) or not f.is_contiguous():
            raise ValueError(f"f must be a contiguous [{self.lat.Q}, {X}, {Y}, {Z}] tensor, "
                             f"got {tuple(f.shape)}")
        lib = load_library()
        f_new = torch.empty_like(f) if out is None else out
        rho, u = macro_buffers(macro_out, (X, Y, Z), 3, f.dtype, f.device)
        mode = _MODES[(self.streaming, parity)]
        stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(f.device).cuda_stream)
        kind, nu32, *consts = rheology_args(self.model, nu)
        ptrs = (f.data_ptr(), f_new.data_ptr(), self.map.data_ptr(), rho.data_ptr(),
                u.data_ptr())
        bits = (X, Y, Z, _periodic_bits(self.periodic), nn_bits(self.nn_periodic),
                int(GEO.NOTHING in self.codes))
        tail = (nu32, *fvec, *uvec, int(self.cfg.high_precision_rho), kind, *consts, stream_ptr)
        if self._variant is not None:
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
    :class:`FusedNNStep`.  The JAX function's TPU knobs (``tile``,
    ``tiles_per_program``, ``vmem_budget``) shape its VMEM windows and have
    no counterpart here.  Not ported yet: ``prepadded`` and ``local_shape``
    (the sharded NN step, ROADMAP A13) and ``with_macro=False`` (ROADMAP
    A7)."""
    if prepadded or local_shape is not None:
        raise NotImplementedError("prepadded / local_shape (the sharded NN step) are not "
                                  "ported yet (ROADMAP A13)")
    if not with_macro:
        raise NotImplementedError("with_macro=False is not ported yet (ROADMAP A7)")
    return FusedNNStep(cfg, domain, model, nn_periodic, device)
