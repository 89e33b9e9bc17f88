"""The non-Newtonian force kernel (B9): F = 2 (nu_eff - nu) rho div(S).

Counterpart of ``tnl_lbm_tpu/kernels/fused_nn.py`` ``make_nn_force_kernel``.
:class:`NNForce` launches ``csrc/nn_force.cu`` on CUDA tensors and runs its
plain version on CPU tensors: the forcing hook of ``ops/non_newtonian.py``
on whole tensors, with the fluid mask ``map == FLUID``.  It never runs the
plain version in the kernel's place.  The hook's periodicity is its own
(``periodic``), independent of the domain's: None edge-replicates every
axis, as ``make_nn_forcing_hook`` does.  With ``prepadded`` it is B9 halo,
the force on a shard's block (``csrc/nn_force.cu`` ``nn_force_halo_kernel``;
the sharded pipeline's NN hook, ``parallel/sharded.py make_sharded_nn_force``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tnl_lbm_tpu_torch.kernels.build import load_library
from tnl_lbm_tpu_torch.kernels.fused import _MAX_GRID_YZ, CudaKernel, _periodic_bits
from tnl_lbm_tpu_torch.kernels.fused_aa import domain_faces, face_bits
from tnl_lbm_tpu_torch.models import D3Q27
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.ops.non_newtonian import (
    Casson,
    CarreauYasuda,
    make_nn_forcing_hook,
    nn_force_haloed,
)
from tnl_lbm_tpu_torch.sim.config import Domain

#: the ``model`` codes of the C entries (csrc/nn_site.cuh)
_MODELS = {CarreauYasuda: 0, Casson: 1}
#: keys of :func:`nn_geometry` (csrc/nn_step.cu tnl_lbm_nn_info)
_GEOMETRY_KEYS = ("smem_bytes", "ty", "tz", "seg_len", "segments", "columns", "blocks_per_sm")


def rheology_args(model, nu) -> tuple:
    """(model code, nu, nu0 - nu, lambda, a, (n - 1) / a, k0, k1) for the C
    entries: each constant computed in double, as the plain version's
    Python scalars are, and rounded once to float32."""
    kind = _MODELS.get(type(model))
    if kind is None:
        raise NotImplementedError(f"the NN kernels take CarreauYasuda or Casson, got "
                                  f"{type(model).__name__}")
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    if kind == 0:
        return (kind, f32(nu), f32(model.nu0 - nu), f32(model.lam), f32(model.a),
                f32((model.n - 1) / model.a), 0.0, 0.0)
    return (kind, f32(nu), 0.0, 0.0, 0.0, 0.0, f32(model.k0), f32(model.k1))


def nn_bits(periodic) -> int:
    """The periodic-axis bits of a hook's periodicity (None: none)."""
    return _periodic_bits(periodic or (False, False, False))


def nn_geometry(kind: int, shape) -> dict:
    """The launch geometry of B9 (``kind`` 0) or B10 (1) at ``shape``:
    shared memory per block, column tile, the x segment length and count,
    column tiles and the launch's blocks per SM.  Needs the kernel library
    (a CUDA machine)."""
    lib = load_library()
    out = (ctypes.c_int * len(_GEOMETRY_KEYS))()
    if lib.tnl_lbm_nn_info(kind, *shape, out) != 0:
        raise ValueError(f"kind must be 0 (B9) or 1 (B10), got {kind}")
    return dict(zip(_GEOMETRY_KEYS, out))


class NNForce:
    """``force(rho, u, nu, out=None) -> F [3, X, Y, Z]``: the NN body force of
    a Carreau-Yasuda or Casson ``model`` on a D3Q27 domain, with the stencil
    periodicity ``periodic``, in a new tensor or in ``out``.  ``kernel`` counts the launches,
    ``plain_calls`` the CPU-path calls.

    ``prepadded=True`` is B9 halo, the force on a shard's block of
    ``local_shape`` (JAX: the pipeline's hook on the global arrays, which
    GSPMD partitions): ``u`` is the block's u* with a 2-wide x/y halo [3,
    X+4, Y+4, Z] (S one site beyond the block, from u two beyond), rho the
    block's, and each call gives the block's map with the same halo
    (``map_pad_in``, uint8) and its six face flags (``bflags``); on a face
    of the domain the hook does not wrap the stencils clamp as unsharded,
    elsewhere they read the halo."""

    def __init__(self, model, domain: Domain, device, periodic=None, prepadded: bool = False,
                 local_shape=None):
        if domain.lat.D != 3:
            raise NotImplementedError("the NN force kernel is 3D; a 2D hook runs as plain "
                                      "tensor ops (kernels/hooked.py)")
        rheology_args(model, 0.0)  # refuses another model at build time
        self.model = model
        self.periodic = None if periodic is None else tuple(bool(p) for p in periodic)
        self.device = torch.device(device)
        self.prepadded = prepadded
        self.shape = tuple(local_shape) if local_shape is not None else domain.shape
        self.hook = make_nn_forcing_hook(model, periodic=self.periodic)
        self.kernel = CudaKernel("nn_force_halo" if prepadded else "nn_force",
                                 "tnl_lbm_tpu_torch/csrc/nn_force.cu",
                                 "tnl_lbm_tpu/kernels/fused_nn.py:232")
        self.plain_calls = 0
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {device} requested but no CUDA device is available")
            if self.shape[0] > _MAX_GRID_YZ or self.shape[1] > _MAX_GRID_YZ:
                raise ValueError(f"X and Y must be <= {_MAX_GRID_YZ} for the kernel grid")
        self.map = (None if prepadded else
                    torch.as_tensor(np.ascontiguousarray(domain.map, np.uint8), device=self.device))

    def reset_counts(self) -> None:
        self.kernel.launches = self.plain_calls = 0

    def __call__(self, rho, u, nu, out=None, map_pad_in=None, bflags=None):
        if self.prepadded:
            mpad, closed = self._halo_args(rho, u, map_pad_in, bflags)
            if rho.device.type == "cuda":
                return self._launch(rho, u, float(nu), out, mpad, face_bits(closed))
            self.plain_calls += 1
            F = self._plain_halo(rho, u, nu, mpad, closed)
            return F if out is None else out.copy_(F)
        if rho.device.type == "cuda":
            return self._launch(rho, u, float(nu), out)
        self.plain_calls += 1
        F = self.plain(rho, u, nu)
        return F if out is None else out.copy_(F)

    def plain(self, rho, u, nu, map_pad_in=None, bflags=None):
        """The plain version on rho's device: the forcing hook of
        ``ops/non_newtonian.py`` with the mask ``map == FLUID`` (haloed:
        ``nn_force_haloed`` on the block); it counts no call."""
        if self.prepadded:
            return self._plain_halo(rho, u, nu, *self._halo_args(rho, u, map_pad_in, bflags))
        fluid = self.map.to(rho.device) == int(GEO.FLUID)
        return self.hook(D3Q27, rho, u, nu, fluid)

    def _halo_args(self, rho, u, mpad, bflags):
        """(the haloed map, the closed faces) of a haloed call, its inputs checked."""
        X, Y, Z = self.shape
        want = (X + 4, Y + 4, Z)
        if (not torch.is_tensor(mpad) or mpad.dtype != torch.uint8 or mpad.device != rho.device
                or tuple(mpad.shape) != want or not mpad.is_contiguous()):
            raise ValueError(f"B9 halo takes the block's map with its 2-wide halo at each call: "
                             f"map_pad_in, a contiguous uint8 {list(want)} tensor on {rho.device}")
        if tuple(u.shape) != (3,) + want or tuple(rho.shape) != (X, Y, Z):
            raise ValueError(f"B9 halo takes u [3, {X + 4}, {Y + 4}, {Z}] and rho [{X}, {Y}, "
                             f"{Z}], got {tuple(u.shape)} and {tuple(rho.shape)}")
        # the closed faces: the domain's faces on an axis the hook does not wrap
        return mpad, domain_faces(bflags, self.periodic or (False, False, False))

    def _plain_halo(self, rho, u, nu, mpad, closed):
        per_z = bool(self.periodic[2]) if self.periodic is not None else False
        return nn_force_haloed(self.model, rho, u, nu, mpad == int(GEO.FLUID), closed, per_z)

    def _launch(self, rho, u, nu, out, mpad=None, gbits: int = 0):
        X, Y, Z = self.shape
        m = self.map if mpad is None else mpad
        if rho.device != m.device or u.device != rho.device:
            raise ValueError(f"rho/u are on {rho.device}/{u.device}, the kernel was built for "
                             f"{self.device}")
        ushape = (3, X + 4, Y + 4, Z) if self.prepadded else (3, X, Y, Z)
        for t, shape in ((rho, (X, Y, Z)), (u, ushape)):
            if t.dtype == torch.float64:
                raise NotImplementedError("the NN force kernel (B9) computes in float32 only: "
                                          "its float64 instance is ROADMAP Bf64")
            if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"the NN force kernel takes contiguous float32 {shape} "
                                 f"tensors, got {tuple(t.shape)} {t.dtype}")
        lib = load_library()
        if out is None:
            out = torch.empty((3, X, Y, Z), dtype=torch.float32, device=rho.device)
        elif (tuple(out.shape) != (3, X, Y, Z) or out.dtype != torch.float32
              or out.device != rho.device or not out.is_contiguous()):
            raise ValueError(f"out must be a contiguous float32 (3, {X}, {Y}, {Z}) tensor on "
                             f"{rho.device}")
        stream_ptr = ctypes.c_void_p(torch.cuda.current_stream(rho.device).cuda_stream)
        if self.prepadded:
            rc = lib.tnl_lbm_nn_force_halo(rho.data_ptr(), u.data_ptr(), m.data_ptr(),
                                           out.data_ptr(), X, Y, Z, nn_bits(self.periodic),
                                           gbits, *rheology_args(self.model, nu), stream_ptr)
        else:
            rc = lib.tnl_lbm_nn_force(rho.data_ptr(), u.data_ptr(), m.data_ptr(),
                                      out.data_ptr(), X, Y, Z, nn_bits(self.periodic),
                                      *rheology_args(self.model, nu), stream_ptr)
        if rc != 0:
            raise RuntimeError(f"{self.kernel.name} launch failed: CUDA error {rc}")
        self.kernel.launches += 1
        return out


def make_nn_force_kernel(model, domain: Domain, device, periodic=None, prepadded: bool = False,
                        local_shape=None) -> NNForce:
    """The NN force of ``model`` on ``domain``: see :class:`NNForce`.  The
    JAX function's ``dtype`` is the kernel's float32 and its static
    ``fluid_mask`` is ``map == FLUID``, read by the kernel from the map;
    its TPU knobs (``tile``, ``tiles_per_program``) shape VMEM windows and
    have no counterpart here.  ``prepadded`` (with the block's
    ``local_shape``) is B9 halo."""
    if local_shape is not None and not prepadded:
        raise ValueError("local_shape is the haloed block's shape: it needs prepadded=True")
    return NNForce(model, domain, device, periodic=periodic, prepadded=prepadded,
                   local_shape=local_shape)
