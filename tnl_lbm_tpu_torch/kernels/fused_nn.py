"""The non-Newtonian force kernel (B9): F = 2 (nu_eff - nu) rho div(S).

Counterpart of ``tnl_lbm_tpu/kernels/fused_nn.py`` ``make_nn_force_kernel``.
:class:`NNForce` launches ``csrc/nn_force.cu`` on CUDA tensors and runs its
plain version on CPU tensors: the forcing hook of ``ops/non_newtonian.py``
on whole tensors, with the fluid mask ``map == FLUID``.  It never runs the
plain version in the kernel's place.  The hook's periodicity is its own
(``periodic``), independent of the domain's: None edge-replicates every
axis, as ``make_nn_forcing_hook`` does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tnl_lbm_tpu_torch.kernels.build import load_library
from tnl_lbm_tpu_torch.kernels.fused import _MAX_GRID_YZ, CudaKernel, _periodic_bits
from tnl_lbm_tpu_torch.models import D3Q27
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.ops.non_newtonian import Casson, CarreauYasuda, make_nn_forcing_hook
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
    ``plain_calls`` the CPU-path calls."""

    def __init__(self, model, domain: Domain, device, periodic=None):
        if domain.lat.D != 3:
            raise NotImplementedError("the NN force kernel is 3D; a 2D hook runs as plain "
                                      "tensor ops (kernels/hooked.py)")
        rheology_args(model, 0.0)  # refuses another model at build time
        self.model = model
        self.periodic = None if periodic is None else tuple(bool(p) for p in periodic)
        self.device = torch.device(device)
        self.shape = domain.shape
        self.hook = make_nn_forcing_hook(model, periodic=self.periodic)
        self.kernel = CudaKernel("nn_force", "tnl_lbm_tpu_torch/csrc/nn_force.cu",
                                 "tnl_lbm_tpu/kernels/fused_nn.py:232")
        self.plain_calls = 0
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {device} requested but no CUDA device is available")
            if self.shape[0] > _MAX_GRID_YZ or self.shape[1] > _MAX_GRID_YZ:
                raise ValueError(f"X and Y must be <= {_MAX_GRID_YZ} for the kernel grid")
        self.map = torch.as_tensor(np.ascontiguousarray(domain.map, np.uint8), device=self.device)

    def reset_counts(self) -> None:
        self.kernel.launches = self.plain_calls = 0

    def __call__(self, rho, u, nu, out=None):
        if rho.device.type == "cuda":
            return self._launch(rho, u, float(nu), out)
        self.plain_calls += 1
        F = self.plain(rho, u, nu)
        return F if out is None else out.copy_(F)

    def plain(self, rho, u, nu):
        """The plain version on rho's device: the forcing hook of
        ``ops/non_newtonian.py`` with the mask ``map == FLUID``; it counts
        no call."""
        fluid = self.map.to(rho.device) == int(GEO.FLUID)
        return self.hook(D3Q27, rho, u, nu, fluid)

    def _launch(self, rho, u, nu, out):
        X, Y, Z = self.shape
        if rho.device != self.map.device or u.device != rho.device:
            raise ValueError(f"rho/u are on {rho.device}/{u.device}, the kernel was built for "
                             f"{self.device}")
        for t, shape in ((rho, (X, Y, Z)), (u, (3, X, Y, Z))):
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
        rc = lib.tnl_lbm_nn_force(rho.data_ptr(), u.data_ptr(), self.map.data_ptr(),
                                  out.data_ptr(), X, Y, Z, nn_bits(self.periodic),
                                  *rheology_args(self.model, nu), stream_ptr)
        if rc != 0:
            raise RuntimeError(f"{self.kernel.name} launch failed: CUDA error {rc}")
        self.kernel.launches += 1
        return out


def make_nn_force_kernel(model, domain: Domain, device, periodic=None) -> NNForce:
    """The NN force of ``model`` on ``domain``: see :class:`NNForce`.  The
    JAX function's ``dtype`` is the kernel's float32 and its static
    ``fluid_mask`` is ``map == FLUID``, read by the kernel from the map;
    its TPU knobs (``tile``, ``tiles_per_program``) shape VMEM windows and
    have no counterpart here."""
    return NNForce(model, domain, device, periodic=periodic)
