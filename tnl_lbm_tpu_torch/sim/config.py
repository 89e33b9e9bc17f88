"""Solver configuration and domain description (counterpart of
``tnl_lbm_tpu/sim/config.py``; reference defs.h:169-250 ``LBM_CONFIG``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from tnl_lbm_tpu_torch.models import LatticeDescriptor
from tnl_lbm_tpu_torch.ops import equilibrium as eqlib
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.utils.units import Lattice


@dataclasses.dataclass(frozen=True)
class LBMConfig:
    """Plugin bundle: collision + equilibrium + streaming pattern + storage.

    Attributes:
      lat: velocity-set descriptor.
      collision: ``(lat, f, rho, u, nu, force=...) -> f_new``.
      eq: equilibrium used by initialization.
      streaming: "AB" (pull, double buffer) or "AA" (single buffer, parity steps).
      well: DFs stored as deviations from lattice weights (well-conditioned).
      compute_dtype: torch dtype of DFs and macro fields.
      forcing_hook: per-step forcing hook ``hook(lat, rho, u, nu, fluid_mask)
        -> force [D, *S]`` (the non-Newtonian force of ops/non_newtonian.py;
        reference kernels.h:92, nonNewtonian.h:393-): the plain step adds it
        to the body force, the kernels run it through kernels/hooked.py.
      high_precision_rho: Neumaier-compensated density sum
        (reference USE_HIGH_PRECISION_RHO, d3q27/common.h:19-28).
      storage_dtype: 16-bit at-rest DF storage (torch.float16 or
        torch.bfloat16; None stores in compute_dtype).  Only the one-kernel
        A-A pair takes it, so it forces pair dispatch in ``Simulation``; the
        per-step steps refuse it.  Requires well=True.
    """

    lat: LatticeDescriptor
    collision: Callable[..., Any]
    eq: Callable[..., Any] = eqlib.eq_quadratic
    streaming: str = "AB"
    well: bool = False
    compute_dtype: torch.dtype = torch.float32
    forcing_hook: Callable[..., Any] | None = None
    high_precision_rho: bool = False
    storage_dtype: Any = None

    def __post_init__(self):
        if self.streaming not in ("AB", "AA"):
            raise ValueError(f"streaming must be 'AB' or 'AA', got {self.streaming!r}")
        if self.storage_dtype is not None and not self.well:
            raise ValueError("storage_dtype (half storage) requires well=True "
                             "(deviation DFs keep the 16-bit mantissa on the "
                             "small signal)")


@dataclasses.dataclass
class Domain:
    """Geometry map (host numpy, GEO codes) + unit system for one simulation
    (reference lbm_block.hpp:356-364, state.hpp:879-896)."""

    lat: LatticeDescriptor
    units: Lattice
    map: np.ndarray  # [*S] uint8 of GEO codes (ADEGEO codes on a D3Q7 lattice)
    periodic: tuple[bool, ...] | None = None
    #: Bouzidi thetas [8, X, Y] per incoming direction q (index q-1) of a
    #: D2Q9 lattice, read at FLUID_NEAR_WALL sites (``io/geometry.py``)
    bouzidi: np.ndarray | None = None

    def __post_init__(self):
        if self.periodic is None:
            self.periodic = tuple([False] * self.lat.D)
        self.periodic = tuple(bool(p) for p in self.periodic)
        if self.map.shape != tuple(self.units.global_size):
            raise ValueError(f"map shape {self.map.shape} != lattice size {self.units.global_size}")
        if len(self.periodic) != self.lat.D:
            raise ValueError("periodic needs one flag per axis")
        if self.bouzidi is not None:
            if self.lat.name != "D2Q9":
                raise NotImplementedError("Bouzidi curved walls are D2Q9 only (reference "
                                          "d2q9/bc.h); got a " + self.lat.name + " domain")
            want = (self.lat.Q - 1,) + self.shape
            if np.shape(self.bouzidi) != want:
                raise ValueError(f"bouzidi shape {np.shape(self.bouzidi)} != {want}")

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.units.global_size)

    def codes_present(self) -> set:
        """The codes in the map: ``ADEGEO`` members on the D3Q7 advection-
        diffusion lattice, ``GEO`` members otherwise.  The two tables give
        the same integers other meanings (ADEGEO.WALL_BODY = 2 is
        GEO.INFLOW)."""
        if self.lat.Q == 7:
            from tnl_lbm_tpu_torch.sim.step_ade import ADEGEO

            return {ADEGEO(int(c)) for c in np.unique(self.map)}
        return {GEO(int(c)) for c in np.unique(self.map)}


def initial_dfs(cfg: LBMConfig, domain: Domain, device, rho0: float = 1.0, u0=None) -> torch.Tensor:
    """Equilibrium initialization of the DF array on ``device`` (reference
    resetDFs, lbm_block.hpp:219-250 - equilibrium everywhere incl. ghost sites)."""
    shape = domain.shape
    dt = cfg.compute_dtype
    rho = torch.full(shape, rho0, dtype=dt, device=device)
    if u0 is None:
        u = torch.zeros((cfg.lat.D,) + shape, dtype=dt, device=device)
    else:
        u = torch.as_tensor(np.asarray(u0, np.float64), dtype=dt, device=device)
        u = u.reshape((cfg.lat.D,) + (1,) * len(shape)).expand((cfg.lat.D,) + shape)
    return cfg.eq(cfg.lat, rho, u).to(dt).contiguous()
