"""Carry what the JAX package holds over to the port's objects.

Inputs are plain values and numpy arrays - what ``np.asarray`` of a JAX
array gives - so this module needs no jax.  Tests build the JAX side and
the port side from one spec through it.
"""

from __future__ import annotations

import numpy as np
import torch

from tnl_lbm_tpu_torch.models import D2Q9, D3Q7, D3Q27
from tnl_lbm_tpu_torch.ops.collision import COLLISIONS_D3Q27
from tnl_lbm_tpu_torch.ops.collision_ade import COLLISIONS_D3Q7
from tnl_lbm_tpu_torch.ops.equilibrium import EQUILIBRIA
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.utils.units import Lattice

_DTYPES = {"float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
           "bfloat16": torch.bfloat16}


def config_from_spec(collision_id: str, eq: str, well: bool, streaming: str,
                     dtype: str = "float32", high_precision_rho: bool = False,
                     storage: str | None = None) -> LBMConfig:
    """LBMConfig from the ids of ``COLLISIONS_D3Q27`` / ``EQUILIBRIA``
    (the JAX package's registries, ops/collision.py:806, ops/equilibrium.py:110):
    for example ``CUM`` with ``EQ`` or ``EQ_INV_CUM`` (well=False), or
    ``CUM_WELL`` with ``EQ_WELL`` (well=True); ``storage`` "float16"/"bfloat16"
    sets the half-storage ``storage_dtype``."""
    if collision_id not in COLLISIONS_D3Q27:
        raise NotImplementedError(f"collision {collision_id!r} is not ported yet "
                                  f"(ported: {sorted(COLLISIONS_D3Q27)})")
    if eq not in EQUILIBRIA:
        raise NotImplementedError(f"equilibrium {eq!r} is not ported yet "
                                  f"(ported: {sorted(EQUILIBRIA)})")
    return LBMConfig(lat=D3Q27, collision=COLLISIONS_D3Q27[collision_id], eq=EQUILIBRIA[eq],
                     streaming=streaming, well=well, compute_dtype=_DTYPES[dtype],
                     high_precision_rho=high_precision_rho,
                     storage_dtype=None if storage is None else _DTYPES[storage])


def ade_config_from_spec(collision_id: str, streaming: str = "AB",
                         dtype: str = "float32") -> LBMConfig:
    """D3Q7 advection-diffusion LBMConfig from an id of ``COLLISIONS_D3Q7``
    (the JAX package's registry, ops/collision_ade.py:124: SRT, MRT, CLBM,
    CLBM-RS) with the quadratic equilibrium, as the JAX package builds it."""
    if collision_id not in COLLISIONS_D3Q7:
        raise NotImplementedError(f"ADE collision {collision_id!r} is not in "
                                  f"{sorted(COLLISIONS_D3Q7)}")
    return LBMConfig(lat=D3Q7, collision=COLLISIONS_D3Q7[collision_id],
                     eq=EQUILIBRIA["EQ"], streaming=streaming, compute_dtype=_DTYPES[dtype])


_LATTICES = {lat.name: lat for lat in (D2Q9, D3Q7, D3Q27)}


def port_lattice(lat):
    """The port's own descriptor of the velocity set ``lat`` names: a JAX
    descriptor (or the port's) maps by its name, so that the port never
    holds the JAX package's objects."""
    try:
        return _LATTICES[lat.name]
    except (AttributeError, KeyError):
        raise ValueError(f"no lattice of the port is named {getattr(lat, 'name', lat)!r}") from None


def domain_from_numpy(map_arr, periodic, global_size=None, phys_dl: float = 1.0,
                      phys_dt: float = 1.0, phys_origin=None,
                      phys_viscosity: float = 0.0, lat=D3Q27) -> Domain:
    """Domain from a numpy code map on lattice ``lat`` (the port's or the JAX
    package's descriptor: ``port_lattice``; GEO codes for D3Q27, ADEGEO
    codes for D3Q7; the integers are shared between the packages)."""
    lat = port_lattice(lat)
    m = np.array(map_arr, dtype=np.uint8)
    size = tuple(m.shape) if global_size is None else tuple(global_size)
    origin = (0.0,) * len(size) if phys_origin is None else phys_origin
    units = Lattice(global_size=size, phys_origin=origin, phys_dl=phys_dl, phys_dt=phys_dt,
                    phys_viscosity=phys_viscosity)
    return Domain(lat=lat, units=units, map=m, periodic=tuple(periodic))


def state_from_numpy(f, device) -> torch.Tensor:
    """[Q, X, Y, Z] state as a contiguous tensor on ``device`` (dtype kept; a copy)."""
    return torch.from_numpy(np.array(f, order="C", copy=True)).to(device)


def state_to_numpy(f: torch.Tensor) -> np.ndarray:
    return f.detach().cpu().numpy()
