"""Physical <-> lattice unit system (subset of ``tnl_lbm_tpu/utils/units.py``).

Same conventions as the reference ``Lattice`` class (lattice.h:14-156):
site ``i`` sits at ``origin + (i - 0.5) * dl``,
``lbm_viscosity = dt / dl^2 * phys_viscosity``,
``lbm_velocity = phys_velocity * dt / dl`` and
``lbm_force = phys_force * dt^2 / dl``.  Host-side float64 scalar math.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Lattice:
    """Equidistant lattice metadata + unit conversions."""

    global_size: tuple[int, ...]
    phys_origin: tuple[float, ...]
    phys_dl: float
    phys_dt: float = 0.0
    phys_viscosity: float = 0.0

    def __post_init__(self):
        self.global_size = tuple(int(x) for x in self.global_size)
        self.phys_origin = tuple(float(x) for x in self.phys_origin)
        if len(self.phys_origin) != self.D:
            raise ValueError("phys_origin dimension does not match global_size")

    @property
    def D(self) -> int:
        return len(self.global_size)

    def lbm_viscosity(self) -> float:
        return self.phys_dt / self.phys_dl / self.phys_dl * self.phys_viscosity

    def lbm2phys_point(self, p) -> np.ndarray:
        return np.asarray(self.phys_origin) + (np.asarray(p, dtype=np.float64) - 0.5) * self.phys_dl

    def phys2lbm_x(self, x, axis: int = 0):
        """A physical coordinate along ``axis`` in lattice sites (the 1D line probes)."""
        return (x - self.phys_origin[axis]) / self.phys_dl + 0.5

    def lbm2phys_velocity(self, lbm_velocity: float) -> float:
        return lbm_velocity / self.phys_dt * self.phys_dl

    def phys2lbm_velocity(self, phys_velocity: float) -> float:
        return phys_velocity * self.phys_dt / self.phys_dl

    def phys2lbm_force(self, phys_force: float) -> float:
        return phys_force / self.phys_dl * self.phys_dt * self.phys_dt

    @property
    def num_sites(self) -> int:
        return int(np.prod(self.global_size))
