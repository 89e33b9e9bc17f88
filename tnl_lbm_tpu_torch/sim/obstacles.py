"""Voxel rasterizers for the geometry map + boundary-plane helpers
(counterpart of ``tnl_lbm_tpu/sim/obstacles.py``; reference
obstacles_lbm.h:3-102 and the ``setBoundaryX/Y/Z`` setters).  All functions
mutate the host-side numpy map of a Domain.
"""

from __future__ import annotations

import numpy as np

from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim.config import Domain


def set_boundary_plane(domain: Domain, axis: int, index: int, code: GEO) -> None:
    """Set a whole lattice plane map[..., index, ...] = code."""
    sl = [slice(None)] * domain.lat.D
    sl[axis] = index
    domain.map[tuple(sl)] = int(code)


def set_boundary_x(domain, index, code):
    set_boundary_plane(domain, 0, index, code)


def set_boundary_y(domain, index, code):
    set_boundary_plane(domain, 1, index, code)


def set_boundary_z(domain, index, code):
    set_boundary_plane(domain, 2, index, code)


def _grid(domain: Domain):
    """Physical coordinates of all lattice sites, one array per axis
    (site i at origin + (i - 0.5) * dl, reference lattice.h:63-66)."""
    units = domain.units
    axes = [
        units.phys_origin[a] + (np.arange(domain.shape[a]) - 0.5) * units.phys_dl
        for a in range(domain.lat.D)
    ]
    return np.meshgrid(*axes, indexing="ij")


def draw_sphere(domain: Domain, center, radius, code: GEO = GEO.WALL) -> None:
    """Mark all sites within phys distance ``radius`` of ``center``."""
    grids = _grid(domain)
    r2 = sum((g - c) ** 2 for g, c in zip(grids, center))
    domain.map[r2 <= radius**2] = int(code)


def draw_cylinder_x(domain: Domain, cy, cz, radius, code: GEO = GEO.WALL) -> None:
    """Axis-aligned (x) cylinder."""
    grids = _grid(domain)
    r2 = (grids[1] - cy) ** 2 + (grids[2] - cz) ** 2
    domain.map[r2 <= radius**2] = int(code)


def draw_cylinder_2d(domain: Domain, cx, cy, radius, code: GEO = GEO.WALL) -> None:
    grids = _grid(domain)
    r2 = (grids[0] - cx) ** 2 + (grids[1] - cy) ** 2
    domain.map[r2 <= radius**2] = int(code)


def draw_box(domain: Domain, lo, hi, code: GEO = GEO.WALL) -> None:
    """Mark all sites with phys coordinates in [lo, hi]."""
    grids = _grid(domain)
    mask = np.ones_like(domain.map, dtype=bool)
    for g, a, b in zip(grids, lo, hi):
        mask &= (g >= a) & (g <= b)
    domain.map[mask] = int(code)


def draw_cube(domain: Domain, center, radius, code: GEO = GEO.WALL) -> None:
    """Axis-aligned cube of half-edge ``radius`` around ``center``."""
    c = np.asarray(center, float)
    draw_box(domain, c - radius, c + radius, code)


def draw_cubi(domain: Domain, center, edge_length, code: GEO = GEO.WALL) -> None:
    """The CUBI shape: a 2x1x1-cube slab with one cube on top of its +x half
    (reference obstacles_lbm.h:91-103)."""
    cx, cy, cz = (float(v) for v in center)
    L = float(edge_length)
    draw_box(domain, (cx - L, cy - L / 2, cz - L), (cx + L, cy + L / 2, cz), code)
    draw_box(domain, (cx, cy - L / 2, cz), (cx + L, cy + L / 2, cz + L), code)
