"""Geometry-map boundary conditions, applied as mask-selects.

Counterpart of ``tnl_lbm_tpu/ops/boundary.py``: the shared GEO enum (same
values, so numpy maps carry over between the packages), the symmetry-plane
table, the collision mask, and bounce-back / symmetry as whole-array
transforms gated by a boolean mask (reference d3q27/bc.h:51-241).
"""

from __future__ import annotations

import enum

import torch

from tnl_lbm_tpu_torch.models import LatticeDescriptor


class GEO(enum.IntEnum):
    """Geometry codes for NSE lattices (reference d3q27/bc.h:17-34, d2q9/bc.h:16-34)."""

    FLUID = 0
    WALL = 1
    INFLOW = 2
    INFLOW_LEFT = 3           # moment inflow BC (Eichler), D3Q27 only
    OUTFLOW_EQ = 4
    OUTFLOW_RIGHT = 5
    OUTFLOW_RIGHT_INTERP = 6
    PERIODIC = 7
    NOTHING = 8               # inert ghost site
    SYM_TOP = 9               # symmetry planes (axis/side table below)
    SYM_BOTTOM = 10
    SYM_LEFT = 11
    SYM_RIGHT = 12
    SYM_BACK = 13
    SYM_FRONT = 14
    FLUID_NEAR_WALL = 15      # Bouzidi curved-wall interpolation (D2Q9)
    TRANSFER_FS = 16          # conjugate-transfer tags (ADE coupling)
    TRANSFER_SF = 17
    TRANSFER_SW = 18


def sym_table(D: int):
    """SYM code -> (axis, removed_sign): incoming components with
    c[axis] == removed_sign are replaced by their mirror image; the
    "vertical" axis is z in 3D and y in 2D (reference d3q27/bc.h:165-236)."""
    vert = D - 1
    table = {
        GEO.SYM_TOP: (vert, -1),
        GEO.SYM_BOTTOM: (vert, +1),
        GEO.SYM_LEFT: (0, +1),
        GEO.SYM_RIGHT: (0, -1),
    }
    if D == 3:
        table[GEO.SYM_BACK] = (1, +1)
        table[GEO.SYM_FRONT] = (1, -1)
    return table


def collision_mask_codes(D: int):
    """GEO codes on which the collision operator runs
    (reference d3q27/bc.h:243-248, d2q9/bc.h:198-203)."""
    codes = {GEO.FLUID, GEO.PERIODIC, GEO.OUTFLOW_RIGHT, GEO.OUTFLOW_RIGHT_INTERP,
             GEO.FLUID_NEAR_WALL}
    if D == 3:
        codes.add(GEO.INFLOW_LEFT)
    return codes


def apply_bounce_back(lat: LatticeDescriptor, f: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Full-way bounce back: f[q] <- f[opp(q)] on masked sites
    (reference d3q27/bc.h:150-163)."""
    opp = torch.tensor(lat.opp.tolist(), dtype=torch.long, device=f.device)
    return torch.where(mask, f[opp], f)


def apply_symmetry(lat: LatticeDescriptor, f: torch.Tensor, mask: torch.Tensor,
                   axis: int, removed_sign: int) -> torch.Tensor:
    """Mirror components with c[axis] == removed_sign on masked sites."""
    mirror = torch.tensor(lat.mirror(axis).tolist(), dtype=torch.long, device=f.device)
    qsel = torch.tensor((lat.c[:, axis] == removed_sign).tolist(), device=f.device)
    qsel = qsel.reshape((lat.Q,) + (1,) * (f.ndim - 1))
    return torch.where(mask & qsel, f[mirror], f)
