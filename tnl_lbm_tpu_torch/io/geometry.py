"""2D geometry-file loader: per-cell type and 8 Bouzidi thetas (the port's
own copy of ``tnl_lbm_tpu/io/geometry.py``; reference ``projectObjectFromFile``,
sim_2D/sim2d_3.cu:101-185).

Each line is ``x y type c0..c7``: type 0 is fluid, 1 near-wall (Bouzidi), 2
wall; the thetas are normalized wall distances per compass direction E N W S
NE NW SW SE (reference d2q9/bc.h:143-150).  Validation is the reference's:
theta <= 1, the inferred dimensions equal the lattice's, X*Y rows.

The steps hold thetas per *incoming* direction q (index q-1 of the [8, X, Y]
array, in D2Q9's order): the wall distance along opp(q), the link toward
which q streams in (``ops/streaming.py`` ``bouzidi``).  This loader reorders.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from tnl_lbm_tpu_torch.models import D2Q9
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.utils.logging_utils import get_logger

#: the file's theta columns, in order: compass direction as a c vector
_COMPASS = ((1, 0), (0, 1), (-1, 0), (0, -1), (1, 1), (-1, 1), (-1, -1), (1, -1))


def load_geometry_file(path, X: int, Y: int, use_bouzidi_for_type1: bool = True):
    """Returns (map [X, Y] uint8 of GEO codes, bouzidi [8, X, Y] float32).

    Type-1 cells become FLUID_NEAR_WALL, or FLUID when
    ``use_bouzidi_for_type1`` is False.  Raises ValueError on a dimension
    mismatch or an invalid theta, as the reference's runtime guards do
    (sim2d_3.cu:136-177).
    """
    path = Path(path)
    data = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if data.shape[1] != 11:
        raise ValueError(f"geometry file must have 11 columns, got {data.shape[1]}")
    xi = data[:, 0].astype(np.int64)
    yi = data[:, 1].astype(np.int64)
    cell_type = data[:, 2].astype(np.int64)
    thetas = data[:, 3:11]
    if (thetas > 1.0).any():
        raise ValueError("Bouzidi theta out of range (>1)")
    if len(data) != X * Y:
        raise ValueError(f"geometry row count {len(data)} != lattice size {X * Y}")
    if xi.max() + 1 != X or yi.max() + 1 != Y:
        raise ValueError(f"geometry dims {xi.max() + 1} x {yi.max() + 1} do not match "
                         f"lattice {X} x {Y}")

    near_wall = GEO.FLUID_NEAR_WALL if use_bouzidi_for_type1 else GEO.FLUID
    codes = np.array([GEO.FLUID, near_wall, GEO.WALL], np.uint8)
    m = np.zeros((X, Y), np.uint8)
    known = (cell_type >= 0) & (cell_type <= 2)
    m[xi, yi] = np.where(known, codes[np.clip(cell_type, 0, 2)], np.uint8(GEO.FLUID))

    # theta for incoming q = the file's column of the compass direction opp(q)
    bz = np.full((8, X, Y), -1.0, np.float32)
    for q in range(1, D2Q9.Q):
        bz[q - 1, xi, yi] = thetas[:, _COMPASS.index(tuple(-int(c) for c in D2Q9.c[q]))]

    get_logger("main").info("geometry '%s' loaded: %d rows, %d near-wall, %d wall", path.name,
                            len(data), int((cell_type == 1).sum()), int((cell_type == 2).sum()))
    return m, bz
