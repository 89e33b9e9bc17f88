"""Lattice velocity sets D3Q27, D2Q9 and D3Q7, the port's own.

Counterpart of ``tnl_lbm_tpu/models/descriptors.py`` with the same
direction order (reference include/lbm3d/defs.h:257-305): a direction is
named by one letter per axis, in x, y, z order, from {m, z, p} for
c = -1, 0, +1 (``pzm`` is c = (+1, 0, -1)); the rest direction comes first,
then the faces, the edges and the corners.  The tables are read-only numpy
arrays, built once from the names; the kernels' own copies of them are
compile-time constants (``csrc/lbm_site.cuh``, ``csrc/ade_site.cuh``).
"""

from __future__ import annotations

import numpy as np

_COMPONENT = {"m": -1, "z": 0, "p": 1}


def _frozen(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)
    return a


class LatticeDescriptor:
    """A velocity set: ``names`` in enum order, the integer velocities
    ``c`` [Q, D], the weights ``w`` [Q] (float64), the opposite directions
    ``opp`` [Q] and ``i_cs2`` = 1/cs^2 (3 for the flow lattices, 4 for the
    D3Q7 advection-diffusion lattice, reference d3q7/eq.h:13).  A weight
    depends only on the number of nonzero components of the direction:
    ``weight_by_order[k]`` for k of them."""

    def __init__(self, name: str, names: tuple[str, ...], weight_by_order: tuple[float, ...],
                 i_cs2: int = 3):
        self.name = name
        self.names = tuple(names)
        self.Q = len(self.names)
        self.D = len(self.names[0])
        self.i_cs2 = i_cs2
        self.c = _frozen(np.array([[_COMPONENT[ch] for ch in n] for n in self.names], np.int32))
        self.w = _frozen(np.array([weight_by_order[k] for k in np.count_nonzero(self.c, axis=1)],
                                  np.float64))
        if abs(float(self.w.sum()) - 1.0) > 1e-12:
            raise ValueError(f"{name}: the weights sum to {self.w.sum()}, not 1")
        self._index = {n: q for q, n in enumerate(self.names)}
        self.opp = self._permutation(np.ones(self.D, np.int32) * -1)

    def _permutation(self, sign: np.ndarray) -> np.ndarray:
        """q -> the direction whose velocity is c[q] * sign."""
        rows = {tuple(v): q for q, v in enumerate(self.c.tolist())}
        return _frozen(np.array([rows[tuple(v)] for v in (self.c * sign).tolist()], np.int32))

    def idx(self, name: str) -> int:
        """The index of a direction by name, e.g. ``D3Q27.idx("ppp")``."""
        return self._index[name]

    def mirror(self, axis: int) -> np.ndarray:
        """q -> the direction of c[q] with its ``axis`` component negated (the
        symmetry-plane permutation)."""
        sign = np.ones(self.D, np.int32)
        sign[axis] = -1
        return self._permutation(sign)

    def __repr__(self) -> str:
        return f"LatticeDescriptor({self.name})"


D3Q27 = LatticeDescriptor(
    "D3Q27",
    ("zzz",
     "pzz", "mzz", "zpz", "zmz", "zzp", "zzm",
     "ppz", "mmz", "pmz", "mpz", "pzp", "mzm", "pzm", "mzp",
     "zpp", "zmm", "zpm", "zmp",
     "ppp", "mmm", "ppm", "mmp", "pmp", "mpm", "pmm", "mpp"),
    (8 / 27, 2 / 27, 1 / 54, 1 / 216))

D2Q9 = LatticeDescriptor("D2Q9", ("zz", "pz", "mz", "zp", "zm", "pp", "mm", "pm", "mp"),
                         (4 / 9, 1 / 9, 1 / 36))

# advection-diffusion: w0 = 1/4, w = 1/8 on the faces, cs^2 = 1/4 (reference d3q7/eq.h:15-17)
D3Q7 = LatticeDescriptor("D3Q7", ("zzz", "pzz", "mzz", "zpz", "zmz", "zzp", "zzm"),
                         (1 / 4, 1 / 8), i_cs2=4)
