"""Equilibrium distribution functions (counterpart of
``tnl_lbm_tpu/ops/equilibrium.py``; the quadratic and well-conditioned forms).

Both take ``rho [*S]`` and ``u [D, *S]`` and return ``f_eq [Q, *S]``.
"""

from __future__ import annotations

import torch

from tnl_lbm_tpu_torch.models import LatticeDescriptor
from tnl_lbm_tpu_torch.ops.contract import lattice_dot


def _feq_term(lat: LatticeDescriptor, u: torch.Tensor) -> torch.Tensor:
    ics2 = float(lat.i_cs2)
    cu = lattice_dot(lat.c, u)
    uu = torch.sum(u * u, dim=0)
    return 1 + ics2 * cu + 0.5 * ics2 * ics2 * cu * cu - 0.5 * ics2 * uu


def eq_quadratic(lat: LatticeDescriptor, rho: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Second-order Maxwell-Boltzmann equilibrium (reference d3q27/eq.h:13-17)."""
    feq = _feq_term(lat, u)
    return torch.stack([float(lat.w[q]) * rho * feq[q] for q in range(lat.Q)])


def eq_well(lat: LatticeDescriptor, rho: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Well-conditioned equilibrium w_q * (rho * feq_term - 1): the deviation
    from the lattice weight (reference d3q27/eq_well.h:21-33)."""
    feq = _feq_term(lat, u)
    return torch.stack([float(lat.w[q]) * (rho * feq[q] - 1) for q in range(lat.Q)])


#: registry keyed like the reference plugin classes (the two ported so far)
EQUILIBRIA = {
    "EQ": eq_quadratic,
    "EQ_WELL": eq_well,
}
