"""Equilibrium distribution functions (counterpart of
``tnl_lbm_tpu/ops/equilibrium.py``: the quadratic, well-conditioned,
inverse-cumulant and entropic forms).

Each takes ``rho [*S]`` and ``u [D, *S]`` and returns ``f_eq [Q, *S]``.
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


def _product_eq(lat: LatticeDescriptor, rho: torch.Tensor, factors) -> torch.Tensor:
    """f_eq[q] = rho * prod_a factors[a][c_qa] for the product-form
    equilibria; ``factors[a]`` maps c in {-1, 0, +1} to the axis factor."""
    out = []
    for q in range(lat.Q):
        term = rho
        for a in range(lat.D):
            term = term * factors[a][int(lat.c[q, a])]
        out.append(term)
    return torch.stack(out)


def eq_inv_cum(lat: LatticeDescriptor, rho: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-cumulant equilibrium in factorized product form: per axis
    phi(0, v) = (2 - 3 v^2) / 3, phi(+-1, v) = (3 v^2 +- 3 v + 1) / 6
    (reference eq_inv_cum.h:24-52)."""
    factors = []
    for a in range(lat.D):
        v = u[a]
        factors.append({
            0: (2 - 3 * v * v) / 3,
            1: (3 * v * v + 3 * v + 1) / 6,
            -1: (3 * v * v - 3 * v + 1) / 6,
        })
    return _product_eq(lat, rho, factors)


def eq_entropic(lat: LatticeDescriptor, rho: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Entropic equilibrium in sqrt product form (Karlin et al.): per axis,
    with s = sqrt(1 + 3 v^2), psi(0, v) = (2/3) (2 - s) and
    psi(+-1, v) = (1/6) (2 - s) ((2 v + s) / (1 - v))^{+-1}
    (reference eq_entropic.h:90-216)."""
    factors = []
    for a in range(lat.D):
        v = u[a]
        s = torch.sqrt(1 + 3 * v * v)
        base = 2 - s
        ratio = (2 * v + s) / (1 - v)
        factors.append({
            0: (2.0 / 3.0) * base,
            1: (1.0 / 6.0) * base * ratio,
            -1: (1.0 / 6.0) * base / ratio,
        })
    return _product_eq(lat, rho, factors)


#: registry keyed like the reference plugin classes
EQUILIBRIA = {
    "EQ": eq_quadratic,
    "EQ_WELL": eq_well,
    "EQ_INV_CUM": eq_inv_cum,
    "EQ_ENTROPIC": eq_entropic,
}
