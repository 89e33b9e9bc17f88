"""Entropic KBC collision operators (8 variants) of D3Q27 on torch tensors
(counterpart of ``tnl_lbm_tpu/ops/collision_kbc.py``).

Karlin-Bosch-Chikatamarla models (arXiv:1507.02518; reference
d3q27/col_kbc_n.h, col_kbc_c.h): the DFs are split per site as
f_i = k_i + s_i + h_i; the shear part s relaxes at beta and the higher-order
part h at beta gamma, with the entropic stabiliser

    gamma = 1/beta - (2 - 1/beta) <ds|dh> / <dh|dh>,   <x|y> = sum_i x_i y_i / feq_i,

so f' = f - beta (2 ds + gamma dh), beta = 1 / (6 nu + 1), and gamma = 2
where <dh|dh> is zero.  The shear part holds (reference col_kbc_n.h:10-21)

    N1/C1: D (deviatoric stress)   N2/C2: D + T (trace)
    N3/C3: D + Q (heat flux)       N4/C4: D + T + Q

with the heat flux's deltas from raw (N) or central (C) moments; those of D
and T are the same in both.  feq is the factorised inverse-cumulant
equilibrium, as in the reference.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from tnl_lbm_tpu_torch.ops.collision import central_moments
from tnl_lbm_tpu_torch.ops.contract import lattice_dot
from tnl_lbm_tpu_torch.ops.equilibrium import eq_inv_cum


def _raw_moment(lat, f, a, b, g):
    c = np.asarray(lat.c).astype(np.float64)
    return lattice_dot((c[:, 0] ** a) * (c[:, 1] ** b) * (c[:, 2] ** g), f)


def _delta_s_second_order(lat, f, rho, u, with_trace):
    """ds of D (and of T with ``with_trace``) per direction, from the
    deltas dN_xz, dN_yz, dP_ab and dT."""
    vx, vy, vz = u[0], u[1], u[2]
    M200 = _raw_moment(lat, f, 2, 0, 0)
    M020 = _raw_moment(lat, f, 0, 2, 0)
    M002 = _raw_moment(lat, f, 0, 0, 2)
    M110 = _raw_moment(lat, f, 1, 1, 0)
    M101 = _raw_moment(lat, f, 1, 0, 1)
    M011 = _raw_moment(lat, f, 0, 1, 1)
    dNxz = (M200 - M002) - rho * (vx * vx - vz * vz)
    dNyz = (M020 - M002) - rho * (vy * vy - vz * vz)
    dPxy = M110 - rho * vx * vy
    dPxz = M101 - rho * vx * vz
    dPyz = M011 - rho * vy * vz
    dT = (M200 + M020 + M002) - rho * (1.0 + vx * vx + vy * vy + vz * vz)
    rows = []
    for q in range(lat.Q):
        cx, cy, cz = (int(v) for v in lat.c[q])
        nz = (cx != 0) + (cy != 0) + (cz != 0)
        expr = 0.0
        if nz == 1:  # face
            if cx != 0:
                expr = (2 * dNxz - dNyz) / 6.0
            elif cy != 0:
                expr = (-dNxz + 2 * dNyz) / 6.0
            else:
                expr = (-dNxz - dNyz) / 6.0
            if with_trace:
                expr = expr + dT / 6.0
        elif nz == 2:  # edge
            if cz == 0:
                expr = (cx * cy) * dPxy / 4.0
            elif cy == 0:
                expr = (cx * cz) * dPxz / 4.0
            else:
                expr = (cy * cz) * dPyz / 4.0
        elif nz == 0 and with_trace:
            expr = -dT
        rows.append(expr + torch.zeros_like(rho))
    return torch.stack(rows)


def _delta_s_heatflux(lat, f, rho, u, central):
    """ds of the heat-flux tensor Q, from raw or central moments."""
    vx, vy, vz = u[0], u[1], u[2]
    if central:
        k = central_moments(lat, f, u)
        dQ = {"xxy": k[2][1][0], "xxz": k[2][0][1], "xyy": k[1][2][0], "yyz": k[0][2][1],
              "xzz": k[1][0][2], "yzz": k[0][1][2], "xyz": k[1][1][1]}
    else:
        cs2 = 1.0 / 3.0
        dQ = {
            "xxy": _raw_moment(lat, f, 2, 1, 0) - rho * vy * (cs2 + vx * vx),
            "xxz": _raw_moment(lat, f, 2, 0, 1) - rho * vz * (cs2 + vx * vx),
            "xyy": _raw_moment(lat, f, 1, 2, 0) - rho * vx * (cs2 + vy * vy),
            "yyz": _raw_moment(lat, f, 0, 2, 1) - rho * vz * (cs2 + vy * vy),
            "xzz": _raw_moment(lat, f, 1, 0, 2) - rho * vx * (cs2 + vz * vz),
            "yzz": _raw_moment(lat, f, 0, 1, 2) - rho * vy * (cs2 + vz * vz),
            "xyz": _raw_moment(lat, f, 1, 1, 1) - rho * vx * vy * vz,
        }
    rows = []
    for q in range(lat.Q):
        cx, cy, cz = (int(v) for v in lat.c[q])
        nz = (cx != 0) + (cy != 0) + (cz != 0)
        expr = 0.0
        if nz == 1:
            if cx != 0:
                expr = -cx * (dQ["xyy"] + dQ["xzz"]) / 2.0
            elif cy != 0:
                expr = -cy * (dQ["xxy"] + dQ["yzz"]) / 2.0
            else:
                expr = -cz * (dQ["xxz"] + dQ["yyz"]) / 2.0
        elif nz == 2:
            if cz == 0:
                expr = (cx * dQ["xyy"] + cy * dQ["xxy"]) / 4.0
            elif cy == 0:
                expr = (cx * dQ["xzz"] + cz * dQ["xxz"]) / 4.0
            else:
                expr = (cy * dQ["yzz"] + cz * dQ["yyz"]) / 4.0
        elif nz == 3:
            expr = (cx * cy * cz) * dQ["xyz"] / 8.0
        rows.append(expr + torch.zeros_like(rho))
    return torch.stack(rows)


def collide_kbc(lat, f, rho, u, nu, force=None, variant: str = "N1"):
    """KBC collision, ``variant`` one of N1-N4 and C1-C4.  The reference
    operators carry no forcing."""
    del force
    kind, num = variant[0], int(variant[1])
    ds = _delta_s_second_order(lat, f, rho, u, with_trace=num in (2, 4))
    if num in (3, 4):
        ds = ds + _delta_s_heatflux(lat, f, rho, u, central=(kind == "C"))
    feq = eq_inv_cum(lat, rho, u)
    ifeq = 1.0 / feq
    dh = (f - feq) - ds
    beta = 1.0 / (6.0 * nu + 1.0)
    num_sp = torch.sum(ds * dh * ifeq, dim=0)
    den_sp = torch.sum(dh * dh * ifeq, dim=0)
    empty = den_sp == 0
    gamma = 1.0 / beta - (2.0 - 1.0 / beta) * num_sp / torch.where(
        empty, torch.full_like(den_sp, 1e-30), den_sp)
    gamma = torch.where(empty, torch.full_like(gamma, 2.0), gamma)
    return f - beta * (2.0 * ds + gamma * dh)


#: registry keyed by the reference operator ids, KBC_N1 ... KBC_C4
COLLISIONS_KBC = {
    f"KBC_{k}{n}": partial(collide_kbc, variant=f"{k}{n}")
    for k in ("N", "C")
    for n in (1, 2, 3, 4)
}
