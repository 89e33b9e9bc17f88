"""D3Q7 collision operators for advection-diffusion (counterpart of
``tnl_lbm_tpu/ops/collision_ade.py``; reference d3q7/col_srt.h, col_mrt.h,
col_clbm.h, col_clbm_RS.h).

``rho`` plays the role of the scalar ``phi``, ``u`` is the advecting
velocity (the NSE lattice's in coupled runs) and ``nu`` the lattice
diffusion coefficient: a scalar or a per-site [X, Y, Z] field (reference
d3q7/macro.h:6-37).  cs^2 = 1/4 on this lattice (reference d3q7/eq.h:13).
The same arithmetic, per site, is ``ade_collide`` in ``csrc/ade_site.cuh``.
"""

from __future__ import annotations

import torch

from tnl_lbm_tpu_torch.ops import equilibrium as eqlib

#: (minus, plus) direction names per axis, in lattice order x, y, z
_AXES = (("mzz", "pzz"), ("zmz", "zpz"), ("zzm", "zzp"))


def _omega(lat, nu):
    return 1.0 / (0.5 + float(lat.i_cs2) * nu)


def collide_srt_ade(lat, f, rho, u, nu, force=None):
    """SRT for ADE (reference d3q7/col_srt.h:15-28)."""
    del force
    omega = _omega(lat, nu)
    feq = eqlib.eq_quadratic(lat, rho, u)
    return f + omega * (feq - f)


def collide_mrt_ade(lat, f, rho, u, nu, force=None):
    """Raw-moment MRT for ADE (reference d3q7/col_mrt.h:15-52): first
    moments relax at omega, second at rate 1, toward the equilibria."""
    del force
    cs2 = 1.0 / float(lat.i_cs2)
    omega = _omega(lat, nu)
    ix = lat.idx
    out = [None] * lat.Q
    m2 = []
    for a, (nm, np_) in enumerate(_AXES):
        fm, fp = f[ix(nm)], f[ix(np_)]
        m1 = (rho * u[a] + fm - fp) * omega  # mu_eq - mu, relaxed
        m2.append((rho * (u[a] * u[a] + cs2) - fm - fp) * 1.0)
        out[ix(np_)] = fp + 0.5 * (m2[a] + m1)
        out[ix(nm)] = fm + 0.5 * (m2[a] - m1)
    out[ix("zzz")] = f[ix("zzz")] - m2[0] - m2[1] - m2[2]
    return torch.stack(out)


def collide_clbm_ade(lat, f, rho, u, nu, force=None):
    """Central-moment CLBM for ADE (reference d3q7/col_clbm.h:15-90)."""
    del force
    cs2 = 1.0 / float(lat.i_cs2)
    omega = _omega(lat, nu)
    ix = lat.idx
    out = [None] * lat.Q
    k1, k2 = [], []
    for a, (nm, np_) in enumerate(_AXES):
        fm, fp, va = f[ix(nm)], f[ix(np_)], u[a]
        k1.append((rho * va + fm - fp) * omega)
        k2.append((rho * (cs2 - va * va) + 2 * va * (fp - fm) - fm - fp) * 1.0)
        out[ix(np_)] = fp + k1[a] * va + 0.5 * (k2[a] + k1[a])
        out[ix(nm)] = fm + k1[a] * va + 0.5 * (k2[a] - k1[a])
    out[ix("zzz")] = (f[ix("zzz")] - 2 * (k1[0] * u[0] + k1[1] * u[1] + k1[2] * u[2])
                      - k2[0] - k2[1] - k2[2])
    return torch.stack(out)


def collide_clbm_rs_ade(lat, f, rho, u, nu, force=None, source=None):
    """Central-moment CLBM with full reconstruction and an optional source
    term Qp (reference d3q7/col_clbm_RS.h:15-48, id "CLBM-RS")."""
    del force
    cs2 = 1.0 / float(lat.i_cs2)
    omega = _omega(lat, nu)
    Qp = source if source is not None else 0.0
    ix = lat.idx
    g1, g2 = [], []
    for a, (nm, np_) in enumerate(_AXES):
        fm, fp, va = f[ix(nm)], f[ix(np_)], u[a]
        gc1 = -rho * va + fp - fm
        gc2 = rho * va * va + 2 * (fm - fp) * va + fp + fm
        g1.append((1 - omega) * gc1)
        g2.append(gc2 + 1.0 * (rho * cs2 - gc2) + 0.5 * Qp * cs2)
    g0 = rho + 0.5 * Qp
    out = [None] * lat.Q
    out[ix("zzz")] = (rho * (1 - u[0] * u[0] - u[1] * u[1] - u[2] * u[2])
                      - 2 * (g1[0] * u[0] + g1[1] * u[1] + g1[2] * u[2])
                      - g2[0] - g2[1] - g2[2])
    for a, (nm, np_) in enumerate(_AXES):
        va = u[a]
        out[ix(np_)] = 0.5 * g0 * (va * va + va) + g1[a] * va + 0.5 * (g2[a] + g1[a])
        out[ix(nm)] = 0.5 * g0 * (va * va - va) + g1[a] * va + 0.5 * (g2[a] - g1[a])
    return torch.stack(out)


COLLISIONS_D3Q7 = {
    "SRT": collide_srt_ade,
    "MRT": collide_mrt_ade,
    "CLBM": collide_clbm_ade,
    "CLBM-RS": collide_clbm_rs_ade,
}
