"""D2Q9 collision operators on torch tensors: SRT with Guo forcing and the
cascaded (central-moment) CLBM.  Counterpart of
``tnl_lbm_tpu/ops/collision_2d.py`` (reference d2q9/col_srt.h, d2q9/col_clbm.h).

The CLBM works in central-moment space with the reference's relaxation
structure: the shear moments (kappa_11 and kappa_20 - kappa_02) relax at
omega = 1/tau; the trace, the third- and the fourth-order central moments
relax at rate 1 to their factorized equilibria (0, 0, rho/9); the
first-order central moments are negated, which realizes trapezoidal
(Premnath) forcing given that u includes F/2.  The per-axis transforms are
the D3Q27 cascade's (``ops/collision.py`` ``_forward_axis``,
``_backward_axis``); ``csrc/d2q9_step.cu`` runs the same arithmetic per site.
"""

from __future__ import annotations

import torch

from tnl_lbm_tpu_torch.models import LatticeDescriptor
from tnl_lbm_tpu_torch.ops import equilibrium as eqlib
from tnl_lbm_tpu_torch.ops.collision import _backward_axis, _forward_axis
from tnl_lbm_tpu_torch.ops.contract import lattice_dot


def guo_forcing(lat: LatticeDescriptor, u: torch.Tensor, force: torch.Tensor) -> torch.Tensor:
    """Classic Guo forcing w_q [ics2 (c_q - u).F + ics2^2 (c_q.u)(c_q.F)],
    the form the reference expands per direction for D2Q9
    (d2q9/col_srt.h:21-35).  Returns [Q, *S]; multiply by (1 - omega/2)."""
    ics2 = float(lat.i_cs2)
    cF = lattice_dot(lat.c, force)
    cu = lattice_dot(lat.c, u)
    uF = torch.sum(u * force, dim=0)
    body = ics2 * (cF - uF) + ics2 * ics2 * cu * cF
    return torch.stack([float(lat.w[q]) * body[q] for q in range(lat.Q)])


def collide_srt_2d(lat, f, rho, u, nu, force=None, eq=eqlib.eq_quadratic):
    """D2Q9 improved SRT (reference d2q9/col_srt.h:17-46)."""
    omega = 1.0 / (3.0 * nu + 0.5)
    feq = eq(lat, rho, u)
    out = f + (feq - f) * omega
    if force is not None:
        out = out + (1 - 0.5 * omega) * guo_forcing(lat, u, force)
    return out


def _f_as_tensor_2d(lat, f):
    T = [[None] * 3 for _ in range(3)]
    for q in range(lat.Q):
        cx, cy = (int(v) for v in lat.c[q])
        T[cx + 1][cy + 1] = f[q]
    return T


def _tensor_as_f_2d(lat, T):
    return torch.stack([T[int(lat.c[q, 0]) + 1][int(lat.c[q, 1]) + 1] for q in range(lat.Q)])


def central_moments_2d(lat, f, u):
    """kappa[a][b] for D2Q9 (orders a along x, b along y): y first, then x."""
    vx, vy = u[0], u[1]
    F = _f_as_tensor_2d(lat, f)
    Ky = [_forward_axis(tuple(F[ix][iy] for iy in range(3)), vy) for ix in range(3)]
    k = [[None] * 3 for _ in range(3)]
    for b in range(3):
        k[0][b], k[1][b], k[2][b] = _forward_axis(tuple(Ky[ix][b] for ix in range(3)), vx)
    return k


def dfs_from_central_moments_2d(lat, k, u):
    """The inverse of :func:`central_moments_2d`: x first, then y."""
    vx, vy = u[0], u[1]
    Bx = [[None] * 3 for _ in range(3)]
    for b in range(3):
        Bx[0][b], Bx[1][b], Bx[2][b] = _backward_axis((k[0][b], k[1][b], k[2][b]), vx)
    T = [list(_backward_axis((Bx[ix][0], Bx[ix][1], Bx[ix][2]), vy)) for ix in range(3)]
    return _tensor_as_f_2d(lat, T)


def collide_clbm_2d(lat, f, rho, u, nu, force=None):
    """Cascaded (central-moment) LBM for D2Q9 (reference d2q9/col_clbm.h).
    ``force`` enters through u (which carries F/2) and the first-moment
    negation, so it is not read."""
    del force
    omega = 1.0 / (3.0 * nu + 0.5)
    k = central_moments_2d(lat, f, u)
    diff_s = (1 - omega) * (k[2][0] - k[0][2])
    trace_s = (2.0 / 3.0) * rho  # the bulk relaxes at rate 1 to equilibrium
    zero = torch.zeros_like(rho)
    ks = [[k[0][0], -k[0][1], 0.5 * (trace_s - diff_s)],
          [-k[1][0], (1 - omega) * k[1][1], zero],
          [0.5 * (trace_s + diff_s), zero, rho / 9.0]]
    return dfs_from_central_moments_2d(lat, ks, u)


COLLISIONS_D2Q9 = {
    "SRT": collide_srt_2d,
    "CLBM": collide_clbm_2d,
}
