"""Collision operators of D3Q27 on torch tensors (counterpart of
``tnl_lbm_tpu/ops/collision.py``): the improved SRT and its well-conditioned
and modified-force forms, the factorised BGK (with its Galilean correction)
and its well-conditioned form, the regularised MRT with Smagorinsky LES, the
cascaded central-moment operator (CLBM) and its well-conditioned form, and
the cumulant operator (``central_moments``, ``dfs_from_central_moments``,
``collide_cum``).  The KBC family is ``ops/collision_kbc.py``.

``f_new = collide(lat, f, rho, u, nu, force=...)`` with ``f [Q, *S]``,
``rho [*S]`` and ``u [D, *S]`` from :func:`ops.moments.density_velocity`
(already carrying the half-force correction) and ``force`` None or
broadcastable to ``[D, *S]``.

The cumulant cascade follows Geier et al. 2015 ("The cumulant lattice
Boltzmann equation in three dimensions", eqs. 6-14, 51-54, 81-96) with the
per-axis transforms written as loops over a 3x3x3 nested list of tensors.
Terms that are structurally zero in a configuration stay Python ``0.0`` and
are folded out while the loops run (``_addz``/``_subz``/``_mulz``), so the
arithmetic performed is the same as the JAX package's and as the
hand-folded CUDA cascade in ``csrc/lbm_site.cuh``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from tnl_lbm_tpu_torch.ops import equilibrium as eqlib
from tnl_lbm_tpu_torch.ops.contract import lattice_dot


def forcing_terms(lat, u, force, rho):
    """Per-direction forcing S_q = (1/cs^2) (c_q - u) . F / rho of the
    improved SRT (reference d3q27/col_srt.h:25-52); [Q, *S]."""
    cF = lattice_dot(lat.c, force)
    uF = torch.sum(u * force, dim=0)
    return float(lat.i_cs2) * (cF - uF) / rho


def _apply_forced_relax(lat, f, feq, omega, S):
    """f + (feq - f) omega + (1 - omega/2) S feq (reference col_srt.h:81-107)."""
    out = f + (feq - f) * omega
    if S is not None:
        out = out + (1 - 0.5 * omega) * S * feq
    return out


def _safe(rho):
    """rho with its zeros replaced by one (reference col_srt.h:22)."""
    return torch.where(rho == 0, torch.ones_like(rho), rho)


def collide_srt(lat, f, rho, u, nu, force=None, eq=eqlib.eq_quadratic):
    """Improved SRT (Geier 2017) toward the equilibrium ``eq``, with the
    exact per-direction forcing."""
    omega = 1.0 / (float(lat.i_cs2) * nu + 0.5)
    feq = eq(lat, rho, u)
    S = None if force is None else forcing_terms(lat, u, force, _safe(rho))
    return _apply_forced_relax(lat, f, feq, omega, S)


def _bgk_axis_factors(v, G):
    """The factorised equilibrium's axis factors (reference col_bgk.h:48-59)."""
    Xz = 1.0 / 3.0 - 1 + v * v + G
    Xp = -0.5 * (Xz + 1 + v)
    Xm = Xp + v
    return {0: Xz, 1: Xp, -1: Xm}


def _bgk_galilean(lat, f, rho, u, omega, drho):
    """The Galilean correction G_a from the second raw moments (reference
    col_bgk.h:21-36; ``drho`` is 1 on total DFs, (rho - 1) / rho on
    deviations, col_bgk_well.h)."""
    G = []
    for a in range(lat.D):
        m2 = lattice_dot((np.asarray(lat.c)[:, a] != 0).astype(np.float64), f)
        Dau = -omega * 0.5 * (3 * m2 / rho - drho - 3 * u[a] * u[a])
        G.append(-3 * u[a] * u[a] * Dau * (1.0 / omega - 0.5))
    return G


def collide_bgk(lat, f, rho, u, nu, force=None, galilean: bool = False):
    """BGK toward the factorised equilibrium feq_q = -rho prod_a X_a(c_qa)
    (reference col_bgk.h:104-131), with the optional Galilean correction."""
    omega = 1.0 / (3.0 * nu + 0.5)
    G = _bgk_galilean(lat, f, rho, u, omega, 1) if galilean else [0.0] * lat.D
    factors = [_bgk_axis_factors(u[a], G[a]) for a in range(lat.D)]
    feq = []
    for q in range(lat.Q):
        term = -rho
        for a in range(lat.D):
            term = term * factors[a][int(lat.c[q, a])]
        feq.append(term)
    feq = torch.stack(feq)
    S = forcing_terms(lat, u, force, rho) if force is not None else None
    return _apply_forced_relax(lat, f, feq, omega, S)


def _f_as_tensor(lat, f):
    """View f [27, *S] as nested [ix][iy][iz] lists with i = c + 1 in {0,1,2}."""
    T = [[[None] * 3 for _ in range(3)] for _ in range(3)]
    for q in range(lat.Q):
        cx, cy, cz = (int(v) for v in lat.c[q])
        T[cx + 1][cy + 1][cz + 1] = f[q]
    return T


def _tensor_as_f(lat, T):
    vals = [T[int(lat.c[q, 0]) + 1][int(lat.c[q, 1]) + 1][int(lat.c[q, 2]) + 1]
            for q in range(lat.Q)]
    ref = next((v for v in vals if not isinstance(v, (int, float))), None)
    if ref is None:
        raise ValueError("_tensor_as_f: every lattice direction folded to a Python scalar")
    vals = [torch.full_like(ref, v) if isinstance(v, (int, float)) else v for v in vals]
    return torch.stack(vals)


def _pz(x) -> bool:
    """True for a structural Python zero."""
    return isinstance(x, (int, float)) and x == 0.0


def _addz(*terms):
    """Sum with zero folding (left-to-right association)."""
    acc = None
    for t in terms:
        if _pz(t):
            continue
        acc = t if acc is None else acc + t
    return 0.0 if acc is None else acc


def _subz(a, b):
    if _pz(b):
        return a
    if _pz(a):
        return -b
    return a - b


def _mulz(a, b):
    if _pz(a) or _pz(b):
        return 0.0
    return a * b


def _forward_axis(triple, v, offsets=None):
    """Central-moment cascade along one axis (Geier 2015 eqs. 6-8).

    (f_minus, f_zero, f_plus) -> (k0, k1, k2).  With ``offsets`` (Python
    floats (Km, Kz, Kp)) the inputs are deviations from those constants and
    the outputs the correspondingly shifted moments (the well-conditioned
    cascade, reference col_cum_well.h); returns ((k0, k1, k2), (K0, 0, K2)).
    """
    fm, fz, fp = triple
    s = fp + fm
    d = fp - fm
    k0 = s + fz
    if offsets is None:
        kk0 = k0
    else:
        Km, Kz, Kp = offsets
        assert Kp == Km, "axis weight offsets must be symmetric"
        K0 = Km + Kz + Kp
        K2 = Km + Kp
        kk0 = _addz(k0, K0)
    t = _mulz(v, kk0)
    w = _mulz(v, d)
    k1 = _subz(d, t)
    k2 = _addz(_subz(s, _addz(w, w)), _mulz(v, t))
    if offsets is None:
        return k0, k1, k2
    return (k0, k1, k2), (K0, 0.0, K2)


def _backward_axis(triple, v, offsets=None):
    """Inverse cascade along one axis (Geier 2015 eqs. 88-90), factorized:
    with s = v^2 kk0 + 2 v k1 + k2 and w = v kk0 + k1,
    fz = k0 - s, fm = (s - w)/2, fp = (s + w)/2.

    With ``offsets = (K0, 0, K2)`` the inputs are shifted moments and the
    outputs shifted populations with offsets (K2/2, K0-K2, K2/2)
    (reference col_cum_well.h eqs. 57-63).
    """
    k0, k1, k2 = triple
    if offsets is None:
        kk0 = k0
    else:
        K0, K1, K2 = offsets
        assert K1 == 0.0
        kk0 = _addz(k0, K0)
    b = _mulz(v, kk0)
    a = _mulz(v, b)
    t = _mulz(v, k1)
    s = _addz(a, t, t, k2)
    w = _addz(b, k1)
    fz = _subz(k0, s)
    fm = _mulz(0.5, _subz(s, w))
    fp = _mulz(0.5, _addz(s, w))
    if offsets is None:
        return fm, fz, fp
    return (fm, fz, fp), (0.5 * K2, K0 - K2, 0.5 * K2)


def _weight_tensor(lat):
    """Lattice weights as a [3][3][3] nested list of floats."""
    W = [[[0.0] * 3 for _ in range(3)] for _ in range(3)]
    for q in range(lat.Q):
        cx, cy, cz = (int(v) for v in lat.c[q])
        W[cx + 1][cy + 1][cz + 1] = float(lat.w[q])
    return W


def central_moments(lat, f, u, well: bool = False):
    """Full central-moment tensor k[a][b][g] (orders along x, y, z).

    With ``well=True``, ``f`` holds deviation DFs and the result holds
    shifted central moments k = kappa(f_total) - K, where K_abg is the raw
    weight-lattice moment prod_axis(1, 0, 1/3)[order].
    """
    vx, vy, vz = u[0], u[1], u[2]
    F = _f_as_tensor(lat, f)
    W = _weight_tensor(lat) if well else None
    Kz = [[None] * 3 for _ in range(3)]
    Oz = [[None] * 3 for _ in range(3)]
    for ix in range(3):
        for iy in range(3):
            triple = tuple(F[ix][iy][iz] for iz in range(3))
            if well:
                Kz[ix][iy], Oz[ix][iy] = _forward_axis(triple, vz, tuple(W[ix][iy]))
            else:
                Kz[ix][iy] = _forward_axis(triple, vz)
    Ky = [[None] * 3 for _ in range(3)]
    Oy = [[None] * 3 for _ in range(3)]
    for ix in range(3):
        for g in range(3):
            triple = tuple(Kz[ix][iy][g] for iy in range(3))
            if well:
                Ky[ix][g], Oy[ix][g] = _forward_axis(
                    triple, vy, tuple(Oz[ix][iy][g] for iy in range(3)))
            else:
                Ky[ix][g] = _forward_axis(triple, vy)
    k = [[[None] * 3 for _ in range(3)] for _ in range(3)]
    for b in range(3):
        for g in range(3):
            triple = tuple(Ky[ix][g][b] for ix in range(3))
            if well:
                (k0, k1, k2), _ = _forward_axis(
                    triple, vx, tuple(Oy[ix][g][b] for ix in range(3)))
            else:
                k0, k1, k2 = _forward_axis(triple, vx)
            k[0][b][g], k[1][b][g], k[2][b][g] = k0, k1, k2
    return k


def _K(a, b, g):
    """Raw weight-lattice moment K_abg = prod over axes of (1, 0, 1/3)[order]."""
    m = (1.0, 0.0, 1.0 / 3.0)
    return m[a] * m[b] * m[g]


def dfs_from_central_moments(lat, k, u, well: bool = False):
    """Inverse of :func:`central_moments` (x, then y, then z; eqs. 88-96)."""
    vx, vy, vz = u[0], u[1], u[2]
    Bx = [[[None] * 3 for _ in range(3)] for _ in range(3)]
    Ox = [[[0.0] * 3 for _ in range(3)] for _ in range(3)]
    for b in range(3):
        for g in range(3):
            triple = (k[0][b][g], k[1][b][g], k[2][b][g])
            if well:
                (fm, fz, fp), (Wm, Wz, Wp) = _backward_axis(
                    triple, vx, (_K(0, b, g), _K(1, b, g), _K(2, b, g)))
                Ox[0][b][g], Ox[1][b][g], Ox[2][b][g] = Wm, Wz, Wp
            else:
                fm, fz, fp = _backward_axis(triple, vx)
            Bx[0][b][g], Bx[1][b][g], Bx[2][b][g] = fm, fz, fp
    By = [[[None] * 3 for _ in range(3)] for _ in range(3)]
    Oy = [[[0.0] * 3 for _ in range(3)] for _ in range(3)]
    for ix in range(3):
        for g in range(3):
            triple = (Bx[ix][0][g], Bx[ix][1][g], Bx[ix][2][g])
            if well:
                (fm, fz, fp), (Wm, Wz, Wp) = _backward_axis(
                    triple, vy, (Ox[ix][0][g], Ox[ix][1][g], Ox[ix][2][g]))
                Oy[ix][0][g], Oy[ix][1][g], Oy[ix][2][g] = Wm, Wz, Wp
            else:
                fm, fz, fp = _backward_axis(triple, vy)
            By[ix][0][g], By[ix][1][g], By[ix][2][g] = fm, fz, fp
    T = [[[None] * 3 for _ in range(3)] for _ in range(3)]
    for ix in range(3):
        for iy in range(3):
            triple = (By[ix][iy][0], By[ix][iy][1], By[ix][iy][2])
            if well:
                (fm, fz, fp), _ = _backward_axis(
                    triple, vz, (Oy[ix][iy][0], Oy[ix][iy][1], Oy[ix][iy][2]))
            else:
                fm, fz, fp = _backward_axis(triple, vz)
            T[ix][iy][0], T[ix][iy][1], T[ix][iy][2] = fm, fz, fp
    return _tensor_as_f(lat, T)


def collide_cum(lat, f, rho, u, nu, force=None, omega2: float = 1.0,
                geier_2017: bool = False, antialias: bool = False,
                lambdas=(0.01, 0.01, 0.01), well: bool = False):
    """Geier 2015 cumulant collision (id "CUM"; ``well=True`` is "CUM_WELL").

    Only the cumulants of order >= 4 differ from central moments; they are
    corrected via Geier 2015 eqs. 51-54 before relaxation and re-added after
    (eqs. 81-84).  Post-collision first-order central moments are negated
    to realize trapezoidal forcing (reference col_cum.h:343-345); ``u`` must
    already include F/2.  With ``well=True`` (reference col_cum_well.h)
    ``f`` holds deviations from the lattice weights and every transform runs
    on shifted moments, so small updates are never swamped by the O(1)
    weights in float32; ``rho`` is the total density.
    """
    del force  # forcing enters via u (computed with +F/2) and the k_1 negation
    vx, vy, vz = u[0], u[1], u[2]
    k = central_moments(lat, f, u, well=well)

    k000 = k[0][0][0]
    k110, k101, k011 = k[1][1][0], k[1][0][1], k[0][1][1]
    k200, k020, k002 = k[2][0][0], k[0][2][0], k[0][0][2]
    k111 = k[1][1][1]
    k120, k102, k210, k012, k201, k021 = (
        k[1][2][0], k[1][0][2], k[2][1][0], k[0][1][2], k[2][0][1], k[0][2][1],
    )

    inv_rho = 1.0 / rho
    third = 1.0 / 3.0

    # The relaxation rates of cumulant orders 4-6 are unity in every
    # supported configuration (reference col_cum.h:174-220), so those
    # pre-collision cumulants relax straight to equilibrium (zero) and their
    # Geier eqs. 51-54 corrections are never consumed: they are not computed.

    # order <= 3 cumulants equal central moments
    C110, C101, C011 = k110, k101, k011
    C200, C020, C002 = k200, k020, k002
    C120, C102, C210, C012, C201, C021 = k120, k102, k210, k012, k201, k021
    C111 = k111

    omega1 = 1.0 / (3.0 * nu + 0.5)
    o1, o2 = omega1, omega2
    if geier_2017:
        lam3, lam4, lam5 = lambdas
        omega3 = (
            8 * (o1 - 2) * (o2 * (3 * o1 - 1) - 5 * o1)
            / (8 * (5 - 2 * o1) * o1 + o2 * (8 + o1 * (9 * o1 - 26)))
        )
        omega4 = (
            8 * (o1 - 2) * (o1 + o2 * (3 * o1 - 7))
            / (o2 * (56 - 42 * o1 + 9 * o1 * o1) - 8 * o1)
        )
        omega5 = (
            24 * (o1 - 2) * (4 * o1 * o1 + o1 * o2 * (18 - 13 * o1) + o2 * o2 * (2 + o1 * (6 * o1 - 11)))
            / (
                16 * o1 * o1 * (o1 - 6)
                - 2 * o1 * o2 * (216 + 5 * o1 * (9 * o1 - 46))
                + o2 * o2 * (o1 * (3 * o1 - 10) * (15 * o1 - 28) - 48)
            )
        )
        o120p102 = omega3 + (1 - omega3) * torch.abs(C120 + C102) / (rho * lam3 + torch.abs(C120 + C102))
        o210p012 = omega3 + (1 - omega3) * torch.abs(C210 + C012) / (rho * lam3 + torch.abs(C210 + C012))
        o201p021 = omega3 + (1 - omega3) * torch.abs(C201 + C021) / (rho * lam3 + torch.abs(C201 + C021))
        o120m102 = omega4 + (1 - omega4) * torch.abs(C120 - C102) / (rho * lam4 + torch.abs(C120 - C102))
        o210m012 = omega4 + (1 - omega4) * torch.abs(C210 - C012) / (rho * lam4 + torch.abs(C210 - C012))
        o201m021 = omega4 + (1 - omega4) * torch.abs(C201 - C021) / (rho * lam4 + torch.abs(C201 - C021))
        omega111 = omega5 + (1 - omega5) * torch.abs(k111) / (rho * lam5 + torch.abs(k111))
        A = (
            (4 * o1 * o1 + 2 * o1 * o2 * (o1 - 6) + o2 * o2 * (o1 * (10 - 3 * o1) - 4))
            / ((o1 - o2) * (o2 * (2 + 3 * o1) - 8 * o1))
        )
        B = (
            (4 * o1 * o2 * (9 * o1 - 16) - 4 * o1 * o1 - 2 * o2 * o2 * (2 + 9 * o1 * (o1 - 2)))
            / (3 * (o1 - o2) * (o2 * (2 + 3 * o1) - 8 * o1))
        )
    Cs110 = (1 - o1) * C110
    Cs101 = (1 - o1) * C101
    Cs011 = (1 - o1) * C011

    if antialias:
        # velocity-derivative estimates (Geier 2017 part I eqs. 27-32); the
        # bulk term is the non-equilibrium trace (C200 + C020 + C002) - k000
        # in both storage conventions (reference col_cum_well.h:271)
        Dxu = (
            -o1 * 0.5 * inv_rho * (2 * C200 - C020 - C002)
            - o2 * 0.5 * inv_rho * (C200 + C020 + C002 - k000)
        )
        Dyv = Dxu + 1.5 * o1 * inv_rho * (C200 - C020)
        Dzw = Dxu + 1.5 * o1 * inv_rho * (C200 - C002)
        DxvDyu = -3 * o1 * inv_rho * C110
        DxwDzu = -3 * o1 * inv_rho * C101
        DywDzv = -3 * o1 * inv_rho * C011

    # second order (Geier 2017 eqs. 33-35)
    eq33 = (1 - o1) * (C200 - C020)
    eq34 = (1 - o1) * (C200 - C002)
    if omega2 == 1.0:
        eq35 = k000
    else:
        eq35 = k000 * o2 + (1 - o2) * (C200 + C020 + C002)
    if antialias:
        eq33 = eq33 - 3 * rho * (1 - o1 * 0.5) * (vx * vx * Dxu - vy * vy * Dyv)
        eq34 = eq34 - 3 * rho * (1 - o1 * 0.5) * (vx * vx * Dxu - vz * vz * Dzw)
        eq35 = eq35 - 3 * rho * (1 - o2 / 2) * (vx * vx * Dxu + vy * vy * Dyv + vz * vz * Dzw)
    Cs200 = (eq33 + eq34 + eq35) / 3
    Cs020 = (-2 * eq33 + eq34 + eq35) / 3
    Cs002 = (eq33 - 2 * eq34 + eq35) / 3

    # third order (eqs. 36-42): without the Geier-2017 limiters the rates
    # omega3 = omega4 = omega5 = 1 relax these cumulants to equilibrium
    if geier_2017:
        e117 = (1 - o120p102) * (C120 + C102)
        e118 = (1 - o210p012) * (C210 + C012)
        e119 = (1 - o201p021) * (C201 + C021)
        e120 = (1 - o120m102) * (C120 - C102)
        e121 = (1 - o210m012) * (C210 - C012)
        e122 = (1 - o201m021) * (C201 - C021)
        Cs120 = 0.5 * (e120 + e117)
        Cs102 = 0.5 * (-e120 + e117)
        Cs210 = 0.5 * (e121 + e118)
        Cs012 = 0.5 * (-e121 + e118)
        Cs021 = 0.5 * (-e122 + e119)
        Cs201 = 0.5 * (e122 + e119)
        Cs111 = (1 - omega111) * C111
    else:
        Cs120 = Cs102 = Cs210 = Cs012 = Cs021 = Cs201 = 0.0
        Cs111 = 0.0

    # fourth order (eqs. 43-48): omega6..8 == 1, so only the A/B source
    # terms survive, and those need the antialias velocity derivatives
    if geier_2017 and antialias:
        fac = 3.0 * nu * rho
        eq43 = (2.0 / 3.0) * fac * A * (Dxu - 2 * Dyv + Dzw)
        eq44 = (2.0 / 3.0) * fac * A * (Dxu + Dyv - 2 * Dzw)
        eq45 = (-4.0 / 3.0) * fac * A * (Dxu + Dyv + Dzw)
        Cs220 = (eq43 + eq44 + eq45) / 3
        Cs202 = (-eq43 + eq45) / 3
        Cs022 = (-eq44 + eq45) / 3
        Cs211 = (-1.0 / 3.0) * fac * B * DywDzv
        Cs121 = (-1.0 / 3.0) * fac * B * DxwDzu
        Cs112 = (-1.0 / 3.0) * fac * B * DxvDyu
    else:
        Cs220 = Cs202 = Cs022 = 0.0
        Cs211 = Cs121 = Cs112 = 0.0

    # back to central moments (Geier 2015 eqs. 81-84); ks = Cs for order <= 3
    ks110, ks101, ks011 = Cs110, Cs101, Cs011
    ks200, ks020, ks002 = Cs200, Cs020, Cs002
    ks120, ks102, ks210, ks012, ks201, ks021 = Cs120, Cs102, Cs210, Cs012, Cs201, Cs021
    ks111 = Cs111
    # order-3 products in the order-5/6 inverses: zero whenever the
    # third-order cumulants relaxed to equilibrium (geier_2017 off)
    p5_122 = _addz(_mulz(ks020, ks102), _mulz(ks002, ks120),
                   4 * _mulz(ks011, ks111),
                   2 * _addz(_mulz(ks110, ks012), _mulz(ks101, ks021)))
    p5_212 = _addz(_mulz(ks002, ks210), _mulz(ks200, ks012),
                   4 * _mulz(ks101, ks111),
                   2 * _addz(_mulz(ks011, ks201), _mulz(ks110, ks102)))
    p5_221 = _addz(_mulz(ks200, ks021), _mulz(ks020, ks201),
                   4 * _mulz(ks110, ks111),
                   2 * _addz(_mulz(ks101, ks120), _mulz(ks011, ks210)))
    p6 = _addz(4 * _mulz(ks111, ks111),
               2 * _addz(_mulz(ks120, ks102), _mulz(ks210, ks012),
                         _mulz(ks201, ks021)))
    if not well:
        ks211 = _addz(Cs211, (ks200 * ks011 + 2 * ks101 * ks110) * inv_rho)
        ks121 = _addz(Cs121, (ks020 * ks101 + 2 * ks110 * ks011) * inv_rho)
        ks112 = _addz(Cs112, (ks002 * ks110 + 2 * ks011 * ks101) * inv_rho)
        ks220 = _addz(Cs220, (ks020 * ks200 + 2 * ks110 * ks110) * inv_rho)
        ks022 = _addz(Cs022, (ks002 * ks020 + 2 * ks011 * ks011) * inv_rho)
        ks202 = _addz(Cs202, (ks200 * ks002 + 2 * ks101 * ks101) * inv_rho)
        ks122 = _mulz(p5_122, inv_rho)
        ks212 = _mulz(p5_212, inv_rho)
        ks221 = _mulz(p5_221, inv_rho)
        ks222 = (
            _addz(p6, ks200 * ks022 + ks020 * ks202 + ks002 * ks220
                  + 4 * (ks011 * ks211 + ks101 * ks121 + ks110 * ks112)) * inv_rho
            - (
                16 * ks110 * ks101 * ks011
                + 4 * (ks101 * ks101 * ks020 + ks011 * ks011 * ks200 + ks110 * ks110 * ks002)
                + 2 * ks200 * ks020 * ks002
            ) * inv_rho * inv_rho
        )
    else:
        # shifted-space inverses (reference col_cum_well.h eqs. 53-56)
        ks211 = _addz(Cs211, ((ks200 + third) * ks011 + 2 * ks101 * ks110) * inv_rho)
        ks121 = _addz(Cs121, ((ks020 + third) * ks101 + 2 * ks110 * ks011) * inv_rho)
        ks112 = _addz(Cs112, ((ks002 + third) * ks110 + 2 * ks011 * ks101) * inv_rho)
        ks220 = _addz(Cs220, (ks020 * ks200 + 2 * ks110 * ks110 + (ks020 + ks200) * third) * inv_rho) - k000 * inv_rho / 9.0
        ks022 = _addz(Cs022, (ks002 * ks020 + 2 * ks011 * ks011 + (ks002 + ks020) * third) * inv_rho) - k000 * inv_rho / 9.0
        ks202 = _addz(Cs202, (ks200 * ks002 + 2 * ks101 * ks101 + (ks200 + ks002) * third) * inv_rho) - k000 * inv_rho / 9.0
        ks122 = _mulz(_addz(p5_122, _mulz(third, _addz(ks102, ks120))), inv_rho)
        ks212 = _mulz(_addz(p5_212, _mulz(third, _addz(ks210, ks012))), inv_rho)
        ks221 = _mulz(_addz(p5_221, _mulz(third, _addz(ks021, ks201))), inv_rho)
        sum_ks2 = ks200 + ks020 + ks002
        sum_ks22 = ks022 + ks202 + ks220
        sum_sq_s = ks101 * ks101 + ks011 * ks011 + ks110 * ks110
        sum_pairs_s = ks200 * ks020 + ks200 * ks002 + ks020 * ks002
        ks222 = (
            _addz(p6, ks200 * ks022 + ks020 * ks202 + ks002 * ks220
                  + 4 * (ks011 * ks211 + ks101 * ks121 + ks110 * ks112)
                  + sum_ks2 / 9.0 + sum_ks22 * third) * inv_rho
            - (
                16 * ks110 * ks101 * ks011
                + 4 * (ks101 * ks101 * ks020 + ks011 * ks011 * ks200 + ks110 * ks110 * ks002)
                + 2 * ks200 * ks020 * ks002
                + (4.0 * third) * sum_sq_s + (2.0 * third) * sum_pairs_s + (2.0 / 9.0) * sum_ks2
            ) * inv_rho * inv_rho
            - (k000 * k000 - k000) / 27.0 * inv_rho * inv_rho
        )

    # conserved moments: negated first order realizes the forcing
    # (reference col_cum.h:341-345)
    ks = [[[None] * 3 for _ in range(3)] for _ in range(3)]
    ks[0][0][0] = k000
    ks[1][0][0] = -k[1][0][0]
    ks[0][1][0] = -k[0][1][0]
    ks[0][0][1] = -k[0][0][1]
    ks[1][1][0], ks[1][0][1], ks[0][1][1] = ks110, ks101, ks011
    ks[2][0][0], ks[0][2][0], ks[0][0][2] = ks200, ks020, ks002
    ks[1][1][1] = ks111
    ks[1][2][0], ks[1][0][2], ks[2][1][0] = ks120, ks102, ks210
    ks[0][1][2], ks[2][0][1], ks[0][2][1] = ks012, ks201, ks021
    ks[2][1][1], ks[1][2][1], ks[1][1][2] = ks211, ks121, ks112
    ks[2][2][0], ks[0][2][2], ks[2][0][2] = ks220, ks022, ks202
    ks[1][2][2], ks[2][1][2], ks[2][2][1] = ks122, ks212, ks221
    ks[2][2][2] = ks222

    return dfs_from_central_moments(lat, ks, u, well=well)


collide_cum_well = partial(collide_cum, well=True)


def collide_mrt_les(lat, f, rho, u, nu, force=None, smagorinsky_c: float = 0.0342):
    """Regularised MRT with Smagorinsky LES (reference d3q27/col_mrt.h, id
    "MRT_LES"): the second-moment tensor Pi relaxed at a rate set by the
    strain magnitude, every higher moment re-equilibrated by the quadratic
    reconstruction f_q = w_q [rho (5/2 - 3/2 |c|^2 + 3 c.u) + 9/2 c^T Pi c
    - 3/2 tr Pi].  The reference operator carries no forcing."""
    del force
    c = np.asarray(lat.c, dtype=np.float64)
    P = {}
    for a in range(3):
        for b in range(a, 3):
            P[(a, b)] = lattice_dot(c[:, a] * c[:, b], f)
    # the non-equilibrium part (reference col_mrt.h:28-33)
    Pn = {}
    for a in range(3):
        for b in range(a, 3):
            Pn[(a, b)] = P[(a, b)] - rho * (u[a] * u[b] + ((1.0 / 3.0) if a == b else 0.0))
    Q2 = 2 * (
        Pn[(0, 0)] ** 2 + Pn[(1, 1)] ** 2 + Pn[(2, 2)] ** 2
        + 2 * (Pn[(0, 1)] ** 2 + Pn[(0, 2)] ** 2 + Pn[(1, 2)] ** 2)
    )
    tau = 3.0 * nu + 0.5
    omega = 2.0 / (torch.sqrt(tau * tau + 2 * smagorinsky_c * 9.0 * torch.sqrt(Q2) / rho) + tau)
    for key in P:
        P[key] = P[key] - omega * Pn[key]
    trP = P[(0, 0)] + P[(1, 1)] + P[(2, 2)]
    rows = []
    for q in range(lat.Q):
        cq = c[q]
        csq_q = float((cq * cq).sum())
        cu_q = 0.0
        for a in range(3):
            if cq[a] != 0:
                cu_q = cu_q + float(cq[a]) * u[a]
        cPc_q = 0.0
        for a in range(3):
            for b in range(3):
                coef = float(cq[a] * cq[b])
                if coef != 0:
                    cPc_q = cPc_q + coef * P[(min(a, b), max(a, b))]
        rows.append(float(lat.w[q])
                    * (rho * (2.5 - 1.5 * csq_q + 3 * cu_q) + 4.5 * cPc_q - 1.5 * trP))
    return torch.stack(rows)


def collide_srt_well(lat, f, rho, u, nu, force=None):
    """Well-conditioned improved SRT (reference d3q27/col_srt_well.h): the
    deviation DFs relax toward ``eq_well``; the forcing term multiplies the
    full equilibrium, deviation plus w_q (col_srt_well.h:76)."""
    omega = 1.0 / (float(lat.i_cs2) * nu + 0.5)
    feq_dev = eqlib.eq_well(lat, rho, u)
    out = f + (feq_dev - f) * omega
    if force is not None:
        S = forcing_terms(lat, u, force, _safe(rho))
        out = out + (1 - 0.5 * omega) * torch.stack(
            [S[q] * (feq_dev[q] + float(lat.w[q])) for q in range(lat.Q)])
    return out


def collide_bgk_well(lat, f, rho, u, nu, force=None, galilean: bool = False):
    """Well-conditioned factorised BGK (reference d3q27/col_bgk_well.h):
    g' = (1 - w) g + w (feq - w_q) - (1 - w/2) S (X Y Z)."""
    omega = 1.0 / (3.0 * nu + 0.5)
    # deviation storage: the second moment of g lacks the weights' 1/3 (col_bgk_well.h)
    G = _bgk_galilean(lat, f, rho, u, omega, (rho - 1) / rho) if galilean else [0.0] * 3
    factors = [_bgk_axis_factors(u[a], G[a]) for a in range(3)]
    feq_dev, psi = [], []
    for q in range(lat.Q):
        term = 1.0
        for a in range(3):
            term = term * factors[a][int(lat.c[q, a])]
        psi.append(term)
        feq_dev.append(-rho * term - float(lat.w[q]))
    feq_dev, psi = torch.stack(feq_dev), torch.stack(psi)
    out = f + (feq_dev - f) * omega
    if force is not None:
        out = out - (1 - 0.5 * omega) * forcing_terms(lat, u, force, rho) * psi
    return out


def collide_srt_modif_force(lat, f, rho, u, nu, force=None, eq=eqlib.eq_quadratic):
    """SRT with the classic Guo forcing added directly (reference
    d3q27/col_srt_modif_force.h: its expanded S terms are
    w_q [3 (c - u).F + 9 (c.u)(c.F)])."""
    from tnl_lbm_tpu_torch.ops.collision_2d import guo_forcing  # it imports this module

    omega = 1.0 / (3.0 * nu + 0.5)
    out = f + (eq(lat, rho, u) - f) * omega
    if force is not None:
        out = out + (1 - 0.5 * omega) * guo_forcing(lat, u, force)
    return out


def collide_clbm(lat, f, rho, u, nu, force=None, well: bool = False):
    """Cascaded (central-moment) LBM for D3Q27 (reference d3q27/col_clbm.h):
    the cumulant operator's cascades and second-order relaxation, with the
    velocity-derivative terms always on (col_clbm.h:138-153), and the
    central moments of order >= 3 relaxed at unit rate to the factorised
    equilibria (0 when odd, rho/9 for kappa_220 and its kin, rho/27 for
    kappa_222).  ``well=True`` is deviation storage (col_clbm_well.h).
    With a force the first-order moments are negated (trapezoidal forcing;
    ``u`` carries F/2); without, they pass through."""
    vx, vy, vz = u[0], u[1], u[2]
    k = central_moments(lat, f, u, well=well)
    k000 = k[0][0][0]
    k200, k020, k002 = k[2][0][0], k[0][2][0], k[0][0][2]
    k110, k101, k011 = k[1][1][0], k[1][0][1], k[0][1][1]
    inv_rho = 1.0 / rho
    o1 = 1.0 / (3.0 * nu + 0.5)
    o2 = 1.0
    # the trace deviation is (sum of the kappa_2) - rho == ksum - k000 in both storages
    Dxu = (-o1 * 0.5 * inv_rho * (2 * k200 - k020 - k002)
           - o2 * 0.5 * inv_rho * (k200 + k020 + k002 - k000))
    Dyv = Dxu + 1.5 * o1 * inv_rho * (k200 - k020)
    Dzw = Dxu + 1.5 * o1 * inv_rho * (k200 - k002)
    eqd4 = (1 - o1) * (k200 - k020) - 3 * rho * (1 - o1 * 0.5) * (vx * vx * Dxu - vy * vy * Dyv)
    eqd5 = (1 - o1) * (k200 - k002) - 3 * rho * (1 - o1 * 0.5) * (vx * vx * Dxu - vz * vz * Dzw)
    eqd6 = k000 * o2 + (1 - o2) * (k200 + k020 + k002) - 3 * rho * (1 - o2 / 2) * (
        vx * vx * Dxu + vy * vy * Dyv + vz * vz * Dzw)
    zero = torch.zeros_like(rho)
    ks = [[[zero] * 3 for _ in range(3)] for _ in range(3)]
    ks[0][0][0] = k000
    if force is None:
        ks[1][0][0], ks[0][1][0], ks[0][0][1] = k[1][0][0], k[0][1][0], k[0][0][1]
    else:
        ks[1][0][0], ks[0][1][0], ks[0][0][1] = -k[1][0][0], -k[0][1][0], -k[0][0][1]
    ks[1][1][0], ks[1][0][1], ks[0][1][1] = (1 - o1) * k110, (1 - o1) * k101, (1 - o1) * k011
    ks[2][0][0] = (eqd4 + eqd5 + eqd6) / 3
    ks[0][2][0] = (-2 * eqd4 + eqd5 + eqd6) / 3
    ks[0][0][2] = (eqd4 - 2 * eqd5 + eqd6) / 3
    # the shifted equilibria in well storage: rho/9 - 1/9 = k000/9, and so on
    ks[2][2][0] = ks[0][2][2] = ks[2][0][2] = (k000 if well else rho) / 9.0
    ks[2][2][2] = (k000 if well else rho) / 27.0
    return dfs_from_central_moments(lat, ks, u, well=well)


collide_clbm_well = partial(collide_clbm, well=True)


#: registry keyed by the reference operator ids (the KBC family is
#: ``ops/collision_kbc.py COLLISIONS_KBC``)
COLLISIONS_D3Q27 = {
    "SRT": partial(collide_srt, eq=eqlib.eq_quadratic),
    "SRT_WELL": collide_srt_well,
    "SRT_MODIF_FORCE": collide_srt_modif_force,
    "BGK": collide_bgk,
    "BGK_WELL": collide_bgk_well,
    "CUM": collide_cum,
    "CUM_WELL": collide_cum_well,
    "MRT_LES": collide_mrt_les,
    "CLBM": collide_clbm,
    "CLBM_WELL": collide_clbm_well,
}
