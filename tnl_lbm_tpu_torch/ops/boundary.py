"""Geometry-map boundary conditions, applied as mask-selects.

Counterpart of ``tnl_lbm_tpu/ops/boundary.py``: the shared GEO enum (same
values, so numpy maps carry over between the packages), the symmetry-plane
table, the collision mask, bounce-back / symmetry as whole-array
transforms gated by a boolean mask (reference d3q27/bc.h:51-241), and the
Eichler moment inflow.
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


_CONSTS: dict = {}


def lattice_const(key: tuple, values, dtype, device) -> torch.Tensor:
    """A small constant of the lattice (an index or weight list) as a tensor
    on ``device``, made once: a CUDA graph capturing these operators may copy
    nothing from the host."""
    k = (key, dtype, str(device))
    t = _CONSTS.get(k)
    if t is None:
        t = _CONSTS[k] = torch.tensor(values, dtype=dtype, device=device)
    return t


def apply_bounce_back(lat: LatticeDescriptor, f: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Full-way bounce back: f[q] <- f[opp(q)] on masked sites
    (reference d3q27/bc.h:150-163)."""
    opp = lattice_const(("opp", lat.name), lat.opp.tolist(), torch.long, f.device)
    return torch.where(mask, f[opp], f)


def apply_symmetry(lat: LatticeDescriptor, f: torch.Tensor, mask: torch.Tensor,
                   axis: int, removed_sign: int) -> torch.Tensor:
    """Mirror components with c[axis] == removed_sign on masked sites."""
    mirror = lattice_const(("mirror", lat.name, axis), lat.mirror(axis).tolist(), torch.long,
                           f.device)
    qsel = lattice_const(("qsel", lat.name, axis, removed_sign),
                         (lat.c[:, axis] == removed_sign).tolist(), torch.bool, f.device)
    qsel = qsel.reshape((lat.Q,) + (1,) * (f.ndim - 1))
    return torch.where(mask & qsel, f[mirror], f)


def inflow_left_moment_bc(lat: LatticeDescriptor, f: torch.Tensor, u_in):
    """Moment inflow BC at the -x boundary (Eichler et al. 2024,
    https://doi.org/10.1016/j.camwa.2024.08.009; reference d3q27/bc.h:77-128).

    The 9 unknown incoming DFs (c_x = +1) of the total DFs ``f`` are rebuilt
    from the prescribed velocity ``u_in`` (3 scalars or [3, ...] tensors) and
    the known DFs; the density follows from the c_x <= 0 sums.  Returns
    (f_new, rho).  D3Q27 only.
    """
    if lat.name != "D3Q27":
        raise ValueError("the moment inflow BC is defined for D3Q27 only")
    ix = lat.idx
    vx, vy, vz = u_in[0], u_in[1], u_in[2]

    def g(*names):
        return sum(f[ix(n)] for n in names)

    s_zero = f[ix("zzz")] + g("zpp", "zmm", "zpm", "zmp") + g("zpz", "zmz", "zzp", "zzm")
    s_minus = f[ix("mzz")] + g("mpp", "mmm", "mpm", "mmp") + g("mpz", "mmz", "mzp", "mzm")
    rho = (s_zero + 2 * s_minus) / (1 - vx)

    m100 = rho * vx
    m010 = rho * vy
    m001 = rho * vz
    m011 = rho * vy * vz
    m020 = rho / 3 + rho * vy * vy
    m002 = rho / 3 + rho * vz * vz
    m021 = rho * vz / 3 + rho * vy * vy * vz
    m012 = rho * vy / 3 + rho * vy * vz * vz
    m022 = rho / 9 + rho / 3 * (vy * vy + vz * vz) + rho * vy * vy * vz * vz

    new = {}
    new["pzz"] = (
        m100 + (m022 - (m020 + m002))
        + f[ix("mzz")]
        + (g("zpp", "zmm", "zpm", "zmp") + g("zzp", "zzm", "zpz", "zmz"))
        + 2 * (g("mpp", "mmm", "mpm", "mmp") + g("mpz", "mmz", "mzp", "mzm"))
    )
    new["ppz"] = 0.5 * ((m020 - m022) + (-m012 + m010)) - (f[ix("mpz")] + f[ix("zpz")])
    new["pmz"] = 0.5 * ((m020 - m022) + (m012 - m010)) - (f[ix("mmz")] + f[ix("zmz")])
    new["pzp"] = 0.5 * ((m002 - m022) + (-m021 + m001)) - (f[ix("mzp")] + f[ix("zzp")])
    new["pzm"] = 0.5 * ((m002 - m022) + (m021 - m001)) - (f[ix("mzm")] + f[ix("zzm")])
    new["ppp"] = 0.25 * ((m022 + m011) + (m021 + m012)) - (f[ix("mpp")] + f[ix("zpp")])
    new["ppm"] = 0.25 * ((m022 - m011) + (-m021 + m012)) - (f[ix("mpm")] + f[ix("zpm")])
    new["pmp"] = 0.25 * ((m022 - m011) + (m021 - m012)) - (f[ix("mmp")] + f[ix("zmp")])
    new["pmm"] = 0.25 * ((m022 + m011) + (-m021 - m012)) - (f[ix("mmm")] + f[ix("zmm")])

    rows = [new[lat.names[q]] if lat.names[q] in new else f[q] for q in range(lat.Q)]
    return torch.stack(rows), rho


def apply_moment_bcs(lat: LatticeDescriptor, codes, masks, f_in, rho, u, u_in, eq, well: bool):
    """The BCs that act after the moments, in the reference order
    (d3q27/bc.h:77-143): INFLOW_LEFT, INFLOW, OUTFLOW_EQ, OUTFLOW_RIGHT,
    OUTFLOW_RIGHT_INTERP.  Shared by the plain step and the fused kernels'
    plain versions.

    ``codes`` are the GEO codes present and ``masks`` their site masks;
    ``u_in`` is D scalars or a [D, ...] tensor broadcastable to ``u`` (a
    per-site inflow profile);
    ``eq(rho, u)`` is the equilibrium in the storage's convention.  With
    ``well`` storage the moment inflow works on total DFs: the weights are
    added before it and subtracted after.  Returns (f_in, rho, u).
    """
    one = torch.ones((), dtype=f_in.dtype, device=f_in.device)
    if GEO.INFLOW_LEFT in codes or GEO.INFLOW in codes:
        u_in_field = torch.stack([torch.zeros_like(rho) + u_in[a] for a in range(lat.D)])
    if GEO.INFLOW_LEFT in codes:
        w = lattice_const(("w", lat.name), lat.w.tolist(), f_in.dtype, f_in.device)
        w = w.reshape((lat.Q,) + (1,) * (f_in.ndim - 1))
        f_il, rho_il = inflow_left_moment_bc(lat, f_in + w if well else f_in, u_in)
        if well:
            f_il = f_il - w
        m = masks[GEO.INFLOW_LEFT]
        f_in = torch.where(m, f_il, f_in)
        rho = torch.where(m, rho_il, rho)
        u = torch.where(m, u_in_field, u)
    # equilibrium-replacement BCs
    if GEO.INFLOW in codes:
        m = masks[GEO.INFLOW]
        f_in = torch.where(m, eq(one, u_in_field), f_in)
        rho = torch.where(m, one, rho)
        u = torch.where(m, u_in_field, u)
    if GEO.OUTFLOW_EQ in codes:
        m = masks[GEO.OUTFLOW_EQ]
        f_in = torch.where(m, eq(one, u), f_in)
        rho = torch.where(m, one, rho)
    if GEO.OUTFLOW_RIGHT in codes:
        rho = torch.where(masks[GEO.OUTFLOW_RIGHT], one, rho)
    if GEO.OUTFLOW_RIGHT_INTERP in codes:
        # equilibrium decomposition toward rho_out = 1 (bc.h:138-143, common.h:94-124)
        m = masks[GEO.OUTFLOW_RIGHT_INTERP]
        f_in = torch.where(m, f_in + eq(one, u) - eq(rho, u), f_in)
        rho = torch.where(m, one, rho)
    return f_in, rho, u
