"""Geometries, seeded states and constants shared by the port's tests and
``chip_smoke.py``: the A-B boxes and channels, the ADE boxes, the coupled
cases, and the local magnitude that a diverging field is compared against.

Imports no jax: ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` run where
it is not installed.
"""

import numpy as np
import torch

from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim.step_ade import ADEGEO

AB_KINDS = ("inflow_outflow", "interp_outflow", "eq_inflow", "sym", "periodic_code", "box")
AB_SPECS = {"CUM_WELL": ("CUM_WELL", "EQ_WELL", True), "CUM": ("CUM", "EQ", False),
            "CUM_INV_CUM": ("CUM", "EQ_INV_CUM", False)}
U_IN = (0.03, 0.005, -0.004)
ADE_KINDS = ("box", "periodic", "channel")
ADE_COLLISIONS = ("SRT", "MRT", "CLBM", "CLBM-RS")
TCOEF, PHI_IN = 0.3, 0.7


def bc_box(shape):
    """A closed box holding every GEO code of the 3D set: inflows (moment
    and equilibrium) on x = 0, the three outflows on x = X-1, symmetry
    planes on the y and z faces and on patches of x = 1 and x = X-2, a
    PERIODIC-coded block, walls and NOTHING sites inside."""
    X, Y, Z = shape
    m = np.zeros(shape, np.uint8)
    m[1:-1, 0], m[1:-1, -1] = GEO.SYM_BACK, GEO.SYM_FRONT
    m[1:-1, 1:-1, 0], m[1:-1, 1:-1, -1] = GEO.SYM_BOTTOM, GEO.SYM_TOP
    m[0, : Y // 2], m[0, Y // 2 :] = GEO.INFLOW_LEFT, GEO.INFLOW
    m[-1, : Y // 3], m[-1, Y // 3 : 2 * Y // 3] = GEO.OUTFLOW_EQ, GEO.OUTFLOW_RIGHT
    m[-1, 2 * Y // 3 :] = GEO.OUTFLOW_RIGHT_INTERP
    m[1, 1 : Y // 2, 1:-1], m[-2, Y // 2 : -1, 1:-1] = GEO.SYM_LEFT, GEO.SYM_RIGHT
    m[X // 2 - 1 : X // 2 + 1, 2:4, 1:-1] = GEO.PERIODIC
    m[X // 2, Y // 2 : Y // 2 + 2, Z // 3 : Z // 2] = GEO.WALL
    m[X // 2 + 1, -3, 1:3] = GEO.NOTHING
    return m


def aa_box(shape):
    """``bc_box`` with OUTFLOW_RIGHT in place of the A-B-only interpolated
    outflow: every code the A-A even/odd kernels take."""
    m = bc_box(shape)
    m[m == GEO.OUTFLOW_RIGHT_INTERP] = GEO.OUTFLOW_RIGHT
    return m


def channel(kind, shape=None):
    """(map, periodic) of the A-B geometries: the channels of the JAX
    kernel suite (tests/test_fused_kernel.py:101, :147, :392), a box of the
    six symmetry planes, a box with PERIODIC-coded sites, and ``bc_box``."""
    if kind == "inflow_outflow":  # moment inflow, OUTFLOW_RIGHT (sim_1's pair)
        m = np.zeros(shape or (8, 8, 8), np.uint8)
        m[:, 0] = m[:, -1] = GEO.WALL
        m[:, :, 0] = m[:, :, -1] = GEO.WALL
        m[0, 1:-1, 1:-1], m[-1, 1:-1, 1:-1] = GEO.INFLOW_LEFT, GEO.OUTFLOW_RIGHT
        return m, (False, False, False)
    if kind == "interp_outflow":  # moment inflow, interpolated outflow (A-B only)
        m = np.zeros(shape or (16, 8, 8), np.uint8)
        m[:, 0] = m[:, -1] = GEO.WALL
        m[:, :, 0] = m[:, :, -1] = GEO.WALL
        m[0, 1:-1, 1:-1], m[-1, 1:-1, 1:-1] = GEO.INFLOW_LEFT, GEO.OUTFLOW_RIGHT_INTERP
        return m, (False, False, False)
    if kind == "eq_inflow":  # equilibrium inflow, OUTFLOW_EQ, periodic z
        m = np.zeros(shape or (8, 8, 8), np.uint8)
        m[:, 0] = m[:, -1] = GEO.WALL
        m[0, 1:-1, :], m[-1, 1:-1, :] = GEO.INFLOW, GEO.OUTFLOW_EQ
        return m, (False, False, True)
    if kind == "sym":
        m = np.zeros(shape or (8, 16, 8), np.uint8)
        m[0], m[-1] = GEO.SYM_LEFT, GEO.SYM_RIGHT
        m[1:-1, 0], m[1:-1, -1] = GEO.SYM_BACK, GEO.SYM_FRONT
        m[1:-1, 1:-1, 0], m[1:-1, 1:-1, -1] = GEO.SYM_BOTTOM, GEO.SYM_TOP
        return m, (False, False, False)
    if kind == "periodic_code":
        m = np.zeros(shape or (8, 16, 8), np.uint8)
        m[:, 0] = m[:, -1] = GEO.WALL
        m[2:6, 3:12] = GEO.PERIODIC
        return m, (True, False, True)
    assert kind == "box", kind
    return bc_box(shape or (8, 16, 8)), (False, False, True)


def ade_box(shape=(8, 16, 8)):
    """A box holding every ADEGEO code: WALL and WALL_BODY on the y faces,
    symmetry planes on the z faces and on patches of x = 1, x = X-2 and
    y = 1, y = Y-2, INFLOW on x = 0, OUTFLOW_PE and OUTFLOW_RIGHT on
    x = X-1, a solid slab behind TRANSFER_FS/SF/SW interfaces, a
    PERIODIC-coded block and a NOTHING site."""
    A = ADEGEO
    X, Y, Z = shape
    m = np.zeros(shape, np.uint8)
    m[:, 0], m[:, -1] = A.WALL, A.WALL_BODY
    m[:, 1:-1, 0], m[:, 1:-1, -1] = A.SYM_BOTTOM, A.SYM_TOP
    m[0, 1:-1, 1:-1] = A.INFLOW
    m[-1, 1 : Y // 2, 1:-1], m[-1, Y // 2 : -1, 1:-1] = A.OUTFLOW_PE, A.OUTFLOW_RIGHT
    m[1, 2:4, 2:-2], m[-2, 2:4, 2:-2] = A.SYM_LEFT, A.SYM_RIGHT
    m[2:4, 1, 2:-2], m[2:4, -2, 2:-2] = A.SYM_BACK, A.SYM_FRONT
    m[4, 5:11, 2:-2] = A.SOLID
    m[2, 5:11, 2:-2], m[3, 5:11, 2:-2] = A.TRANSFER_FS, A.TRANSFER_SF
    m[5, 5:11, 2:-2] = A.TRANSFER_SW
    m[X // 2, Y - 4 : Y - 2, 2:4] = A.PERIODIC
    m[X // 2 + 1, Y - 3, Z // 2] = A.NOTHING
    return m


def ade_case(kind, shape=None):
    """(ADE map, periodic) of the B6 geometries: ``ade_box``, the periodic
    box (FLUID with a PERIODIC-coded block, periodic on every axis) and
    sim_coupled's channel (WALL_BODY walls, INFLOW, OUTFLOW_PE, periodic z)."""
    if kind == "box":
        return ade_box(shape or (8, 16, 8)), (False, False, True)
    m = np.zeros(shape or (8, 16, 8), np.uint8)
    if kind == "periodic":
        m[2:5, 3:9, 1:4] = ADEGEO.PERIODIC
        return m, (True, True, True)
    assert kind == "channel", kind
    m[:, 0] = m[:, -1] = ADEGEO.WALL_BODY
    m[0], m[-1] = ADEGEO.INFLOW, ADEGEO.OUTFLOW_PE
    return m, (False, False, True)


def seeded_ade(shape, device, seed=3):
    """(g, u, nu field) from a seeded phi and velocity."""
    from tnl_lbm_tpu_torch.models import D3Q7
    from tnl_lbm_tpu_torch.ops.equilibrium import eq_quadratic

    rng = np.random.default_rng(seed)
    phi = torch.from_numpy((0.5 + 0.1 * rng.standard_normal(shape)).astype(np.float32))
    u = torch.from_numpy((0.02 * rng.standard_normal((3,) + shape)).astype(np.float32))
    nu = torch.from_numpy((0.01 + 0.02 * rng.random(shape)).astype(np.float32))
    g = eq_quadratic(D3Q7, phi, u).contiguous()
    return g.to(device), u.to(device), nu.to(device)


def ade_aa_box(shape=(8, 16, 8)):
    """``ade_box`` for the A-A coupled pair: SOLID in place of the transfer
    codes, OUTFLOW_RIGHT in place of OUTFLOW_PE (the pair refuses both),
    and a NOTHING block of its own, where ``aa_box`` has fluid: the two
    lattices' NOTHING sites differ."""
    A = ADEGEO
    m = ade_box(shape)
    m[np.isin(m, [int(c) for c in (A.TRANSFER_FS, A.TRANSFER_SF, A.TRANSFER_SW)])] = A.SOLID
    m[m == A.OUTFLOW_PE] = A.OUTFLOW_RIGHT
    X, Y, Z = shape
    m[2:4, Y // 2 - 1 : Y // 2 + 1, Z // 2] = A.NOTHING
    return m


def sim_coupled_aa_maps(shape):
    """sim_coupled's maps under A-A streaming at ``shape``: NSE walls on the
    y faces, INFLOW and OUTFLOW_EQ; ADE WALL_BODY walls, INFLOW and
    OUTFLOW_RIGHT (the app's stand-in for the A-B-only OUTFLOW_PE);
    periodic z.  (mn, pn, ma, pa)."""
    mn = np.zeros(shape, np.uint8)
    mn[:, 0] = mn[:, -1] = GEO.WALL
    mn[0, 1:-1], mn[-1, 1:-1] = GEO.INFLOW, GEO.OUTFLOW_EQ
    ma, pa = ade_case("channel", shape)
    ma[ma == int(ADEGEO.OUTFLOW_PE)] = ADEGEO.OUTFLOW_RIGHT
    return mn, (False, False, True), ma, pa


def coupled_aa_cases(shape=(16, 16, 12)):
    """(label, NSE map, NSE periodic, ADE map, ADE periodic) of the B8
    compare at ``shape``: sim_coupled's A-A channel, ``aa_box`` beside
    ``ade_aa_box`` (their NOTHING sites differ) and the periodic box."""
    yield ("channel",) + sim_coupled_aa_maps(shape)
    yield "box", aa_box(shape), (False, False, True), ade_aa_box(shape), (False, False, True)
    m, periodic = ade_case("periodic", shape)
    yield "periodic", np.zeros_like(m), periodic, m, periodic


def coupled_cases():
    """(label, NSE map, NSE periodic, ADE map, ADE periodic) of the B7
    compare: sim_coupled's channel maps and ``bc_box`` beside ``ade_box``."""
    shape = (16, 16, 12)
    mn = np.zeros(shape, np.uint8)
    mn[:, 0] = mn[:, -1] = GEO.WALL
    mn[0, 1:-1], mn[-1, 1:-1] = GEO.INFLOW, GEO.OUTFLOW_EQ
    ma, pa = ade_case("channel", shape)
    yield "channel", mn, (False, False, True), ma, pa
    yield "box", bc_box((8, 16, 8)), (False, False, True), ade_box((8, 16, 8)), (False, False, True)


def local_scale(ref):
    """Per site: max(1, the largest magnitude of ``ref`` (a [X, Y, Z] field
    or its [C, X, Y, Z] components) within 2 sites along x and 1 along y
    and z) - the operands an A-B site update reads, OUTFLOW_PE's x-2
    included.  Where sim_coupled's WALL_BODY walls have grown phi, a step
    is compared relative to this."""
    mag = ref.abs() if ref.ndim == 3 else torch.stack([c.abs() for c in ref]).amax(0)
    pooled = torch.nn.functional.max_pool3d(mag[None, None], kernel_size=(5, 3, 3), stride=1,
                                            padding=(2, 1, 1))[0, 0]
    return pooled.clamp(min=1.0)
