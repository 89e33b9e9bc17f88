"""Geometries, seeded states and constants shared by the port's tests and
``chip_smoke.py``: the A-B boxes and channels, the ADE boxes, the coupled
cases, the local magnitude that a diverging field is compared against, and
the non-Newtonian cases (the hooked slice).

Imports no jax: ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` run where
it is not installed.
"""

import re
from pathlib import Path

import numpy as np
import torch

from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.ops.non_newtonian import Casson, CarreauYasuda
from tnl_lbm_tpu_torch.sim.step_ade import ADEGEO

AB_KINDS = ("inflow_outflow", "interp_outflow", "eq_inflow", "sym", "periodic_code", "box")
AB_SPECS = {"CUM_WELL": ("CUM_WELL", "EQ_WELL", True), "CUM": ("CUM", "EQ", False),
            "CUM_INV_CUM": ("CUM", "EQ_INV_CUM", False)}
U_IN = (0.03, 0.005, -0.004)
#: the D3Q27 collisions beyond CUM and CUM_WELL, whose instances the per-step
#: kernels (B4, B2, B3) have in the family sources (csrc/coll_*.cu)
COLLISION_IDS = ("SRT", "SRT_WELL", "SRT_MODIF_FORCE", "BGK", "BGK_WELL", "MRT_LES", "CLBM",
                 "CLBM_WELL") + tuple(f"KBC_{k}{n}" for k in "NC" for n in (1, 2, 3, 4))
#: (collision id, equilibrium id) of the compares: each id with the equilibrium
#: it takes by nature, then the run-time equilibrium's other kinds
COLLISION_CASES = tuple((cid, None) for cid in COLLISION_IDS) + (("KBC_N1", "EQ_ENTROPIC"),
                                                                 ("SRT", "EQ_INV_CUM"))
#: |df| bound of a KBC step against the JAX package: its own KBC kernel bound
#: (tests/test_fused_kernel.py:419-421); the other collisions take 1e-6
KBC_TOL_F = 1e-5
#: |df| bound of a per-step kernel's collision instance against its plain
#: version on the card, KBC's too: on an NVIDIA H100 80GB HBM3 at 700 W the
#: KBC instances read at most 3.576e-7, the others 2.384e-7 (chip_smoke.py's
#: collisions phase)
KERNEL_TOL_F = 1e-6
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


def collision_spec(cid, streaming="AB", eq=None) -> dict:
    """``interop.config_from_spec`` keywords of a collision id with the
    equilibrium it takes by nature (or ``eq``): the well-conditioned one,
    well=True, under *_WELL; eq_inv_cum (its own feq) under KBC; else the
    quadratic one."""
    if cid.endswith("_WELL"):
        natural, well = "EQ_WELL", True
    else:
        natural, well = ("EQ_INV_CUM" if cid.startswith("KBC") else "EQ"), False
    return dict(collision_id=cid, eq=eq or natural, well=well, streaming=streaming)


def collision_tol_f(cid) -> float:
    """|df| bound of a collision's plain step against the JAX package's."""
    return KBC_TOL_F if cid.startswith("KBC") else 1e-6


def collision_state(cfg, shape, device):
    """The seeded input of ``chip_smoke.py``'s collision compares: cfg's
    equilibrium at rho 1 +- 0.01 and u ~ 0.02 drawn per site (seed 5), plus
    noise of 1e-4 (seed 7).  After the pull each site holds DFs from
    neighbours of other rho and u, ~1e-2 off its own equilibrium."""
    rng = np.random.default_rng(5)
    rho = torch.from_numpy((1 + 0.01 * rng.standard_normal(shape)).astype(np.float32))
    u = torch.from_numpy((0.02 * rng.standard_normal((3,) + shape)).astype(np.float32))
    f = cfg.eq(cfg.lat, rho.to(device), u.to(device)).float()
    noise = np.random.default_rng(7).standard_normal((27,) + tuple(shape)).astype(np.float32)
    return (f + torch.from_numpy(noise * 1e-4).to(device)).contiguous()


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


# ------------------------------------------------------------------ D2Q9

D2_COLLISIONS = ("SRT", "CLBM")
D2_KINDS = ("channel", "bouzidi", "periodic", "box")
FORCE_2D = (1e-5, 2e-6)
U_IN_2D = (0.03, 0.004)


def bouzidi_ring(m, solid, seed=0, lo=0.05, hi=0.95):
    """Mark the FLUID sites of ``m`` that have a site of ``solid`` among
    their 8 neighbours FLUID_NEAR_WALL (in place), and return the [8, X, Y]
    thetas: each link q of a ring site whose upstream site x - c_q lies in
    ``solid`` gets a seeded theta in (lo, hi) - both branches of the
    interpolation - and every other link -1 (plain streaming)."""
    from tnl_lbm_tpu_torch.models import D2Q9

    X, Y = m.shape
    pad = np.pad(solid, 1)
    near = np.zeros_like(solid)
    upstream = []
    for q in range(1, D2Q9.Q):
        cx, cy = (int(c) for c in D2Q9.c[q])
        up = pad[1 - cx : 1 - cx + X, 1 - cy : 1 - cy + Y]  # solid at x - c_q
        upstream.append(up)
        near |= up
    ring = near & (m == GEO.FLUID)
    m[ring] = GEO.FLUID_NEAR_WALL
    rng = np.random.default_rng(seed)
    bz = np.full((8,) + m.shape, -1.0, np.float32)
    for q, up in enumerate(upstream):
        hit = ring & up
        bz[q][hit] = rng.uniform(lo, hi, int(hit.sum())).astype(np.float32)
    return bz


def disk(shape, center, radius):
    """The sites strictly within ``radius`` of ``center`` (the golden
    geometries' disks, scripts/make_golden_geometries.py)."""
    xs, ys = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]), indexing="ij")
    return np.hypot(xs - center[0], ys - center[1]) < radius


def case_2d(kind, shape=(16, 16), seed=0):
    """(map, periodic, thetas or None) of the D2Q9 compares: sim2d_2's
    channel (JAX tests/test_fused_2d.py:16-33: INFLOW, OUTFLOW_RIGHT, walls
    and NOTHING rows), the same with a WALL block inside a Bouzidi ring, the
    periodic-x channel between walls of the body-force runs, and a box of
    every code B5 takes, with an obstacle on the fluid part of the y = 0 edge
    whose ring sites there read clamped neighbours."""
    X, Y = shape
    m = np.zeros(shape, np.uint8)
    if kind == "periodic":
        m[:, 0] = m[:, -1] = GEO.WALL
        return m, (True, False), None
    if kind in ("channel", "bouzidi"):
        m[:, 1] = m[:, Y - 2] = GEO.WALL
        m[:, 0] = m[:, Y - 1] = GEO.NOTHING
        m[0, 2 : Y - 2] = GEO.INFLOW
        m[X - 1, 2 : Y - 2] = GEO.OUTFLOW_RIGHT
        if kind == "channel":
            return m, (False, False), None
        solid = np.zeros(shape, bool)
        solid[4:6, 5:9] = True
        m[solid] = GEO.WALL
        return m, (False, False), bouzidi_ring(m, solid, seed)
    assert kind == "box", kind
    m[:, Y - 1] = GEO.WALL
    m[: X // 2, 0] = GEO.NOTHING
    m[0, 1 : Y // 2], m[0, Y // 2 : Y - 1] = GEO.INFLOW, GEO.OUTFLOW_EQ
    m[X - 1, 1 : Y - 1] = GEO.OUTFLOW_RIGHT
    m[X // 2, Y // 2] = GEO.NOTHING
    solid = disk(shape, (X // 3, Y // 2), max(2.5, Y / 8)) | disk(shape, (2 * X // 3, 0), 2.5)
    m[solid] = GEO.WALL
    return m, (False, False), bouzidi_ring(m, solid, seed)


def parabolic_2d(Y, umax=0.05):
    """sim2d_2's inflow profile shape as a [2, 1, Y] float64 array."""
    s = np.clip((np.arange(Y) - 1) / max(Y - 3, 1), 0.0, 1.0)
    prof = np.zeros((2, 1, Y))
    prof[0, 0] = umax * 4 * s * (1 - s)
    return prof


def seeded_2d(cfg, shape, device, seed=0):
    """A seeded near-equilibrium D2Q9 state (JAX tests/test_fused_2d.py:36-40)."""
    rng = np.random.default_rng(seed)
    rho = torch.from_numpy((1 + 0.01 * rng.standard_normal(shape)).astype(np.float32))
    u = torch.from_numpy((0.02 * rng.standard_normal((2,) + shape)).astype(np.float32))
    return cfg.eq(cfg.lat, rho, u).float().contiguous().to(device)


def timing_disk_2d(dom, seed=0):
    """sim2d_3's channel ``dom`` at resolution r with geometry 1's disk
    (scripts/make_golden_geometries.py: centre (32, 16), radius 4) scaled by
    r, as WALL, in a one-site Bouzidi ring (``bouzidi_ring``); sets
    ``dom.bouzidi``."""
    X, Y = dom.shape
    r = X // 128
    solid = disk(dom.shape, (32 * r, 16 * r), 4 * r)
    dom.map[solid] = GEO.WALL
    dom.bouzidi = bouzidi_ring(dom.map, solid, seed)
    return dom


#: the resident chunk's compares (B5, ``FusedChunk2D``): sim2d_3's channel at
#: a resolution with geometry 1's disk in a Bouzidi ring and the inflow
#: profile ("ring"), the same map without its thetas and with the inflow
#: vector ("ring_plain"), and a box periodic in x and y around the disk in
#: its ring ("periodic", no inflow)
RESIDENT_KINDS = ("ring", "ring_plain", "periodic")
#: its kernel instances: (collision, a body force was passed)
RESIDENT_INSTANCES = (("SRT", False), ("SRT", True), ("CLBM", False))


def resident_case_2d(kind, res):
    """(map, periodic, thetas or None) of a ``RESIDENT_KINDS`` case at
    sim2d_3's resolution ``res`` (128 res x 32 res)."""
    from tnl_lbm_tpu_torch.apps import sim2d_3

    dom = timing_disk_2d(sim2d_3.channel_domain(sim2d_3.channel_units(res), None, False))
    if kind == "ring":
        return dom.map, (False, False), dom.bouzidi
    if kind == "ring_plain":
        return dom.map, (False, False), None
    assert kind == "periodic", kind
    m = np.zeros(dom.shape, np.uint8)
    solid = disk(dom.shape, (32 * res, 16 * res), 4 * res)
    m[solid] = GEO.WALL
    return m, (True, True), bouzidi_ring(m, solid)


def resident_inflow(kind, Y, device):
    """The inflow of a ``RESIDENT_KINDS`` case: sim2d_3's [2, 1, Y] profile on
    ``device``, the vector ``U_IN_2D``, or None."""
    if kind == "ring":
        return torch.tensor(parabolic_2d(Y), dtype=torch.float32, device=device)
    return U_IN_2D if kind == "ring_plain" else None


def resident_route(sim):
    """The 2D run ``sim`` (built, before ``sim_init``) with each dispatch
    chunk that has no statistics window run as one launch of B5's resident
    chunk (``FusedChunk2D``, ``sim.resident`` after sim_init) in place of
    its per-step launches, for the checks and timings of that kernel in a
    run; ``Simulation`` itself runs its chunks per step.  The state ends in
    the buffer the per-step ping-pong leaves it in; on the card a CUDA graph
    captures the one launch and each replay adds it to the chunk's count.
    A subclass, so no closure holds the run."""
    from tnl_lbm_tpu_torch.kernels.fused_2d import FusedChunk2D

    class Resident(type(sim)):
        def sim_init(self):
            super().sim_init()
            self.resident = FusedChunk2D(self._step)

        def _chunk(self, n_steps, nu, u_in, force, pairs, s1, s2):
            if pairs or s1 or s2:
                return super()._chunk(n_steps, nu, u_in, force, pairs, s1, s2)
            f_new, _, _ = self.resident(self.f, nu, n_steps, u_in=u_in, force=force,
                                        out=self._spare, macro_out=(self.rho, self.u))
            if f_new is not self.f:  # an odd chunk: the state is in the spare
                self._spare, self.f = self.f, f_new
            return None

        def _capture(self, key, *args):
            kernel = self.resident.kernel
            before = kernel.launches
            entry = super()._capture(key, *args)
            entry.launches.append((kernel, kernel.launches - before))
            kernel.launches = before  # the capture ran nothing: a replay counts it
            return entry

    sim.__class__ = Resident
    return sim


def compress_statistics(sim, start: int = 2):
    """sim2d_2's statistics state machine in a few dozen steps from step
    ``start`` (JAX tests/test_sim2d_2.py:24-33 uses start = 2): the mean
    accumulates for 8 steps and freezes at its deadline, fluctuations
    accumulate after 2 more, every check counts as stable, and the TKE is
    exported on the second; the run ends by step start + 58."""
    dt = sim.domain.units.phys_dt
    sim.steps_per_dispatch = 1
    sim.stats_start_time = start * dt
    sim.stats_end_time = (start + 8) * dt     # deadline freeze (skip stabilization)
    sim.mean_min_time = 1e9                   # never stabilize via the check
    sim.fluc_min_time = 2 * dt
    sim.fluc_check_period = dt
    sim.fluc_stable_required = 2
    sim.fluc_rel_tol = 1e9                    # any check counts as stable
    sim.phys_final_time = (start + 58) * dt


# ------------------------------------------------------------ non-Newtonian

#: the rheologies of the JAX suite (tests/test_non_newtonian.py:127-155,
#: tests/test_fused_nn_step.py:53-100) and of scripts/bench_hooked.py:56-69
NN_MODELS = {"cy": CarreauYasuda(nu0=0.1, lam=1.0, a=2.0, n=0.5),
             "casson": Casson(k0=0.05, k1=0.02),
             "cy_obstacle": CarreauYasuda(nu0=0.08, lam=2.0, a=1.7, n=0.6)}
NN_KINDS = ("duct", "periodic", "obstacle")
#: the blunted-profile channel (JAX tests/test_non_newtonian.py:42-78) with
#: its hook wrapped as the domain: the shape factor u_x[Z//2] / mean(u_x[1:-1])
#: at x = y = 0 after 3000 steps from rest (and one more, whose u is read),
#: CUM_WELL in float32; the JAX XLA step gives these for the Newtonian and
#: the Carreau-Yasuda run
BLUNT_SHAPE, BLUNT_NU, BLUNT_FORCE, BLUNT_STEPS = (4, 4, 21), 0.05, (5e-6, 0.0, 0.0), 3000
BLUNT_MODEL = CarreauYasuda(nu0=0.5, lam=500.0, a=2.0, n=0.3)
BLUNT_JAX = {"newtonian": 1.49760, "carreau_yasuda": 1.48458}


def nn_case(kind, shape=None):
    """(map, domain periodic, model name, hook periodic) of the NN compares:
    the wall duct with a periodic x (walls on the y and z faces, CY), the
    fully periodic fluid box with a ragged Z (Casson) and the closed box
    with an interior obstacle and no periodic axis (CY, the hook's default
    edge replication)."""
    if kind == "duct":
        m = np.zeros(shape or (12, 20, 40), np.uint8)
        m[:, 0] = m[:, -1] = GEO.WALL
        m[:, :, 0] = m[:, :, -1] = GEO.WALL
        return m, (True, False, False), "cy", (True, False, False)
    if kind == "periodic":
        return np.zeros(shape or (8, 16, 37), np.uint8), (True, True, True), "casson", \
            (True, True, True)
    assert kind == "obstacle", kind
    m = np.zeros(shape or (12, 20, 40), np.uint8)
    m[:, 4:6, 3:5] = GEO.WALL
    m[5:7, 12:15, 20:24] = GEO.WALL
    return m, (False, False, False), "cy_obstacle", None


def nn_state(shape, seed=0):
    """Seeded (rho, u) as float32 numpy arrays (JAX
    tests/test_fused_nn_step.py:31-33: u at 0.03)."""
    rng = np.random.default_rng(seed)
    return ((1 + 0.01 * rng.standard_normal(shape)).astype(np.float32),
            (0.03 * rng.standard_normal((len(shape),) + tuple(shape))).astype(np.float32))


def blunt_channel():
    """(map, periodic) of the blunted-profile channel: walls on the z faces,
    periodic x and y."""
    m = np.zeros(BLUNT_SHAPE, np.uint8)
    m[:, :, 0] = m[:, :, -1] = GEO.WALL
    return m, (True, True, False)


def shape_factor(ux) -> float:
    """u_x[Z//2] / mean(u_x[1:-1]) of a profile along z (1.5 for a parabola)."""
    ux = np.asarray(ux, np.float64)
    return float(ux[len(ux) // 2] / ux[1:-1].mean())


#: the gap between two routes' medians above which a pick of the slower one
#: is a fault of the "auto" probe
ROUTE_GAP = 0.1


def separated_faster(a, b, gap=ROUTE_GAP):
    """Which of two routes is faster where their own chain times (ms lists)
    separate them: 0 (a) or 1 (b) when every chain of that route is faster
    than every chain of the other and the medians differ by more than
    ``gap``; None otherwise (overlapping chains: launch-bound noise, no
    verdict)."""
    ma, mb = float(np.median(a)), float(np.median(b))
    if max(a) < min(b) and mb > ma * (1 + gap):
        return 0
    if max(b) < min(a) and ma > mb * (1 + gap):
        return 1
    return None


def chain_range(chains) -> str:
    """'min-max' of chain times in ms."""
    return f"{min(chains):.4f}-{max(chains):.4f}"


CSRC = Path(__file__).resolve().parents[1] / "tnl_lbm_tpu_torch" / "csrc"
#: the card's streaming multiprocessors (an H100 SXM), for the x segment rule
H100_SMS = 132


def source_constants(name: str) -> dict:
    """The integer constants of a kernel source under csrc/ (each a number,
    or a sum, product or quotient of the ones before it)."""
    consts: dict = {}
    for decl in re.findall(r"^\s*constexpr int ([^;]+);", (CSRC / name).read_text(), re.M):
        for item in decl.split(","):
            if "=" not in item:
                continue
            key, expr = (v.strip() for v in item.split("=", 1))
            if re.fullmatch(r"[\w +*/()-]+", expr) and "sizeof" not in expr:
                # C's integer division is Python's floor division on these
                try:
                    consts[key] = eval(expr.replace("/", "//"), {}, dict(consts))  # noqa: S307
                except NameError:  # built on a byte count
                    pass
    return consts


def march_constants() -> dict:
    """csrc/pair_march.cuh's constants, with its byte counts of float32."""
    k = source_constants("pair_march.cuh")
    k["ROW_BYTES"] = 16 + (k["TZ"] * 4 + 4 + 15) // 16 * 16
    k["RING_BYTES"] = k["RING_GROUPS"] * k["GROUP"] * k["WSITES"] * 4
    k["OUT_RING_BYTES"] = 3 * k["OUT_GROUPS"] * k["GROUP"] * k["WSITES"] * 4
    k["OUT_SMEM_BYTES"] = k["OUT_RING_BYTES"] + k["CODE_BYTES"]
    k["STAGE_OFFSET"] = (k["RING_BYTES"] + k["CODE_BYTES"] + 127) // 128 * 128
    return k


def seg_len(X: int, Y: int, Z: int, sms: int = H100_SMS) -> int:
    """The march's automatic x segment (csrc/pair_march.cuh auto_seg_len)."""
    k = march_constants()
    cols = -(-Y // k["TY"]) * -(-Z // k["TZ"])
    segs = max(1, min(X, -(-sms // cols)))
    return min(k["SEG_MAX"], -(-X // segs))


def p2a_geometry(shape, load: str, sms: int = H100_SMS) -> dict:
    """P2a's launch (csrc/probes.cu tnl_lbm_pair_pipeline_info) from the
    sources' constants: the keys of ``probes.pipeline_geometry``."""
    k, p = march_constants(), source_constants("probes.cu")
    X, Y, Z = shape
    TY, TZ = k["TY"], k["TZ"]
    seg = seg_len(X, Y, Z, sms)
    ring_plane = -(-27 * k["WY"] * k["ROW_BYTES"] // 128) * 128
    staged = k["STAGE_OFFSET"] + k["NSTAGES"] * 27 * k["WY"] * k["ROW_BYTES"]
    smem = p["RING_PLANES"] * ring_plane if load == "ring" else staged
    boxed = sum(y0 >= 1 and y0 + TY < Y and z0 >= 1 and z0 + TZ < Z
                for y0 in range(0, Y, TY) for z0 in range(0, Z, TZ))
    return {"smem_bytes": smem, "threads": k["THREADS"] + p["PRODUCER"], "seg_len": seg,
            "segments": -(-X // seg), "columns": -(-Y // TY) * -(-Z // TZ),
            "plane_buffers": {"stages": k["NSTAGES"], "direct": p["DIRECT_PLANES"],
                              "ring": p["RING_PLANES"]}[load],
            "boxed_columns": boxed if load == "ring" else 0}
