"""The schedule of the non-Newtonian kernels' x-marching pipeline
(csrc/nn_site.cuh, shared by the NN force B9 and the one-kernel NN step B10)
as a numpy model, on the CPU.

The model reads the header's integer constants, so a change of the tile,
the rings or the lags keeps it honest, and runs the march block by block,
step by step, as the kernels do: u (or u*) and the fluid mask of the
incoming plane into the u ring, S of the plane ``S_LAG`` behind into the S
ring, F of the plane ``F_LAG`` behind from the rings, each at the slot
coordinates the kernels compute.  It checks that the column tiles and x
segments cover every site once, that each slot holds its coordinate's
value wrapped or clamped under the hook's periodicity, that every ring
plane is read only after the barrier that ends its writer's step and
rewritten only after its last reader's, and that F through the rings is the
plain hook's (``ops/non_newtonian.py``).
"""

import dataclasses
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.models import D3Q27
from tnl_lbm_tpu_torch.ops import non_newtonian as pnn
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim import make_step

from torch_cases import NN_MODELS, nn_state

CSRC = Path(__file__).resolve().parents[1] / "tnl_lbm_tpu_torch" / "csrc"
NU = 0.02


def march_constants(kernel) -> dict:
    """The integer constants of csrc/nn_site.cuh (each a number, or an
    expression of the ones before it) as ``kernel`` includes it: the column
    tile's height NN_TY is the including source's (nn_force.cu for B9,
    "force"; nn_step.cu for B10, "step")."""
    source = (CSRC / f"nn_{kernel}.cu").read_text()
    consts = {"NN_TY": int(re.search(r"^#define NN_TY (\d+)", source, re.M).group(1))}
    for decl in re.findall(r"^constexpr int ([^;]+);", (CSRC / "nn_site.cuh").read_text(), re.M):
        for item in decl.split(","):
            name, expr = (v.strip() for v in item.split("=", 1))
            # C's integer division is Python's floor division on these
            consts[name] = eval(expr.replace("/", "//"), {}, dict(consts))  # noqa: S307
    return consts


#: the constants each kernel compiles with; K holds those they share
KERNEL_K = {kernel: march_constants(kernel) for kernel in ("force", "step")}
K = KERNEL_K["force"]


def tile(kernel):
    """The column tile of B9 ("force") or B10 ("step")."""
    return {n: KERNEL_K[kernel][n] for n in ("TY", "TZ", "THREADS", "UY", "UZ", "SY", "SZ",
                                             "U_SLOTS", "S_SLOTS")}


def canonical(g, n, periodic):
    """nn_site.cuh canonical over an array: wrapped or clamped into [0, n)."""
    return np.mod(g, n) if periodic else np.clip(g, 0, n - 1)


def clamped(g, n, periodic):
    """nn_site.cuh clamped: clamped on a non-periodic axis, kept otherwise."""
    return g if periodic else np.clip(g, 0, n - 1)


def wall_aware(gp, gm, c, flp, flm):
    return np.where(flp & flm, 0.5 * (gp - gm),
                    np.where(flp, gp - c, np.where(flm, c - gm, 0.0)))


def thread_slots(slots, NT, slot_of):
    """The slots of one plane that NT threads take (nn_site.cuh passes,
    u_slot_of, s_slot_of), in thread order."""
    t = np.arange(NT)
    got = np.concatenate([slot_of(t, k, NT) for k in range(-(-slots // NT))])
    return got[got < slots]


def u_slot_of(t, k, NT):
    return k * NT + t


def s_slot_of(t, k, NT):
    return t if k == 0 else k * NT + (NT - 1 - t)


class Ring:
    """A ring of planes in shared memory: which plane each holds, the step
    whose barrier makes it readable and the last step that read it."""

    def __init__(self, name, planes, shape):
        self.name = name
        self.data = np.full((planes,) + shape, np.nan)
        self.plane = [None] * planes
        self.ready = [None] * planes
        self.last_read = [-(10**9)] * planes
        self.events = []  # (ring, written from step, previous content last read at)

    def write(self, p, step, value):
        """Plane p stored in ``step``, readable after that step's barrier."""
        b = p % len(self.plane)
        self.events.append((self.name, step, self.last_read[b]))
        self.data[b] = value
        self.plane[b], self.ready[b] = p, step
        self.last_read[b] = -(10**9)

    def read(self, p, step):
        b = p % len(self.plane)
        # the plane is there, made readable by the barrier that ended an
        # earlier step (one block barrier a step, none within)
        assert self.plane[b] == p and self.ready[b] < step, (self.name, p, step)
        self.last_read[b] = max(self.last_read[b], step)
        return self.data[b]


def march(u, rho, fluid, hook_per, seg_len, model, kernel="force"):
    """The march of nn_site.cuh over every block: F [3, X, Y, Z], how often
    each site was the tile's, and each ring's (write step, previous
    content's last read step) events.  ``u`` and ``rho`` are the sources of
    the u ring and of F's rho, float64.  ``kernel`` "force" is B9's march:
    rho from global memory, F stored by the step; "step" is B10's: rho0
    from its ring, F taken by the site update in the same step.  Both store
    u (B10: u*) of the incoming plane in the step."""
    G = tile(kernel)
    TY, TZ, UY, UZ, SY, SZ = (G[n] for n in ("TY", "TZ", "UY", "UZ", "SY", "SZ"))
    SL, FL = K["S_LAG"], K["F_LAG"]
    X, Y, Z = fluid.shape
    px, py, pz = hook_per
    F = np.full((3, X, Y, Z), np.nan)
    count = np.zeros((X, Y, Z), np.int64)
    events = []
    assert sorted(thread_slots(G["U_SLOTS"], G["THREADS"], u_slot_of)) == list(range(UY * UZ))
    assert sorted(thread_slots(G["S_SLOTS"], G["THREADS"], s_slot_of)) == list(range(SY * SZ))
    nzt = -(-Z // TZ)
    for col in range(-(-Y // TY) * nzt):
        y0, z0 = (col // nzt) * TY, (col % nzt) * TZ
        # the u slots' coordinates, fixed for the march (nn_site.cuh march)
        uy = canonical(y0 + np.arange(UY) - 2, Y, py)
        uz = canonical(z0 + np.arange(UZ) - 2, Z, pz)
        # each S slot's u slot: its coordinate clamped on a closed axis
        sy = clamped(y0 + np.arange(SY) - 1, Y, py) - y0 + 2
        sz = clamped(z0 + np.arange(SZ) - 1, Z, pz) - z0 + 2
        ly, lz = np.arange(TY), np.arange(TZ)
        mine_y, mine_z = y0 + ly < Y, z0 + lz < Z
        yy, zz = (y0 + ly)[mine_y], (z0 + lz)[mine_z]
        for xs in range(0, X, seg_len):
            L = min(xs + seg_len, X) - xs
            ru = Ring("u", K["U_PLANES"], (3, UY, UZ))
            rf = Ring("mask", K["U_PLANES"], (UY, UZ))
            rs = Ring("S", K["S_PLANES"], (6, SY, SZ))
            rr = Ring("rho", K["RHO_PLANES"], (TY, TZ))
            for j in range(L + FL + 2):
                if j < L + 4:  # u (B10: u*), the mask and rho0 (B10) of plane j
                    x = canonical(xs - 2 + j, X, px)
                    ru.write(j, j, u[:, x][:, uy][:, :, uz])
                    rf.write(j, j, fluid[x][uy][:, uz])
                    if kernel == "step":
                        rr.write(j, j, rho[x][uy[2:2 + TY]][:, uz[2:2 + TZ]])
                q = j - SL
                if 1 <= q <= L + 2:  # S of plane q
                    up = [ru.read(q + d, j) for d in (-1, 0, 1)]
                    fp = [rf.read(q + d, j) for d in (-1, 0, 1)]
                    rs.write(q, j, strain(up, fp, sy, sz))
                p = j - FL
                if 2 <= p <= L + 1:  # F of plane p (x = xs + k)
                    k = p - 2
                    x = xs + k
                    pm = p if (not px and x == 0) else p - 1
                    pp = p if (not px and x == X - 1) else p + 1
                    S = [rs.read(pm, j), rs.read(p, j), rs.read(pp, j)]
                    fl = [rf.read(p + d, j) for d in (-1, 0, 1)]
                    if kernel == "force":  # rho from global memory
                        rho_p = rho[x][canonical(y0 + ly, Y, py)][:, canonical(z0 + lz, Z, pz)]
                    else:  # rho0 from its ring
                        rho_p = rr.read(p, j)
                    Fp = force(S, fl, rho_p, model)
                    F[:, x, yy[:, None], zz[None, :]] = Fp[:, mine_y][:, :, mine_z]
                    count[x, yy[:, None], zz[None, :]] += 1
            for r in (ru, rf, rs, rr):
                events += r.events
    return F, count, events


def strain(up, fp, sy, sz):
    """S [6, SY, SZ] of one plane from u planes (x - 1, x, x + 1) and their
    masks, at the S slots' u slots (nn_site.cuh strain_plane)."""
    cy, cz = sy[:, None], sz[None, :]

    def at(plane, d):  # neighbour d along axis a of the S slots' u slots
        a, s = d
        src = plane[1 + s] if a == 0 else plane[1]
        return src[..., cy + (s if a == 1 else 0), cz + (s if a == 2 else 0)]

    g = [[wall_aware(at([v[b] for v in up], (a, 1)), at([v[b] for v in up], (a, -1)),
                     at([v[b] for v in up], (a, 0)), at(fp, (a, 1)) != 0, at(fp, (a, -1)) != 0)
          for b in range(3)] for a in range(3)]
    return np.stack([g[0][0], 0.5 * (g[0][1] + g[1][0]), 0.5 * (g[0][2] + g[2][0]), g[1][1],
                     0.5 * (g[1][2] + g[2][1]), g[2][2]])


def sidx(a, b):
    a, b = min(a, b), max(a, b)
    return b if a == 0 else (2 + b if a == 1 else 5)


def force(S, fl, rho, model):
    """F [3, TY, TZ] of one plane's tile from S planes (x - 1, x, x + 1),
    read at the tile's S slots, the masks of planes x - 1 .. x + 1 at its
    u slots and rho (nn_site.cuh force_at)."""
    TY, TZ = S[1].shape[1] - 2, S[1].shape[2] - 2
    ys, zs = slice(1, 1 + TY), slice(1, 1 + TZ)
    yu, zu = slice(2, 2 + TY), slice(2, 2 + TZ)

    def s_at(k, a, s):
        plane = S[1 + s] if a == 0 else S[1]
        return plane[k, 1 + (s if a == 1 else 0):1 + TY + (s if a == 1 else 0),
                     1 + (s if a == 2 else 0):1 + TZ + (s if a == 2 else 0)]

    def fl_at(a, s):
        plane = fl[1 + s] if a == 0 else fl[1]
        return plane[2 + (s if a == 1 else 0):2 + TY + (s if a == 1 else 0),
                     2 + (s if a == 2 else 0):2 + TZ + (s if a == 2 else 0)] != 0

    s0 = S[1][:, ys, zs]
    gamma = np.sqrt(s0[0] ** 2 + s0[3] ** 2 + s0[5] ** 2
                    + 2 * (s0[1] ** 2 + s0[2] ** 2 + s0[4] ** 2))
    nu_eff = model(NU, torch.from_numpy(gamma)).numpy() if isinstance(
        model, pnn.Casson) else model(NU, gamma)
    fluid = fl[1][yu, zu] != 0
    out = []
    for b in range(3):
        div = sum(wall_aware(s_at(sidx(a, b), a, 1), s_at(sidx(a, b), a, -1),
                             s_at(sidx(a, b), a, 0), fl_at(a, 1), fl_at(a, -1))
                  for a in range(3))
        out.append(np.where(fluid, 2 * (nu_eff - NU) * div * rho, 0.0))
    return np.stack(out)


def plain_hook(model, hook_per, rho, u, fluid):
    hook = pnn.make_nn_forcing_hook(model, periodic=hook_per)
    return hook(D3Q27, torch.from_numpy(rho), torch.from_numpy(u), NU,
                torch.from_numpy(fluid)).numpy()


def seeded_map(shape, seed):
    """A seeded map of FLUID sites with WALL and INFLOW sites among them."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([GEO.FLUID] * 6 + [GEO.WALL, GEO.INFLOW], np.uint8), shape)


#: the marches the model runs: B9's and B10's
MARCHES = ("force", "step")


def check_march(shape, hook_per, seg_len, model, seed=3):
    m = seeded_map(shape, seed)
    rho, u = (a.astype(np.float64) for a in nn_state(shape, seed))
    fluid = m == GEO.FLUID
    want = plain_hook(model, hook_per, rho, u, fluid)
    for kernel in MARCHES:
        F, count, events = march(u, rho, fluid, hook_per, seg_len, model, kernel)
        assert (count == 1).all(), kernel
        # every ring plane rewritten only after the barrier that ended its
        # last reader's step
        assert all(read < written for _, written, read in events), \
            [e for e in events if e[2] >= e[1]][:5]
        np.testing.assert_allclose(F, want, rtol=0, atol=1e-12 * np.abs(want).max())


_PERIODIC = list(itertools.product([False, True], repeat=3))


def test_march_constants():
    """The header's geometry: one thread a tile site, rings as deep as the
    lags need, and the shared memory the doc states, within an SM's at the
    blocks per SM of each kernel's launch bound (B9 8 x 32 at three, B10
    16 x 32 at one)."""
    force, step = KERNEL_K["force"], KERNEL_K["step"]
    assert (force["TY"], step["TY"], K["TZ"]) == (8, 16, 32)
    assert (force["FORCE_SMEM_BYTES"], step["STEP_SMEM_BYTES"]) == (69424, 130480)
    for k, smem, blocks in ((force, "FORCE_SMEM_BYTES", "FORCE_BLOCKS_PER_SM"),
                            (step, "STEP_SMEM_BYTES", "STEP_BLOCKS_PER_SM")):
        assert k["THREADS"] == k["TY"] * k["TZ"] and k["THREADS"] % 32 == 0
        assert (k["UY"], k["UZ"], k["SY"], k["SZ"]) == (k["TY"] + 4, k["TZ"] + 4, k["TY"] + 2,
                                                        k["TZ"] + 2)
        assert k[blocks] * (k[smem] + 1024) <= 228 * 1024
    assert step["STEP_BLOCKS_PER_SM"] * step["THREADS"] * 128 <= 65536  # 128 registers a thread


@pytest.mark.parametrize("kernel", MARCHES)
def test_slot_table_holds_every_coordinate_the_guard_admits(kernel):
    """Each u slot's canonical (y, z) is packed as y << 16 | z into the
    header's table type, and the C entry refuses a Y or Z above its guard:
    up to the guard every y and z comes back from the packed entry, and its
    in-plane offset y Z + z stays in the plane (a signed table would turn
    every y from 32768 on negative)."""
    header = (CSRC / "nn_site.cuh").read_text()
    kind = re.search(r"^\s+(\w+)\* uyz;", header, re.M).group(1)
    dtype = {"unsigned": np.uint32, "int": np.int32}[kind]
    guard = re.search(r"if \(Y > (\d+) \|\| Z > (\d+)\)", (CSRC / f"nn_{kernel}.cu").read_text())
    Y, Z = int(guard.group(1)), int(guard.group(2))
    y = np.arange(Y, dtype=np.int64)
    for z in (0, Z - 1):
        with np.errstate(over="ignore"):
            packed = (y.astype(dtype) << dtype(16)) | dtype(z)
        got_y, got_z = (packed >> dtype(16)).astype(np.int64), (packed & dtype(0xFFFF)).astype(
            np.int64)
        np.testing.assert_array_equal(got_y, y)
        assert (got_z == z).all()
        offset = got_y * Z + got_z
        assert offset.min() >= 0 and offset.max() < Y * Z


@pytest.mark.parametrize("hook_per", _PERIODIC,
                         ids=["".join("p" if p else "c" for p in per) for per in _PERIODIC])
def test_march_force_equals_the_plain_hook(hook_per):
    """On a shape that no column tile and no x segment divides (two tiles
    along y and z, the last ragged; x segments of 4, 4 and 3 planes), per
    periodic combination of the hook: every site is the tile's once, every
    ring plane lives from its writer's barrier to its last reader's, and F
    through the rings equals the plain hook, a closed axis clamping the
    coordinate of u, of the mask and of S."""
    shape = (11, KERNEL_K["step"]["TY"] + 3, K["TZ"] + 8)
    check_march(shape, hook_per, 4, NN_MODELS["cy"])


@pytest.mark.parametrize("hook_per", [(False, False, False), (True, True, True)],
                         ids=["ccc", "ppp"])
def test_march_on_x_shorter_than_a_segment(hook_per):
    """X = 3 below the kernels' own segment, on a plane smaller than the
    tile (Casson)."""
    check_march((3, 5, 8), hook_per, K["SEG_MAX"], NN_MODELS["casson"])


@pytest.mark.parametrize("hook_per", _PERIODIC,
                         ids=["".join("p" if p else "c" for p in per) for per in _PERIODIC])
def test_march_slots_hold_their_coordinates(hook_per):
    """Each u, mask and S slot of every plane a block keeps holds the value
    at its coordinate wrapped or clamped under the hook's periodicity (S on
    every plane in the domain or across a periodic x; the S of a closed x
    face's outer plane is never read), for both kernels' tiles."""
    for kernel in MARCHES:
        check_slots(kernel, hook_per)


def check_slots(kernel, hook_per):
    G = tile(kernel)
    TY, TZ, UY, UZ, SY, SZ = (G[n] for n in ("TY", "TZ", "UY", "UZ", "SY", "SZ"))
    shape = (6, KERNEL_K["step"]["TY"] + 3, TZ + 5)
    X, Y, Z = shape
    rho, u = (a.astype(np.float64) for a in nn_state(shape, 5))
    fluid = seeded_map(shape, 5) == GEO.FLUID
    S_plain = pnn.strain_rate_tensor(torch.from_numpy(u), torch.from_numpy(fluid), 3, hook_per)
    S_plain = np.stack([S_plain[(a, b)].numpy() for a in range(3) for b in range(a, 3)])
    px, py, pz = hook_per
    nzt = -(-Z // TZ)
    for col in range(-(-Y // TY) * nzt):
        y0, z0 = (col // nzt) * TY, (col % nzt) * TZ
        uy = canonical(y0 + np.arange(UY) - 2, Y, py)
        uz = canonical(z0 + np.arange(UZ) - 2, Z, pz)
        sy = clamped(y0 + np.arange(SY) - 1, Y, py) - y0 + 2
        sz = clamped(z0 + np.arange(SZ) - 1, Z, pz) - z0 + 2
        for xs in range(0, X, 4):
            planes = range(min(xs + 4, X) - xs + 4)
            xg = [xs - 2 + p for p in planes]
            u_ring = {p: u[:, canonical(x, X, px)][:, uy][:, :, uz] for p, x in zip(planes, xg)}
            f_ring = {p: fluid[canonical(x, X, px)][uy][:, uz] for p, x in zip(planes, xg)}
            for p, x in zip(planes, xg):
                want_y = canonical(y0 + np.arange(UY) - 2, Y, py)
                want_z = canonical(z0 + np.arange(UZ) - 2, Z, pz)
                np.testing.assert_array_equal(u_ring[p], u[:, canonical(x, X, px)][:, want_y]
                                              [:, :, want_z])
                if not 1 <= p <= len(planes) - 2 or not (px or 0 <= x < X):
                    continue
                got = strain([u_ring[p + d] for d in (-1, 0, 1)],
                             [f_ring[p + d] for d in (-1, 0, 1)], sy, sz)
                cy = canonical(clamped(y0 + np.arange(SY) - 1, Y, py), Y, py)
                cz = canonical(clamped(z0 + np.arange(SZ) - 1, Z, pz), Z, pz)
                want = S_plain[:, canonical(x, X, px)][:, cy][:, :, cz]
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def test_march_uses_the_hooks_periodicity_for_b10():
    """B10's ring holds u* at the hook's coordinates while the DF reads
    follow the domain's: on a channel with walls on the y faces, periodic
    in x, with the hook wrapping z where the domain does not, F from the
    plain u* pass through the rings equals the plain hook on that u*, rho0
    from the rho ring."""
    m = np.zeros((9, 11, 37), np.uint8)
    m[:, 0] = m[:, -1] = GEO.WALL
    periodic, hook_per, model = (True, False, False), (True, False, True), "cy"
    dom = interop.domain_from_numpy(m, periodic)
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AB")
    step = make_step(dataclasses.replace(cfg, forcing_hook=None), dom)
    rho, u = (torch.from_numpy(a) for a in nn_state(dom.shape, seed=5))
    f = cfg.eq(cfg.lat, rho, u).float()
    rho0, u0, fluid = step.ustar(f, force=(1e-5, 0.0, 0.0))
    rho0, u0 = rho0.double().numpy(), u0.double().numpy()
    fluid = fluid.numpy()
    want = plain_hook(NN_MODELS[model], hook_per, rho0, u0, fluid)
    F, count, events = march(u0, rho0, fluid, hook_per, 4, NN_MODELS[model], "step")
    assert (count == 1).all() and all(read < written for _, written, read in events)
    np.testing.assert_allclose(F, want, rtol=0, atol=1e-12 * np.abs(want).max())
    other = plain_hook(NN_MODELS[model], periodic, rho0, u0, fluid)
    assert np.abs(other - want).max() > 1e-3 * np.abs(want).max()  # the flags differ


@pytest.mark.parametrize("kernel", MARCHES)
def test_march_with_a_ring_too_shallow_is_caught(monkeypatch, kernel):
    """A u ring one plane shallower than the header's would let step j
    overwrite the mask plane that F of plane j - F_LAG still reads: the
    model's lifetime check catches it."""
    monkeypatch.setitem(K, "U_PLANES", K["U_PLANES"] - 1)
    shape = (9, 5, 8)
    rho, u = (a.astype(np.float64) for a in nn_state(shape, 1))
    fluid = np.ones(shape, bool)
    with pytest.raises(AssertionError):
        F, _, events = march(u, rho, fluid, (True, False, False), 6, NN_MODELS["cy"], kernel)
        assert all(read < written for _, written, read in events)
