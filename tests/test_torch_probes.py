"""The bandwidth probes of ``tnl_lbm_tpu_torch.kernels.probes`` on the CPU.

The JAX probe scripts fix a 256^3 TPU run and cannot be called at a small
size, so each plain version is held against a numpy transliteration of its
Pallas kernel body: ``scripts/profile_floor.py:24-33`` (P1) and
``scripts/probe_pair2_pipeline.py:58-61`` (P2a) and ``:136-140`` (P2b).
Both sides round every float32 operation, so they agree bit for bit.  The
schedule of P2b's persistent grid is checked in Python with the constants
of ``csrc/pair_march.cuh``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tnl_lbm_tpu_torch.kernels import probes

from torch_cases import march_constants

Q = 27
SHAPE = (6, 9, 37)  # no pair block divides it


def seeded(shape=SHAPE, seed=11):
    return np.random.default_rng(seed).standard_normal((Q,) + shape).astype(np.float32)


def np_copy_permute(f, macro):
    """profile_floor.py run_case's kernel."""
    rows = [f[Q - 1 - q] for q in range(Q)]
    fout = np.stack(rows)
    if not macro:
        return fout, None, None
    s = rows[0]
    for q in range(1, Q):
        s = s + rows[q]
    return fout, s, np.stack([s, s, s])


def np_passes(x, passes):
    """probe_pair2_pipeline.py's compute: ``x = x * 1.000001 + 1e-12``."""
    for _ in range(passes):
        x = x * np.float32(1.000001) + np.float32(1e-12)
    return x


@pytest.mark.parametrize("macro", [True, False])
def test_copy_permute_plain_matches_pallas_body(macro):
    f = seeded()
    got = probes.copy_permute(torch.from_numpy(f), with_macro=macro)
    for g, w in zip(got, np_copy_permute(f, macro)):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    assert probes.KERNELS["copy_permute"].launches == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("passes", [0, 3, 20])
def test_pair_pipeline_plain_matches_pallas_body(passes):
    f = seeded()
    for load in probes.PIPELINE_LOADS:  # every load path has the same function
        got = probes.pair_pipeline(torch.from_numpy(f), passes, load=load)
        # every block's columns, after the passes, land on their own sites
        np.testing.assert_array_equal(got.numpy(), np_passes(f, passes))
    assert passes == 0 or not np.array_equal(got.numpy(), f)
    assert all(probes.KERNELS[n].launches == 0 for _, n in probes.PIPELINE_LOADS.values())


@pytest.mark.parametrize("shape", [SHAPE, (2, 3, 5), (40, 11, 70)],
                         ids=["large", "smaller_than_a_block", "longer_than_a_segment"])
def test_pair_compute_only_plain_matches_pallas_body(shape):
    """The Pallas body's first program loads its tile, runs the passes and
    stores it; the port's first item is the march's first column tile
    (TY x TZ) over its first x segment (SEG_MAX planes), clipped to the
    domain."""
    k = march_constants()
    f = seeded(shape)
    tile = probes.pair_compute_only(torch.from_numpy(f), 20)
    bx, by, bz = probes.first_block(shape)
    assert (bx, by, bz) == tuple(min(t, n) for t, n in zip((k["SEG_MAX"], k["TY"], k["TZ"]),
                                                            shape))
    assert tile.shape == (Q, bx, by, bz)
    # only the first item's output is defined (the first program's)
    np.testing.assert_array_equal(tile.numpy(), np_passes(f[:, :bx, :by, :bz], 20))


def compute_only_runs(shape, blocks):
    """csrc/probes.cu p2b::compute's schedule in Python: the units (column
    tile planes, item by item) split into ``blocks`` equal runs, each walked
    item by item (``Items.locate``, ``length``); returns, per block, the
    (column, x) units it computes."""
    k = march_constants()
    X, Y, Z = shape
    seg = k["SEG_MAX"]
    ncol = -(-Y // k["TY"]) * -(-Z // k["TZ"])
    nseg = -(-X // seg)
    last = X - (nseg - 1) * seg
    units = ncol * X
    full = (nseg - 1) * ncol * seg

    def locate(u):
        if u < full:
            return u // seg, u % seg
        return (nseg - 1) * ncol + (u - full) // last, (u - full) % last

    runs = []
    for b in range(blocks):
        u, u1 = units * b // blocks, units * (b + 1) // blocks
        run = []
        if u < u1:
            item, plane = locate(u)
            while u < u1:
                length = last if item // ncol == nseg - 1 else seg
                n = min(length - plane, u1 - u)
                run += [(item % ncol, (item // ncol) * seg + x) for x in range(plane, plane + n)]
                u, item, plane = u + n, item + 1, 0
        runs.append(run)
    return runs


@pytest.mark.parametrize("shape,blocks", [((256, 256, 256), 132 * 5), ((40, 11, 70), 7),
                                          ((6, 9, 37), 20), ((70, 8, 32), 3)])
def test_compute_only_runs_cover_every_column_plane_once(shape, blocks):
    """P2b's persistent grid: every (column tile, x plane) computed once,
    the runs within one unit of each other, and at 256^3 the first block's
    run starting with the whole first item (column 0, x < SEG_MAX), the
    only one stored."""
    k = march_constants()
    X, Y, Z = shape
    runs = compute_only_runs(shape, blocks)
    ncol = -(-Y // k["TY"]) * -(-Z // k["TZ"])
    done = [u for run in runs for u in run]
    assert sorted(done) == [(c, x) for c in range(ncol) for x in range(X)]
    assert len(done) == len(set(done))
    sizes = [len(r) for r in runs]
    assert max(sizes) - min(sizes) <= 1
    if shape == (256, 256, 256):
        assert runs[0][: k["SEG_MAX"]] == [(0, x) for x in range(k["SEG_MAX"])]
        assert sizes[0] in (99, 100)


def test_probes_share_the_pair_kernel_geometry():
    """P2a and P2b take the pair's x-march geometry from pair_march.cuh, as
    both pairs do (no copy of its constants): P2a its windows, P2b its
    column tiles and x segments; the first pair's pair_window.cuh is gone
    from the sources and the build."""
    from tnl_lbm_tpu_torch.kernels import build

    csrc = Path(probes.__file__).resolve().parents[1] / "csrc"
    src = (csrc / "probes.cu").read_text()
    assert '#include "pair_march.cuh"' in src and "pair_window" not in src
    assert not (csrc / "pair_window.cuh").exists() and "pair_window.cuh" not in build.HEADERS
    p2a = src[src.index("namespace p2a {"):src.index("}  // namespace p2a")]
    assert "M::TY" in p2a and "M::stage_row" in p2a and "window_site(" not in p2a
    assert not re.search(r"constexpr int (TY|TZ|WY|WZ|SEG_MAX)\b", p2a)
    p2b = src[src.index("namespace p2b {"):src.index("}  // namespace p2b")]
    for name in ("M::TY", "M::TZ", "M::SEG_MAX", "M::TILE_SITES"):
        assert name in p2b, name
    assert not re.search(r"constexpr int (TX|TY|TZ|WY|WZ|SEG_MAX|TILE_SITES)\b", p2b)
    k = march_constants()
    assert (probes.PAIR_SEG_MAX,) + probes.PAIR_COLUMN == (k["SEG_MAX"], k["TY"], k["TZ"])
    assert not hasattr(probes, "PROBE_TILE")
    for pair in ("aa_pair.cu", "aa_pair_full.cu"):
        pair_src = (csrc / pair).read_text()
        assert '#include "pair_march.cuh"' in pair_src and "pair_window.cuh" not in pair_src
        assert "pair_march<" in pair_src


def test_pair_pipeline_takes_the_march_geometry():
    """P2a's load paths and launch at 256^3 on an H100's 132 SMs, from the
    sources' constants: one block a column tile (8 x 32) and x segment (32
    planes), the pair's 11 window and 8 tile warps and the ring's producer
    warp; the staged rows and the direct path's two plane buffers after
    the pair's ring and codes as in B1, four TMA plane buffers; the ring
    takes 180 of the 256 columns by tensor boxes (those away from the y and
    z faces).  The windows read 1.41 sites a site."""
    from torch_cases import march_constants, p2a_geometry, source_constants

    codes = source_constants("probes.cu")
    assert {name: code for name, (code, _) in probes.PIPELINE_LOADS.items()} == {
        "stages": codes["LOAD_STAGES"], "direct": codes["LOAD_DIRECT"],
        "ring": codes["LOAD_RING"]}
    assert probes.PIPELINE_DEFAULT in probes.PIPELINE_LOADS
    for _, name in probes.PIPELINE_LOADS.values():
        assert probes.KERNELS[name].source.endswith("csrc/probes.cu")
    k = march_constants()
    geo = {load: p2a_geometry((256, 256, 256), load) for load in probes.PIPELINE_LOADS}
    assert {g["threads"] for g in geo.values()} == {640} == {k["THREADS"] + 32}
    assert {(g["seg_len"], g["segments"], g["columns"]) for g in geo.values()} == {(32, 8, 256)}
    assert [geo[n]["smem_bytes"] for n in ("stages", "direct", "ring")] == [198_272, 198_272,
                                                                            173_056]
    assert all(113 * 1024 < g["smem_bytes"] <= 227 * 1024 for g in geo.values())  # one block an SM
    assert [geo[n]["plane_buffers"] for n in ("stages", "direct", "ring")] == [2, 2, 4]
    assert geo["ring"]["boxed_columns"] == 30 * 6 and geo["stages"]["boxed_columns"] == 0
    reads = k["WSITES"] / k["TILE_SITES"] * (32 + 2) / 32
    assert abs(reads - 1.411) < 1e-3
    with pytest.raises(ValueError, match="load must be"):
        probes.pair_pipeline(torch.zeros((Q, 2, 2, 2)), 0, load="tma")


def test_probes_refuse_bad_state():
    with pytest.raises(ValueError):
        probes.copy_permute(torch.zeros((27, 2, 2, 2), dtype=torch.float64))
    with pytest.raises(ValueError):
        probes.pair_pipeline(torch.zeros((26, 2, 2, 2)), 0)
    with pytest.raises(ValueError):
        probes.pair_compute_only(torch.zeros((27, 4, 4, 4)).transpose(1, 2), 0)
    probes.reset_counts()
    assert all(k.launches == 0 for k in probes.KERNELS.values())


# ------------------------------------------------------------ P3, P4

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


def script_variants(name: str):
    """The variant list of a probe script's ``main()``, read from its
    source (the scripts run only on a TPU)."""
    import ast

    tree = ast.parse((SCRIPTS / name).read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    consts = {"TX": 16, "TY": 32}  # probe_dma_align.py:20, checked below
    for node in ast.walk(main):
        if isinstance(node, ast.For) and isinstance(node.iter, ast.List):
            return [ast.literal_eval(e) for e in node.iter.elts]
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "variants":
            src = ast.unparse(node.value)
            return eval(src, {}, consts)  # tuples of literals and TY
    raise AssertionError(f"no variant list in {name}")


def test_window_tables_mirror_the_scripts():
    src = (SCRIPTS / "probe_dma_align.py").read_text()
    assert "TX, TY = 16, 32" in src and (probes.DMA_TX, probes.DMA_TY) == (16, 32)
    assert list(probes.DMA_VARIANTS) == script_variants("probe_dma_align.py")
    assert list(probes.ELEMENT_VARIANTS) == script_variants("probe_element_pipeline.py")


def np_element_pipeline(fpad, tx, ty, passes):
    """probe_element_pipeline.py make's kernel, tile by tile: the window at
    (i tx, j ty), its interior rows after the passes, stored at (2 + i tx,
    8 + j ty); the ring stays as the output held it (NaN here)."""
    _, XP, YP, _ = fpad.shape
    X, Y = XP - 4, YP - 16
    out = np.full_like(fpad, np.nan)
    for i in range(X // tx):
        for j in range(Y // ty):
            win = fpad[:, i * tx : i * tx + tx + 4, j * ty : j * ty + ty + 16]
            out[:, 2 + i * tx : 2 + (i + 1) * tx, 8 + j * ty : 8 + (j + 1) * ty] = np_passes(
                win[:, 2 : 2 + tx, 8 : 8 + ty], passes)
    return out


@pytest.mark.parametrize("variant", [(8, 32, 0), (8, 32, 20), (16, 32, 0)])
def test_element_pipeline_plain_matches_pallas_body(variant):
    tx, ty, passes = variant
    fpad = np.random.default_rng(5).standard_normal((Q, 32 + 4, 64 + 16, 6)).astype(np.float32)
    got = probes.element_pipeline(torch.from_numpy(fpad), tx, ty, passes)
    want = np_element_pipeline(fpad, tx, ty, passes)
    np.testing.assert_array_equal(probes.interior(got).numpy(), want[:, 2:34, 8:72])
    assert not np.isnan(want[:, 2:34, 8:72]).any()
    assert probes.KERNELS["element_pipeline"].launches == 0


def np_element_march(fpad, tx, ty, passes):
    """csrc/probes.cu element_pipeline_kernel's schedule in numpy: block (j,
    g, q) marches over x segment g of y tile j's column, forwards or (odd
    g) backwards, each window plane copied once into the next ring buffer,
    the interior rows of every plane but the two halo planes at each end
    stored; returns the output and how often each element was stored."""
    _, XP, YP, Z = fpad.shape
    X, Y = XP - 4, YP - 16
    geo = probes.element_geometry(tx, ty, X, Z)
    out = np.full_like(fpad, np.nan)
    writes = np.zeros(fpad.shape, np.int32)
    ring = [None] * geo["stages"]
    for q in range(Q):
        for g in range(geo["segments"]):
            for j in range(Y // ty):
                t0 = g * geo["seg_tiles"]
                t1 = min(t0 + geo["seg_tiles"], X // tx)
                planes, first = (t1 - t0) * tx + 4, t0 * tx
                for k in range(planes):
                    px = first + (planes - 1 - k if g & 1 else k)
                    s = k % geo["stages"]
                    ring[s] = fpad[q, px, j * ty : j * ty + ty + 16].copy()
                    if first + 2 <= px < first + planes - 2:
                        rows = slice(j * ty + 8, j * ty + 8 + ty)
                        out[q, px, rows] = np_passes(ring[s][8 : 8 + ty], passes)
                        writes[q, px, rows] += 1
    return out, writes


@pytest.mark.parametrize("variant", [(8, 32, 0), (8, 32, 20), (16, 32, 0)])
def test_element_march_stores_every_interior_element_once(variant):
    """The kernel's march (segments of ELEMENT_SEG_PLANES planes, the last
    one short, the odd ones backwards) stores each interior element once,
    equal to the Pallas body's tile-by-tile result, and never the ring."""
    tx, ty, passes = variant
    fpad = np.random.default_rng(6).standard_normal((Q, 80 + 4, 64 + 16, 4)).astype(np.float32)
    got, writes = np_element_march(fpad, tx, ty, passes)
    want = np_element_pipeline(fpad, tx, ty, passes)
    assert probes.element_geometry(tx, ty, 80, 4)["segments"] == 3
    assert (writes[:, 2:82, 8:72] == 1).all() and writes.sum() == Q * 80 * 64 * 4
    np.testing.assert_array_equal(got[:, 2:82, 8:72], want[:, 2:82, 8:72])


def np_window_copy(fpad, y_off, wy, dst_off):
    """probe_dma_align.py make_copy's kernel: each window copied into a
    scratch buffer at row dst_off, the interior tile read at row
    dst_off + 8 - y_off.  The scratch starts as NaN, the stale VMEM of a
    row no copy filled."""
    TX, TY = probes.DMA_TX, probes.DMA_TY
    _, XP, YP, Z = fpad.shape
    X, Y = XP - 4, YP - 16
    out = np.empty((Q, X, Y, Z), np.float32)
    wy_buf = ((dst_off + wy + 7) // 8) * 8
    for i in range(X // TX):
        for j in range(Y // TY):
            scr = np.full((Q, TX + 4, wy_buf, Z), np.nan, np.float32)
            scr[:, :, dst_off : dst_off + wy] = fpad[:, i * TX : i * TX + TX + 4,
                                                     j * TY + y_off : j * TY + y_off + wy]
            yo = dst_off + 8 - y_off
            out[:, i * TX : (i + 1) * TX, j * TY : (j + 1) * TY] = scr[:, 2 : 2 + TX,
                                                                       yo : yo + TY]
    return out


def test_window_copy_plain_matches_pallas_body_and_refuses_variant_7():
    """Every covering window of the script gives the interior of the padded
    state, as its Pallas body does; the seventh, (y_off 2, ty+4, dst_off 2),
    reads rows 8..40 of a scratch its copy filled at 2..38 only: its Pallas
    body returns stale rows, and the port raises for it."""
    fpad = np.random.default_rng(6).standard_normal((Q, 32 + 4, 64 + 16, 4)).astype(np.float32)
    want = fpad[:, 2:34, 8:72]
    stale = []
    for y_off, wy, label, dst_off in script_variants("probe_dma_align.py"):
        body = np_window_copy(fpad, y_off, wy, dst_off)
        covers = not np.isnan(body).any()
        assert covers == probes.window_covers(y_off, wy, dst_off), label
        if covers:
            np.testing.assert_array_equal(body, want)
            for load in probes.LOADS:
                got = probes.window_copy(torch.from_numpy(fpad), y_off, wy, dst_off, load)
                np.testing.assert_array_equal(got.numpy(), want)
        else:
            stale.append((y_off, wy, dst_off))
            with pytest.raises(ValueError, match="does not cover its tile"):
                probes.window_copy(torch.from_numpy(fpad), y_off, wy, dst_off)
    assert stale == [(2, 36, 2)]  # variant 7: rows 38 and 39 of each tile are stale


def test_window_probes_refuse_bad_input():
    fpad = torch.zeros((Q, 32 + 4, 64 + 16, 4))
    with pytest.raises(ValueError, match="divide"):
        probes.element_pipeline(fpad, 12, 32, 0)
    with pytest.raises(ValueError, match="divide"):
        probes.window_copy(torch.zeros((Q, 8 + 4, 64 + 16, 4)), 0, 48)
    with pytest.raises(ValueError, match="leaves"):
        probes.window_copy(fpad, 8, 48)
    with pytest.raises(ValueError, match="load"):
        probes.window_copy(fpad, 0, 48, 0, "ld8")
    with pytest.raises(ValueError):
        probes.element_pipeline(fpad.double(), 8, 32, 0)
    assert probes.element_geometry(8, 32, 256, 256) == {"seg_tiles": 4, "segments": 8,
                                                        "stages": 4, "plane_bytes": 49152}
    assert probes.element_geometry(16, 32, 256, 256)["seg_tiles"] == 2
    with pytest.raises(ValueError, match="Z % 4"):
        probes.element_geometry(8, 32, 256, 6)
