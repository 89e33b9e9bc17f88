"""The bandwidth probes of ``tnl_lbm_tpu_torch.kernels.probes`` on the CPU.

The JAX probe scripts fix a 256^3 TPU run and cannot be called at a small
size, so each plain version is held against a numpy transliteration of its
Pallas kernel body: ``scripts/profile_floor.py:24-33`` (P1) and
``scripts/probe_pair2_pipeline.py:58-61`` (P2a) and ``:136-140`` (P2b).
Both sides round every float32 operation, so they agree bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tnl_lbm_tpu_torch.kernels import probes

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
    got = probes.pair_pipeline(torch.from_numpy(f), passes)
    # every block's columns, after the passes, land on their own sites
    np.testing.assert_array_equal(got.numpy(), np_passes(f, passes))
    assert passes == 0 or not np.array_equal(got.numpy(), f)


@pytest.mark.parametrize("shape", [SHAPE, (2, 3, 5)], ids=["large", "smaller_than_a_block"])
def test_pair_compute_only_plain_matches_pallas_body(shape):
    f = seeded(shape)
    tile = probes.pair_compute_only(torch.from_numpy(f), 20)
    bx, by, bz = probes.first_block(shape)
    assert tile.shape == (Q, bx, by, bz) == (Q,) + tuple(min(t, n) for t, n in
                                                        zip(probes.PAIR_TILE, shape))
    # only the first block's output is defined (the first program's)
    np.testing.assert_array_equal(tile.numpy(), np_passes(f[:, :bx, :by, :bz], 20))


def test_probes_share_the_pair_kernel_geometry():
    src = (Path(probes.__file__).resolve().parents[1] / "csrc" / "probes.cu").read_text()
    assert '#include "pair_window.cuh"' in src and "window_site(" in src


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
    assert probes.element_zchunk(8, 32, 256) == 16 and probes.element_zchunk(16, 32, 256) == 8
