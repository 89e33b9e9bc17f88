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
