"""CUDA kernels vs their plain PyTorch versions on the card (chip_smoke's compare
and probe phases).

Needs an NVIDIA card with ``nvcc``; skips elsewhere.  Imports no jax, so it
runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.kernels import probes
from tnl_lbm_tpu_torch.kernels.fused_aa import (
    from_storage,
    make_fused_pair2_aa,
    make_fused_step_aa,
    to_storage,
)
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.utils.dtypes import state_agrees

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def duct(shape, nothing):
    """sim_2's duct (NOTHING ring, WALL planes) or the bench duct (WALL faces)."""
    m = np.zeros(shape, np.uint8)
    if nothing:
        m[:, 1] = m[:, -2] = GEO.WALL
        m[:, :, 1] = m[:, :, -2] = GEO.WALL
        m[:, 0] = m[:, -1] = GEO.NOTHING
        m[:, :, 0] = m[:, :, -1] = GEO.NOTHING
    else:
        m[:, 0] = m[:, -1] = GEO.WALL
        m[:, :, 0] = m[:, :, -1] = GEO.WALL
    return m


@pytest.mark.parametrize("nothing", [True, False], ids=["sim2_duct", "bench_duct"])
@pytest.mark.parametrize("periodic", [(True, False, False), (False, False, False)],
                         ids=["periodic_x", "closed"])
@pytest.mark.parametrize("high_precision_rho", [False, True], ids=["sum", "neumaier"])
def test_kernels_match_plain_on_card(cuda, nothing, periodic, high_precision_rho):
    shape = (32, 64, 64) if nothing else (16, 24, 40)
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AA",
                                   high_precision_rho=high_precision_rho)
    dom = interop.domain_from_numpy(duct(shape, nothing), periodic)
    step = make_fused_step_aa(cfg, dom, cuda)
    rng = np.random.default_rng(5)
    rho = torch.from_numpy((1 + 0.01 * rng.standard_normal(shape)).astype(np.float32)).to(cuda)
    u = torch.from_numpy((0.02 * rng.standard_normal((3,) + shape)).astype(np.float32)).to(cuda)
    fk = cfg.eq(cfg.lat, rho, u).contiguous()
    fp = fk.clone()
    force = (1e-5, 0.0, 0.0)
    for it in range(4):
        parity = it % 2
        fk, rk, uk = step(fk, 0.02, force=force, parity=parity)
        fp, rp, up = step.plain(fp, 0.02, force=force, parity=parity)
        torch.cuda.synchronize()
        assert float((fk - fp).abs().max()) <= 1e-6, f"f, step {it}"
        assert float((rk - rp).abs().max()) <= 2e-6, f"rho, step {it}"
        assert float((uk - up).abs().max()) <= 1e-6, f"u, step {it}"
    assert step.even.launches == 2 and step.odd.launches == 2 and step.plain_calls == 0


def test_kernel_rejects_bad_input(cuda):
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AA")
    dom = interop.domain_from_numpy(duct((8, 16, 8), True), (True, False, False))
    step = make_fused_step_aa(cfg, dom, cuda)
    with pytest.raises(ValueError):
        step(torch.zeros((27, 8, 16, 9), device=cuda), 0.02, parity=0)
    with pytest.raises(ValueError):
        step(torch.zeros((27, 8, 8, 16), device=cuda).transpose(2, 3), 0.02, parity=1)
    with pytest.raises(NotImplementedError):
        step(torch.zeros((27, 8, 16, 8), device=cuda, dtype=torch.float64), 0.02, parity=0)
    with pytest.raises(NotImplementedError):
        make_fused_step_aa(interop.config_from_spec("CUM", "EQ", False, "AA"), dom, cuda)
    assert step.even.launches == step.odd.launches == 0


def seeded_state(cfg, shape, device, seed=5):
    rng = np.random.default_rng(seed)
    rho = torch.from_numpy((1 + 0.01 * rng.standard_normal(shape)).astype(np.float32)).to(device)
    u = torch.from_numpy((0.02 * rng.standard_normal((3,) + shape)).astype(np.float32)).to(device)
    return cfg.eq(cfg.lat, rho, u).contiguous()


@pytest.mark.parametrize("store", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["f32", "f16", "bf16"])
@pytest.mark.parametrize("nothing", [True, False], ids=["nothing", "walls"])
@pytest.mark.parametrize("periodic", [(True, False, False), (False, False, False),
                                      (True, True, True)], ids=["periodic_x", "closed", "torus"])
def test_pair_kernel_matches_plain_on_card(cuda, store, nothing, periodic):
    """Two pairs on a 20x36x40 box, which no block divides; each pair's
    kernel output against the plain version on the same input.  A 16-bit
    kernel's output is also the float32 kernel's on the widened input,
    narrowed, bit for bit: widening is exact, so that holds the narrowing
    to round-to-nearest-even exactly."""
    shape = (20, 36, 40)
    m = duct(shape, nothing)
    if nothing:
        m[7, 9, 11] = GEO.NOTHING
    if periodic == (True, True, True):
        m[:] = GEO.FLUID
        m[3, 4, 5] = GEO.NOTHING if nothing else GEO.WALL
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AA")
    dom = interop.domain_from_numpy(m, periodic)
    pair = make_fused_pair2_aa(cfg, dom, cuda, store_dtype=store)
    wide = make_fused_pair2_aa(cfg, dom, cuda)
    f = to_storage(seeded_state(cfg, shape, cuda), store)
    f0 = f.clone()
    for it in range(2):
        fk, rk, uk = pair(f, 0.02, force=(1e-5, 0.0, 0.0))
        fp, rp, up = pair.plain(f, 0.02, force=(1e-5, 0.0, 0.0))
        fw, rw, uw = wide(from_storage(f, torch.float32), 0.02, force=(1e-5, 0.0, 0.0))
        torch.cuda.synchronize()
        assert fk.dtype == store and rk.dtype == torch.float32
        assert state_agrees(fk, fp, store), f"f, pair {it}"
        assert float((rk - rp).abs().max()) <= 2e-6, f"rho, pair {it}"
        assert float((uk - up).abs().max()) <= 1e-6, f"u, pair {it}"
        assert torch.equal(to_storage(fw, store), fk), f"narrowing, pair {it}"
        assert torch.equal(rw, rk) and torch.equal(uw, uk), f"macro, pair {it}"
        f = fk
    assert pair.kernel.launches == 2 and pair.plain_calls == 0
    if nothing:  # NOTHING sites keep their stored bits
        keep = torch.as_tensor(m == GEO.NOTHING, device=cuda)
        assert torch.equal(f[:, keep], f0[:, keep])


def test_pair_kernel_writes_into_out_and_rejects_bad_input(cuda):
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AA")
    dom = interop.domain_from_numpy(duct((8, 16, 8), True), (True, False, False))
    pair = make_fused_pair2_aa(cfg, dom, cuda, store_dtype=torch.float16)
    f = to_storage(seeded_state(cfg, (8, 16, 8), cuda), torch.float16)
    out = torch.empty_like(f)
    f_new, _, _ = pair(f, 0.02, out=out)
    assert f_new is out
    with pytest.raises(ValueError):
        pair(f.float(), 0.02)
    with pytest.raises(ValueError):
        pair(f, 0.02, out=f)
    nomacro = make_fused_pair2_aa(cfg, dom, cuda, with_macro=False)
    f2, rho, u = nomacro(f.float(), 0.02)
    assert rho is None and u is None
    assert float((f2 - nomacro.plain(f.float(), 0.02)[0]).abs().max()) <= 1e-6
    assert pair.kernel.launches == 1 and nomacro.kernel.launches == 1


@pytest.mark.parametrize("with_macro", [True, False])
def test_copy_permute_matches_plain_on_card(cuda, with_macro):
    f = torch.randn((27, 20, 36, 40), device=cuda)
    got = probes.copy_permute(f, with_macro)
    want = probes.copy_permute_plain(f, with_macro)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("passes", [0, 20, 60])
def test_pair_probes_match_plain_on_card(cuda, passes):
    f = torch.randn((27, 20, 36, 40), device=cuda)
    assert torch.equal(probes.pair_pipeline(f, passes), probes.pair_pipeline_plain(f, passes))
    tile = probes.pair_compute_only(f, passes)
    assert tile.shape == (27,) + probes.first_block((20, 36, 40))
    assert torch.equal(tile, probes.pair_compute_only_plain(f, passes))
