"""CUDA kernels vs their plain PyTorch versions on the card (chip_smoke phase 3).

Needs an NVIDIA card with ``nvcc``; skips elsewhere.  Imports no jax, so it
runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa
from tnl_lbm_tpu_torch.ops.boundary import GEO

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
