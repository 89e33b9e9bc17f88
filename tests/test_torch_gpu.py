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
from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
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


# ------------------------------------------------------------- A-B step (B4)

def bc_box(shape):
    """A closed box holding every GEO code of the 3D set: inflows (moment
    and equilibrium) on x = 0, the three outflows on x = X-1, symmetry
    planes on the y and z faces and on patches of x = 1 and x = X-2, a
    PERIODIC-coded block, walls and NOTHING sites inside (chip_smoke.py
    bc_box)."""
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


AB_KINDS = ("inflow_outflow", "interp_outflow", "eq_inflow", "sym", "periodic_code", "box")
AB_SPECS = {"CUM_WELL": ("CUM_WELL", "EQ_WELL", True), "CUM": ("CUM", "EQ", False),
            "CUM_INV_CUM": ("CUM", "EQ_INV_CUM", False)}
U_IN = (0.03, 0.005, -0.004)


@pytest.mark.parametrize("spec", sorted(AB_SPECS))
@pytest.mark.parametrize("kind", AB_KINDS + ("box_z150",))
def test_ab_kernel_matches_plain_on_card(cuda, kind, spec):
    """Two A-B steps from a seeded state, each against the plain version
    on the same input; ``box_z150`` has a Z that the block's 128 z sites
    do not divide."""
    m, periodic = channel("box", (24, 20, 150)) if kind == "box_z150" else channel(kind)
    cfg = interop.config_from_spec(*AB_SPECS[spec], "AB")
    step = make_fused_step(cfg, interop.domain_from_numpy(m, periodic), cuda)
    f = seeded_state(cfg, m.shape, cuda, seed=11)
    for it in range(2):
        fk, rk, uk = step(f, 0.02, u_in=U_IN, force=(1e-5, 0.0, 0.0))
        fp, rp, up = step.plain(f, 0.02, u_in=U_IN, force=(1e-5, 0.0, 0.0))
        torch.cuda.synchronize()
        assert float((fk - fp).abs().max()) <= 1e-6, f"f, step {it}"
        assert float((rk - rp).abs().max()) <= 2e-6, f"rho, step {it}"
        assert float((uk - up).abs().max()) <= 1e-6, f"u, step {it}"
        f = fk
    assert step.kernel.launches == 2 and step.plain_calls == 0


@pytest.mark.parametrize("app", ["sim_1", "sim_2", "sim_3"])
def test_ab_kernel_matches_plain_on_the_apps(cuda, app, tmp_path):
    """One A-B step of each app at resolution 2 (sim_2 with A-B streaming)."""
    import importlib

    mod = importlib.import_module(f"tnl_lbm_tpu_torch.apps.{app}")
    kw = {"streaming": "AB", "use_fused": True} if app == "sim_2" else {}
    sim = mod.build(2, device=cuda, results_parent=tmp_path, **kw)
    step = make_fused_step(sim.cfg, sim.domain, cuda)
    f = seeded_state(sim.cfg, sim.domain.shape, cuda, seed=11)
    u_in = sim.update_inflow(0.0)
    fk, rk, uk = step(f, 0.02, u_in=u_in, force=(1e-5, 0.0, 0.0))
    fp, rp, up = step.plain(f, 0.02, u_in=u_in, force=(1e-5, 0.0, 0.0))
    torch.cuda.synchronize()
    assert float((fk - fp).abs().max()) <= 1e-6
    assert float((rk - rp).abs().max()) <= 2e-6
    assert float((uk - up).abs().max()) <= 1e-6


def test_ab_kernel_writes_into_out_and_rejects_bad_input(cuda):
    m, periodic = channel("box")
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AB")
    step = make_fused_step(cfg, interop.domain_from_numpy(m, periodic), cuda)
    f = seeded_state(cfg, m.shape, cuda)
    out = torch.empty_like(f)
    assert step(f, 0.02, u_in=U_IN, out=out)[0] is out
    with pytest.raises(ValueError):
        step(f, 0.02, out=f)
    with pytest.raises(ValueError):
        step(f, 0.02, u_in=torch.tensor(U_IN, device=cuda))  # no device round trip per step
    with pytest.raises(ValueError):
        step(torch.zeros((27, 8, 16, 9), device=cuda), 0.02)
    with pytest.raises(NotImplementedError):
        step(f.double(), 0.02)
    with pytest.raises(NotImplementedError):
        step(f, 0.02, u_in=torch.zeros((3,) + m.shape))
    for spec in (("CUM_WELL", "EQ_WELL", False), ("CUM", "EQ_WELL", False)):
        with pytest.raises(NotImplementedError):
            make_fused_step(interop.config_from_spec(*spec, "AB"),
                            interop.domain_from_numpy(m, periodic), cuda)
    assert step.kernel.launches == 1
