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
from tnl_lbm_tpu_torch.kernels.fused_2d import make_fused_step_2d
from tnl_lbm_tpu_torch.kernels.fused_aa import (
    from_storage,
    make_fused_pair2_aa,
    make_fused_step_aa,
    to_storage,
)
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.utils.dtypes import state_agrees

from torch_cases import (
    AB_KINDS,
    AB_SPECS,
    ADE_COLLISIONS,
    ADE_KINDS,
    D2_COLLISIONS,
    D2_KINDS,
    FORCE_2D,
    PHI_IN,
    TCOEF,
    U_IN,
    U_IN_2D,
    aa_box,
    ade_aa_box,
    ade_case,
    bc_box,
    case_2d,
    channel,
    coupled_aa_cases,
    coupled_cases,
    parabolic_2d,
    seeded_2d,
    seeded_ade,
)

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
    with pytest.raises(NotImplementedError):  # CUM_WELL's cascade on total DFs: no instance
        make_fused_step_aa(interop.config_from_spec("CUM_WELL", "EQ_WELL", False, "AA"), dom,
                           cuda)
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


# ------------------------------------------------- ADE step (B6), coupled (B7)

@pytest.mark.parametrize("nu_kind", ["scalar", "field"])
@pytest.mark.parametrize("collision", ADE_COLLISIONS)
@pytest.mark.parametrize("kind", ADE_KINDS)
def test_ade_kernel_matches_plain_on_card(cuda, kind, collision, nu_kind):
    """Two ADE steps, each against the plain version on the same input."""
    from tnl_lbm_tpu_torch.kernels.fused_ade import make_fused_ade_step

    m, periodic = ade_case(kind)
    dom = interop.domain_from_numpy(m, periodic, lat=interop.D3Q7)
    step = make_fused_ade_step(interop.ade_config_from_spec(collision), dom, cuda,
                               variable_diffusion=nu_kind == "field", transfer_coeff=TCOEF)
    g, u, nu_field = seeded_ade(m.shape, cuda)
    nu = nu_field if nu_kind == "field" else 0.02
    for it in range(2):
        gk, pk = step(g, u, nu, phi_in=PHI_IN)
        gp, pp = step.plain(g, u, nu, phi_in=PHI_IN)
        torch.cuda.synchronize()
        assert float((gk - gp).abs().max()) <= 1e-6, f"g, step {it}"
        assert float((pk - pp).abs().max()) <= 2e-6, f"phi, step {it}"
        g = gk
    assert step.kernel.launches == 2 and step.plain_calls == 0


@pytest.mark.parametrize("collision", ADE_COLLISIONS)
@pytest.mark.parametrize("spec", sorted(AB_SPECS))
def test_coupled_kernel_matches_plain_on_card(cuda, spec, collision):
    """Two coupled steps per geometry against the plain version and against
    the A-B kernel then the ADE kernel, with a per-site nu field."""
    from tnl_lbm_tpu_torch.kernels.fused_ade import make_fused_ade_step
    from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step

    cfg = interop.config_from_spec(*AB_SPECS[spec], "AB")
    acfg = interop.ade_config_from_spec(collision)
    for label, mn, pn, ma, pa in coupled_cases():
        dom = interop.domain_from_numpy(mn, pn)
        adom = interop.domain_from_numpy(ma, pa, lat=interop.D3Q7)
        one = make_fused_coupled_step(cfg, dom, acfg, adom, cuda, variable_diffusion=True,
                                      transfer_coeff=TCOEF)
        b4 = make_fused_step(cfg, dom, cuda)
        b6 = make_fused_ade_step(acfg, adom, cuda, variable_diffusion=True, transfer_coeff=TCOEF)
        f = seeded_state(cfg, mn.shape, cuda, seed=11)
        g, _, nu_field = seeded_ade(mn.shape, cuda)
        for it in range(2):
            args = dict(u_in=U_IN, force=(1e-5, 0.0, 0.0))
            fk, gk, rk, uk, pk = one(f, g, 0.02, nu_field, phi_in=PHI_IN, **args)
            fp, gp, rp, up, pp = one.plain(f, g, 0.02, nu_field, phi_in=PHI_IN, **args)
            f2, r2, u2 = b4(f, 0.02, **args)
            g2, p2 = b6(g, u2, nu_field, phi_in=PHI_IN)
            torch.cuda.synchronize()
            for ref in ((fp, rp, up, gp, pp), (f2, r2, u2, g2, p2)):
                d = [float((a - b).abs().max()) for a, b in zip((fk, rk, uk, gk, pk), ref)]
                assert d[0] <= 1e-6 and d[1] <= 2e-6 and d[2] <= 1e-6, (label, it, d)
                assert d[3] <= 1e-6 and d[4] <= 2e-6, (label, it, d)
            f, g = fk, gk
        assert one.kernel.launches == 2 and one.plain_calls == 0


def test_ade_and_coupled_kernels_write_into_out_and_reject_bad_input(cuda):
    from tnl_lbm_tpu_torch.kernels.fused_ade import make_fused_ade_step
    from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step

    m, periodic = ade_case("box")
    adom = interop.domain_from_numpy(m, periodic, lat=interop.D3Q7)
    acfg = interop.ade_config_from_spec("CLBM")
    step = make_fused_ade_step(acfg, adom, cuda)
    g, u, nu_field = seeded_ade(m.shape, cuda)
    out = torch.empty_like(g)
    assert step(g, u, 0.02, out=out)[0] is out
    with pytest.raises(ValueError):
        step(g, u, 0.02, out=g)
    with pytest.raises(ValueError):
        step(g, u, nu_field)  # a field needs variable_diffusion=True
    with pytest.raises(ValueError):
        step(g, u, 0.02, phi_in=torch.tensor(1.0, device=cuda))
    with pytest.raises(ValueError):
        step(g, u[:, :-1].contiguous(), 0.02)
    with pytest.raises(NotImplementedError):
        step(g.double(), u, 0.02)
    cfg = interop.config_from_spec("CUM", "EQ", False, "AB")
    one = make_fused_coupled_step(cfg, interop.domain_from_numpy(bc_box(m.shape), periodic),
                                  acfg, adom, cuda)
    f = seeded_state(cfg, m.shape, cuda)
    outs = torch.empty_like(f), torch.empty_like(g)
    res = one(f, g, 0.02, 0.02, out_f=outs[0], out_g=outs[1])
    assert res[0] is outs[0] and res[1] is outs[1]
    with pytest.raises(ValueError):
        one(f, g, 0.02, 0.02, out_g=g)
    assert step.kernel.launches == 1 and one.kernel.launches == 1


# ------------------------------------ A-A steps with every code (B2, B3), B8

@pytest.mark.parametrize("spec", sorted(AB_SPECS))
def test_aa_kernels_match_plain_on_every_code(cuda, spec):
    """Four alternating A-A steps on a box of every A-A code with Z = 150,
    which the block's 128 z sites do not divide; each step's kernel output
    against the plain version on the same input."""
    m, periodic = aa_box((24, 20, 150)), (False, False, True)
    cfg = interop.config_from_spec(*AB_SPECS[spec], "AA")
    step = make_fused_step_aa(cfg, interop.domain_from_numpy(m, periodic), cuda)
    assert step.variant == {"CUM_WELL": 0, "CUM": 1, "CUM_INV_CUM": 2}[spec]
    f = seeded_state(cfg, m.shape, cuda, seed=11)
    for it in range(4):
        fp, rp, up = step.plain(f, 0.02, u_in=U_IN, force=(1e-5, 0.0, 0.0), parity=it % 2)
        fk, rk, uk = step(f.clone(), 0.02, u_in=U_IN, force=(1e-5, 0.0, 0.0), parity=it % 2)
        torch.cuda.synchronize()
        assert float((fk - fp).abs().max()) <= 1e-6, f"f, step {it}"
        assert float((rk - rp).abs().max()) <= 2e-6, f"rho, step {it}"
        assert float((uk - up).abs().max()) <= 1e-6, f"u, step {it}"
        f = fk
    assert step.even.launches == 2 and step.odd.launches == 2 and step.plain_calls == 0


def test_aa_lean_instance_equals_full_cum_well_on_the_duct(cuda):
    """On a FLUID/WALL/NOTHING map the lean CUM_WELL instance (no boundary
    switch) and the full one give the same state within the step bound."""
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AA")
    dom = interop.domain_from_numpy(duct((16, 24, 40), True), (True, False, False))
    lean, full = make_fused_step_aa(cfg, dom, cuda), make_fused_step_aa(cfg, dom, cuda, lean=False)
    assert (lean.variant, full.variant) == (3, 0)
    f = seeded_state(cfg, (16, 24, 40), cuda)
    for parity in (0, 1):
        a = lean(f.clone(), 0.02, force=(1e-5, 0.0, 0.0), parity=parity)
        b = full(f.clone(), 0.02, force=(1e-5, 0.0, 0.0), parity=parity)
        torch.cuda.synchronize()
        for x, y, bound in zip(a, b, (1e-6, 2e-6, 1e-6)):
            assert float((x - y).abs().max()) <= bound, parity


@pytest.mark.parametrize("collision", ADE_COLLISIONS)
@pytest.mark.parametrize("spec", sorted(AB_SPECS))
def test_coupled_aa_kernel_matches_plain_on_card(cuda, spec, collision):
    """Four alternating parities of B8 per geometry with a per-site nu field:
    each against the plain version on the same input, and the NSE fields
    against the A-A step kernels (B2, B3) run alone, within the step bounds
    (bit-equality is printed, not required: the compilations may contract
    multiply-adds differently)."""
    from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step_aa

    cfg = interop.config_from_spec(*AB_SPECS[spec], "AA")
    acfg = interop.ade_config_from_spec(collision, "AA")
    for label, mn, pn, ma, pa in coupled_aa_cases():
        dom = interop.domain_from_numpy(mn, pn)
        adom = interop.domain_from_numpy(ma, pa, lat=interop.D3Q7)
        pair = make_fused_coupled_step_aa(cfg, dom, acfg, adom, cuda, variable_diffusion=True)
        alone = make_fused_step_aa(cfg, dom, cuda, lean=False)  # B8's NSE instance
        f = seeded_state(cfg, mn.shape, cuda, seed=11)
        g, _, nu_field = seeded_ade(mn.shape, cuda)
        same = True
        for it in range(4):
            args = dict(u_in=U_IN, force=(1e-5, 0.0, 0.0), parity=it % 2)
            p = pair.plain(f, g, 0.02, nu_field, phi_in=PHI_IN, **args)
            fa, ra, ua = alone(f.clone(), 0.02, **args)
            k = pair(f.clone(), g.clone(), 0.02, nu_field, phi_in=PHI_IN, **args)
            torch.cuda.synchronize()
            for ref in (p[:1] + p[2:4], (fa, ra, ua)):
                d = [float((a - b).abs().max()) for a, b in zip((k[0], k[2], k[3]), ref)]
                assert d[0] <= 1e-6 and d[1] <= 2e-6 and d[2] <= 1e-6, (label, it, d)
            d = [float((k[i] - p[i]).abs().max()) for i in (1, 4)]
            assert d[0] <= 1e-6 and d[1] <= 2e-6, (label, it, d)
            same &= all(torch.equal(a, b) for a, b in zip((k[0], k[2], k[3]), (fa, ra, ua)))
            f, g = k[0], k[1]
        print(f"{label} {spec} {collision}: B8 NSE fields equal B2/B3's bit for bit: {same}")
        assert pair.even.launches == 2 and pair.odd.launches == 2 and pair.plain_calls == 0


def test_coupled_aa_kernel_in_place_and_out(cuda):
    """The even kernel updates f and g in place; the odd kernel writes the
    second buffers; NOTHING sites of either map keep their DFs."""
    from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step_aa

    shape = (8, 16, 40)
    mn, ma, per = aa_box(shape), ade_aa_box(shape), (False, False, True)
    cfg = interop.config_from_spec("CUM", "EQ", False, "AA")
    pair = make_fused_coupled_step_aa(cfg, interop.domain_from_numpy(mn, per),
                                      interop.ade_config_from_spec("SRT", "AA"),
                                      interop.domain_from_numpy(ma, per, lat=interop.D3Q7), cuda)
    f0 = seeded_state(cfg, shape, cuda)
    g0, _, _ = seeded_ade(shape, cuda)
    f, g = f0.clone(), g0.clone()
    fe, ge, _, _, _ = pair(f, g, 0.02, 0.02, parity=0)
    assert fe is f and ge is g
    outs = torch.empty_like(f), torch.empty_like(g)
    fo, go, _, _, _ = pair(f, g, 0.02, 0.02, parity=1, out_f=outs[0], out_g=outs[1])
    assert fo is outs[0] and go is outs[1]
    for state, ref, mask in ((fo, f0, mn == GEO.NOTHING), (go, g0, ma == 10)):
        keep = torch.as_tensor(mask, device=cuda)
        assert keep.any() and torch.equal(state[:, keep], ref[:, keep])
    with pytest.raises(ValueError):
        pair(f, g, 0.02, 0.02, parity=1, out_f=f)
    assert pair.even.launches == 1 and pair.odd.launches == 1


# ------------------------------------------------------------ D2Q9 step (B5)

@pytest.mark.parametrize("forced", [False, True], ids=["noforce", "force"])
@pytest.mark.parametrize("uin_kind", ["profile", "vector"])
@pytest.mark.parametrize("collision", D2_COLLISIONS)
@pytest.mark.parametrize("kind", D2_KINDS)
def test_d2q9_kernel_matches_plain_on_card(cuda, kind, collision, uin_kind, forced):
    """Four chained B5 steps, each against the plain version on the same
    input, at 37 x 150 (neither a multiple of the block); the profile sits
    on the card and is read through its strides."""
    m, periodic, bz = case_2d(kind, (37, 150))
    cfg = interop.config_2d_from_spec(collision)
    step = make_fused_step_2d(cfg, interop.domain_from_numpy(m, periodic, lat=cfg.lat,
                                                             bouzidi=bz), cuda)
    u_in = (torch.tensor(parabolic_2d(150), dtype=torch.float32, device=cuda)
            if uin_kind == "profile" else U_IN_2D)
    force = FORCE_2D if forced else None
    f = seeded_2d(cfg, m.shape, cuda, seed=11)
    for it in range(4):
        fk, rk, uk = step(f, 0.02, u_in=u_in, force=force)
        fp, rp, up = step.plain(f, 0.02, u_in=u_in, force=force)
        torch.cuda.synchronize()
        assert float((fk - fp).abs().max()) <= 1e-6, f"f, step {it}"
        assert float((rk - rp).abs().max()) <= 2e-6, f"rho, step {it}"
        assert float((uk - up).abs().max()) <= 1e-6, f"u, step {it}"
        f = fk
    assert step.kernel.launches == 4 and step.plain_calls == 0


def test_d2q9_kernel_counts_writes_into_out_and_refuses(cuda):
    m, periodic, bz = case_2d("bouzidi", (16, 16))
    cfg = interop.config_2d_from_spec("CLBM")
    dom = interop.domain_from_numpy(m, periodic, lat=cfg.lat, bouzidi=bz)
    step = make_fused_step_2d(cfg, dom, cuda)
    f = seeded_2d(cfg, m.shape, cuda)
    out = torch.empty_like(f)
    assert step(f, 0.02, u_in=U_IN_2D, out=out)[0] is out
    step.plain(f, 0.02, u_in=U_IN_2D)
    assert step.kernel.launches == 1 and step.plain_calls == 0
    with pytest.raises(ValueError):
        step(f, 0.02, out=f)
    with pytest.raises(ValueError):
        step(f, 0.02, force=torch.tensor(FORCE_2D, device=cuda))  # no device round trip
    with pytest.raises(ValueError):
        step(torch.zeros((9, 16, 17), device=cuda), 0.02)
    with pytest.raises(NotImplementedError):
        step(f.double(), 0.02)
    with pytest.raises(ValueError):  # a step built for the CPU launches nothing on the card
        make_fused_step_2d(cfg, dom, "cpu")(f, 0.02)
    aa = interop.config_2d_from_spec("CLBM", streaming="AA")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_fused_step_2d(aa, dom, cuda)
    assert step.kernel.launches == 1


# ------------------------------------------------------ the forcing-hook slice

def nn_inputs(shape, device, seed):
    from torch_cases import nn_state

    return [torch.from_numpy(a).to(device) for a in nn_state(shape, seed)]


@pytest.mark.parametrize("model", ["cy", "casson"])
@pytest.mark.parametrize("kind", ["duct", "periodic", "obstacle"])
def test_nn_force_kernel_matches_plain_on_card(cuda, kind, model):
    """B9 against its plain version (the hook on tensors), the hook wrapped
    as the domain and not: |dF| <= 1e-6 of max |F|."""
    from tnl_lbm_tpu_torch.kernels.fused_nn import make_nn_force_kernel
    from torch_cases import NN_MODELS, nn_case

    m, periodic, _, _ = nn_case(kind)
    dom = interop.domain_from_numpy(m, periodic)
    rho, u = nn_inputs(dom.shape, cuda, seed=3)
    for per in (periodic, None if any(periodic) else (True, True, False)):
        b9 = make_nn_force_kernel(NN_MODELS[model], dom, cuda, periodic=per)
        fk, fp = b9(rho, u, 0.02), b9.plain(rho, u, 0.02)
        torch.cuda.synchronize()
        scale = float(fp.abs().max())
        assert scale > 0 and float((fk - fp).abs().max()) <= 1e-6 * scale, per
        assert b9.kernel.launches == 1 and b9.plain_calls == 0


@pytest.mark.parametrize("streaming", ["AB", "AA"])
@pytest.mark.parametrize("kind", ["duct", "periodic", "obstacle", "blunt"])
def test_nn_step_kernel_matches_plain_on_card(cuda, kind, streaming):
    """B10 (A-B; A-A even and odd) against the plain hooked step, 4 chained
    steps, each to the step bounds; "blunt" is the 4 x 4 x 21 channel,
    smaller than the kernel's tile."""
    import dataclasses

    from tnl_lbm_tpu_torch.kernels.fused_nn_step import make_fused_nn_step
    from tnl_lbm_tpu_torch.ops.non_newtonian import make_nn_forcing_hook
    from torch_cases import NN_MODELS, blunt_channel, nn_case

    if kind == "blunt":
        (m, periodic), model = blunt_channel(), "cy"
        hook_per = periodic
    else:
        m, periodic, model, hook_per = nn_case(kind)
    dom = interop.domain_from_numpy(m, periodic)
    cfg = dataclasses.replace(interop.config_from_spec("CUM_WELL", "EQ_WELL", True, streaming),
                              forcing_hook=make_nn_forcing_hook(NN_MODELS[model],
                                                                periodic=hook_per))
    step = make_fused_nn_step(cfg, dom, NN_MODELS[model], hook_per, cuda)
    rho, u = nn_inputs(dom.shape, cuda, seed=5)
    fk = cfg.eq(cfg.lat, rho, u).float().contiguous()
    fp = fk.clone()
    for it in range(4):
        parity = it % 2 if streaming == "AA" else 0
        fk, rk, uk = step(fk, 0.02, force=(1e-5, 0.0, 0.0), parity=parity)
        fp, rp, up = step.plain(fp, 0.02, force=(1e-5, 0.0, 0.0), parity=parity)
        torch.cuda.synchronize()
        assert float((fk - fp).abs().max()) <= 1e-6, f"f, step {it}"
        assert float((rk - rp).abs().max()) <= 2e-6, f"rho, step {it}"
        assert float((uk - up).abs().max()) <= 1e-6, f"u, step {it}"
    assert step.ab.launches + step.even.launches + step.odd.launches == 4


@pytest.mark.parametrize("spec", [("CUM_WELL", "EQ_WELL", True), ("CUM", "EQ", False),
                                  ("CUM", "EQ_INV_CUM", False)], ids=["well", "quad", "invcum"])
@pytest.mark.parametrize("streaming", ["AB", "AA"])
def test_variants_match_plain_on_card(cuda, streaming, spec):
    """The force_field (a seeded per-site force plus a homogeneous one) and
    macro_only variants of B4 and B2/B3 against their plain versions, on a
    box of every code of the pattern, one step from the same input."""
    from tnl_lbm_tpu_torch.kernels.fused import make_fused_step

    m = (bc_box if streaming == "AB" else aa_box)((24, 20, 150))
    dom = interop.domain_from_numpy(m, (False, False, True))
    cfg = interop.config_from_spec(*spec, streaming)
    build = make_fused_step if streaming == "AB" else make_fused_step_aa
    ff, macro = build(cfg, dom, cuda, force_field=True), build(cfg, dom, cuda, macro_only=True)
    f = seeded_state(cfg, dom.shape, cuda)
    rng = np.random.default_rng(9)
    field = torch.from_numpy((1e-5 * rng.standard_normal((3,) + dom.shape)).astype(
        np.float32)).to(cuda)
    for parity in ((0,) if streaming == "AB" else (0, 1)):
        kw = dict(u_in=U_IN, force=field, force_add=(1e-5, 0.0, 0.0), parity=parity)
        fk, rk, uk = ff(f.clone(), 0.02, **kw)
        fp, rp, up = ff.plain(f, 0.02, **kw)
        rk0, uk0 = macro(f, 0.02, force=(1e-5, 0.0, 0.0), parity=parity)
        rp0, up0 = macro.plain(f, 0.02, force=(1e-5, 0.0, 0.0), parity=parity)
        torch.cuda.synchronize()
        assert float((fk - fp).abs().max()) <= 1e-6
        assert float((rk - rp).abs().max()) <= 2e-6 and float((uk - up).abs().max()) <= 1e-6
        assert float((rk0 - rp0).abs().max()) <= 2e-6
        assert float((uk0 - up0).abs().max()) <= 1e-6
    assert ff.plain_calls == macro.plain_calls == 0


@pytest.mark.parametrize("collision", D2_COLLISIONS)
@pytest.mark.parametrize("kind", ["channel", "bouzidi", "periodic"])
def test_d2q9_force_field_matches_plain_on_card(cuda, kind, collision):
    """B5's force_field variant against its plain version, 4 chained steps."""
    m, periodic, bz = case_2d(kind, shape=(37, 150))
    from tnl_lbm_tpu_torch.models import D2Q9

    dom = interop.domain_from_numpy(m, periodic, lat=D2Q9, bouzidi=bz)
    cfg = interop.config_2d_from_spec(collision)
    step = make_fused_step_2d(cfg, dom, cuda, force_field=True)
    rng = np.random.default_rng(17)
    field = torch.from_numpy((1e-5 * rng.standard_normal((2,) + dom.shape)).astype(
        np.float32)).to(cuda)
    fk = seeded_2d(cfg, dom.shape, cuda, seed=4)
    fp = fk.clone()
    for it in range(4):
        fk, rk, uk = step(fk, 0.02, u_in=(0.03, 0.0), force=field, force_add=(1e-5, 0.0))
        fp, rp, up = step.plain(fp, 0.02, u_in=(0.03, 0.0), force=field, force_add=(1e-5, 0.0))
        torch.cuda.synchronize()
        assert float((fk - fp).abs().max()) <= 1e-6, f"f, step {it}"
        assert float((rk - rp).abs().max()) <= 2e-6 and float((uk - up).abs().max()) <= 1e-6
    assert step.kernel.launches == 4 and step.plain_calls == 0


@pytest.mark.parametrize("streaming", ["AB", "AA"])
def test_hooked_routes_agree_on_card(cuda, streaming):
    """On the wall duct with the hook wrapped as the domain, the one-kernel
    route (B10) and the pipeline (u* pass, B9, force_field) compute the
    same hooked step: each against the other and against the plain hooked
    step, both parities."""
    import dataclasses

    from tnl_lbm_tpu_torch.kernels.hooked import make_hooked_fused_step
    from tnl_lbm_tpu_torch.ops.non_newtonian import make_nn_forcing_hook
    from torch_cases import NN_MODELS, nn_case

    m, periodic, model, per = nn_case("duct")
    dom = interop.domain_from_numpy(m, periodic)
    cfg = dataclasses.replace(interop.config_from_spec("CUM_WELL", "EQ_WELL", True, streaming),
                              forcing_hook=make_nn_forcing_hook(NN_MODELS[model], periodic=per))
    single = make_hooked_fused_step(cfg, dom, cuda)
    pipe = make_hooked_fused_step(cfg, dom, cuda, single_kernel=False)
    assert (single.route, pipe.route) == ("single_kernel", "pipeline")
    rho, u = nn_inputs(dom.shape, cuda, seed=6)
    f = cfg.eq(cfg.lat, rho, u).float().contiguous()
    for parity in ((0,) if streaming == "AB" else (0, 1)):
        a = single(f.clone(), 0.02, force=(1e-5, 0.0, 0.0), parity=parity)
        b = pipe(f.clone(), 0.02, force=(1e-5, 0.0, 0.0), parity=parity)
        p = single.plain(f, 0.02, force=(1e-5, 0.0, 0.0), parity=parity)
        torch.cuda.synchronize()
        for x, y in ((a, b), (a, p), (b, p)):
            assert float((x[0] - y[0]).abs().max()) <= 1e-6
            assert float((x[1] - y[1]).abs().max()) <= 2e-6
            assert float((x[2] - y[2]).abs().max()) <= 1e-6
    assert single.plain_calls == pipe.plain_calls == 0


# ------------------------------------- the layout variants (B1b, B4s) and P3/P4

@pytest.mark.parametrize("spec", sorted(AB_SPECS))
@pytest.mark.parametrize("kind", ["torus", "duct", "aa_box"])
def test_two_kernel_pair_matches_plain_on_card(cuda, kind, spec):
    """Two pairs of the two-kernel A-A pair (B1b) on a box no block divides,
    each against its plain version on the same input; each kernel alone too
    (the odd one on the even one's buffer), and the buffer's ring is
    ``pad_halo`` of its interior bit for bit."""
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair_aa
    from tnl_lbm_tpu_torch.ops.streaming import pad_halo

    shape = (20, 36, 40)
    if kind == "aa_box":
        m, periodic, u_in = aa_box(shape), (False, False, True), U_IN
    else:
        m = duct(shape, nothing=True) if kind == "duct" else np.zeros(shape, np.uint8)
        m[7, 9, 11] = GEO.NOTHING
        periodic = (True, True, True) if kind == "torus" else (True, False, False)
        u_in = None
    cfg = interop.config_from_spec(*AB_SPECS[spec], "AA")
    pair = make_fused_pair_aa(cfg, interop.domain_from_numpy(m, periodic), cuda)
    f = seeded_state(cfg, shape, cuda)
    force = (1e-5, 0.0, 0.0)
    for it in range(2):
        fpad = pair.even_step(f, 0.02, u_in, force)
        assert torch.equal(fpad, pad_halo(fpad[:, 1:-1, 1:-1], periodic[:2])), f"ring, pair {it}"
        assert float((fpad - pair.plain_even_step(f, 0.02, u_in, force)).abs().max()) <= 1e-6
        f2, rho, u = pair.odd_step(fpad, 0.02, u_in, force)
        assert float((f2 - pair.plain_odd_step(fpad, 0.02, u_in, force)[0]).abs().max()) <= 1e-6
        fk, rk, uk = pair(f, 0.02, u_in, force)
        fp, rp, up = pair.plain(f, 0.02, u_in, force)
        torch.cuda.synchronize()
        assert torch.equal(fk, f2) and torch.equal(rk, rho) and torch.equal(uk, u)
        assert float((fk - fp).abs().max()) <= 1e-6, f"f, pair {it}"
        assert float((rk - rp).abs().max()) <= 2e-6 and float((uk - up).abs().max()) <= 1e-6
        f = fk
    assert pair.even.launches == pair.odd.launches == 4 and pair.plain_calls == 0


def test_two_kernel_pair_without_macro_and_refusals(cuda):
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair_aa

    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AA")
    dom = interop.domain_from_numpy(duct((8, 16, 8), True), (True, False, False))
    f = seeded_state(cfg, (8, 16, 8), cuda)
    full, bare = make_fused_pair_aa(cfg, dom, cuda), make_fused_pair_aa(cfg, dom, cuda, False)
    f2, rho, u = bare(f, 0.02)
    assert rho is None and u is None and torch.equal(f2, full(f, 0.02)[0])
    with pytest.raises(ValueError):
        bare(f.half(), 0.02)
    with pytest.raises(ValueError):
        bare.odd_step(f, 0.02)  # an unpadded state


@pytest.mark.parametrize("spec", sorted(AB_SPECS))
@pytest.mark.parametrize("kind", ["inflow_outflow", "interp_outflow", "sym", "box"])
def test_sitemajor_step_matches_plain_on_card(cuda, kind, spec):
    """Two site-major A-B steps (B4s), each against its plain version on the
    same input, with the five dummy components zero; equal to B4 on the
    state in the [Q, X, Y, Z] layout."""
    from tnl_lbm_tpu_torch.kernels.fused import (
        from_sitemajor,
        make_fused_step_sitemajor,
        to_sitemajor,
    )

    m, periodic = channel(kind)
    dom = interop.domain_from_numpy(m, periodic)
    cfg = interop.config_from_spec(*AB_SPECS[spec], "AB")
    step = make_fused_step_sitemajor(cfg, dom, cuda)
    ab = make_fused_step(cfg, dom, cuda)
    fs = to_sitemajor(seeded_state(cfg, m.shape, cuda))
    for it in range(2):
        fk, rk, uk = step(fs, 0.02, u_in=U_IN, force=(1e-5, 0.0, 0.0))
        fp, rp, up = step.plain(fs, 0.02, u_in=U_IN, force=(1e-5, 0.0, 0.0))
        fa, ra, ua = ab(from_sitemajor(fs, 27), 0.02, u_in=U_IN, force=(1e-5, 0.0, 0.0))
        torch.cuda.synchronize()
        assert bool((fk[:, :, 27:] == 0).all())
        assert float((fk - fp).abs().max()) <= 1e-6, f"f, step {it}"
        assert float((rk - rp).abs().max()) <= 2e-6 and float((uk - up).abs().max()) <= 1e-6
        assert float((from_sitemajor(fk, 27) - fa).abs().max()) <= 1e-6
        fs = fk
    assert step.kernel.launches == 2 and step.plain_calls == 0


@pytest.mark.parametrize("variant", [(8, 32, 0), (8, 32, 20), (16, 32, 0)])
def test_element_pipeline_matches_plain_on_card(cuda, variant):
    tx, ty, passes = variant
    fpad = torch.randn((27, 32 + 4, 64 + 16, 48), device=cuda)
    got = probes.element_pipeline(fpad, tx, ty, passes)
    want = probes.element_pipeline_plain(fpad, tx, ty, passes)
    assert torch.equal(probes.interior(got), probes.interior(want))


@pytest.mark.parametrize("load", ["ld4", "ld16", "tma"])
def test_window_copy_matches_plain_on_card(cuda, load):
    fpad = torch.randn((27, 32 + 4, 64 + 16, 24), device=cuda)
    for y_off, wy, label, dst_off in probes.DMA_VARIANTS:
        if probes.window_covers(y_off, wy, dst_off):
            got = probes.window_copy(fpad, y_off, wy, dst_off, load)
            assert torch.equal(got, probes.interior(fpad)), label
        else:
            with pytest.raises(ValueError, match="does not cover"):
                probes.window_copy(fpad, y_off, wy, dst_off, load)


@pytest.mark.parametrize("kernel", ["pair2", "pair"])
def test_bench_entry_on_card(cuda, kernel, capsys):
    import json

    from tnl_lbm_tpu_torch import bench

    bench.main(["--kernel", kernel])
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["device"] == torch.cuda.get_device_name(0) and rec["value"] > 0
    assert rec["bound_mlups"] > rec["value"] and min(rec["launches"].values()) == 51
