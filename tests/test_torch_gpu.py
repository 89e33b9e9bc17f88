"""CUDA kernels vs their plain PyTorch versions on the card (chip_smoke's compare
and probe phases).

Needs an NVIDIA card with ``nvcc``; skips elsewhere.  Imports no jax, so it
runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import itertools

import numpy as np
import pytest
import torch

from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.kernels import fused_2d, probes
from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
from tnl_lbm_tpu_torch.kernels.fused_2d import FusedChunk2D, make_fused_step_2d
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
    COLLISION_CASES,
    ADE_KINDS,
    D2_COLLISIONS,
    D2_KINDS,
    FORCE_2D,
    KERNEL_TOL_F,
    PHI_IN,
    RESIDENT_INSTANCES,
    RESIDENT_KINDS,
    TCOEF,
    U_IN,
    U_IN_2D,
    aa_box,
    ade_aa_box,
    ade_case,
    bc_box,
    case_2d,
    channel,
    collision_spec,
    coupled_aa_cases,
    coupled_cases,
    parabolic_2d,
    resident_case_2d,
    resident_inflow,
    resident_route,
    seeded_2d,
    seeded_ade,
    separated_faster,
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


STORES = pytest.mark.parametrize("store", [torch.float32, torch.float16, torch.bfloat16],
                                 ids=["f32", "f16", "bf16"])
PERIODIC = list(itertools.product([False, True], repeat=3))


def pairs_match_plain(cuda, m, periodic, store, seg_len=None, n_pairs=2):
    """``n_pairs`` pairs of the kernel from a seeded state, each against the
    plain version on the same input and, narrowed, the float32 kernel's
    output on the widened input bit for bit (widening is exact, so that
    holds the narrowing to round-to-nearest-even exactly).  Returns the
    final state and the input."""
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AA")
    dom = interop.domain_from_numpy(m, periodic)
    pair = make_fused_pair2_aa(cfg, dom, cuda, store_dtype=store, seg_len=seg_len)
    wide = make_fused_pair2_aa(cfg, dom, cuda, seg_len=seg_len)
    f = to_storage(seeded_state(cfg, m.shape, cuda), store)
    f0 = f.clone()
    for it in range(n_pairs):
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
    assert pair.kernel.launches == n_pairs and pair.plain_calls == 0
    return f, f0


@STORES
@pytest.mark.parametrize("nothing", [True, False], ids=["nothing", "walls"])
@pytest.mark.parametrize("periodic", PERIODIC,
                         ids=["".join("p" if p else "c" for p in per) for per in PERIODIC])
@pytest.mark.parametrize("seg_len", [None, 7], ids=["auto_segments", "segments_of_7"])
def test_pair_kernel_matches_plain_on_card(cuda, store, nothing, periodic, seg_len):
    """Two pairs on a 20x36x40 box, which no column tile divides (and, in
    segments of 7, no x segment), per periodic combination; each pair's
    kernel output against the plain version on the same input, and a 16-bit
    kernel's output against the float32 kernel's narrowed."""
    shape = (20, 36, 40)
    m = duct(shape, nothing)
    if nothing:
        m[7, 9, 11] = GEO.NOTHING
    if periodic == (True, True, True):
        m[:] = GEO.FLUID
        m[3, 4, 5] = GEO.NOTHING if nothing else GEO.WALL
    f, f0 = pairs_match_plain(cuda, m, periodic, store, seg_len)
    if nothing:  # NOTHING sites keep their stored bits
        keep = torch.as_tensor(m == GEO.NOTHING, device=cuda)
        assert torch.equal(f[:, keep], f0[:, keep])


@STORES
@pytest.mark.parametrize("box", [((5, 13, 48), 8), ((9, 11, 45), None), ((6, 10, 36), 4)],
                         ids=["x_below_one_segment", "odd_z_unstaged", "z36_16bit_unstaged"])
def test_pair_kernel_small_boxes_on_card(cuda, store, box):
    """X shorter than one segment; a z extent that is no whole number of
    16-byte pieces (read straight from global memory, no staging); with
    NOTHING sites and walls, periodic along x and z."""
    shape, seg_len = box
    m = duct(shape, True)
    m[shape[0] // 2, 3, 4] = GEO.NOTHING
    pairs_match_plain(cuda, m, (True, False, True), store, seg_len)


@pytest.mark.parametrize("case", ["sim2_res2", "duct_96"])
def test_pair_dispatch_probe_agrees_with_kernel_times(cuda, case, tmp_path):
    """``pair_dispatch="auto"`` picks the pair where the probe's own helper,
    timing both routes again over longer chains (5 chains of 20 pairs), finds
    it faster than one even plus one odd launch in every chain, by more
    than 10% in the medians; where the chains overlap (small lattices are
    launch-bound and noisy) there is no verdict."""
    from tnl_lbm_tpu_torch import bench
    from tnl_lbm_tpu_torch.apps import sim_2
    from tnl_lbm_tpu_torch.sim.state import Simulation

    if case == "sim2_res2":
        sim = sim_2.build(2, device=cuda, streaming="AA", use_fused=True, results_parent=tmp_path)
    else:
        cfg, dom = bench.flagship((96, 96, 96))
        sim = Simulation(cfg, dom, device=cuda, results_parent=tmp_path, use_fused=True,
                         pair_dispatch="auto", phys_final_time=dom.units.phys_dt)
    sim.sim_init()
    t_pair, t_steps = sim.pair_probe_ms
    c_pair, c_steps = sim.time_pair_chains(pairs=20, chains=5)
    assert t_pair > 0 and t_steps > 0
    faster = separated_faster(c_pair, c_steps)
    if faster is not None:
        assert sim.pair_dispatch is (faster == 0), (t_pair, t_steps, c_pair, c_steps)


def test_sim_1_pair_dispatch_equals_per_step_on_card(cuda, tmp_path):
    """sim_1's A-A map at resolution 2 through ``Simulation``: pair dispatch
    runs B1b (one launch a pair, the chunks replayed from CUDA graphs) and
    equals the per-step route (B2/B3) within the step bounds after 40
    steps."""
    from tnl_lbm_tpu_torch.apps import sim_1
    from tnl_lbm_tpu_torch.kernels.fused_aa import FusedPairAAFull

    sims = []
    for pd in (True, False):
        sim = sim_1.build(2, device=cuda, streaming="AA", pair_dispatch=pd,
                          results_parent=tmp_path / str(pd))
        sim.sim_init()
        for _ in range(4):
            sim._advance(10)
        sims.append(sim)
    paired, stepped = sims
    assert isinstance(paired._pair, FusedPairAAFull) and stepped._pair is None
    assert paired._pair.kernel.launches == 20 and paired._step.even.launches == 0
    assert stepped._step.even.launches == stepped._step.odd.launches == 20
    assert paired.graph_replays >= 1 and paired._pair.plain_calls == 0
    for name, tol in (("f", 1e-6), ("rho", 2e-6), ("u", 1e-6)):
        assert float((getattr(paired, name) - getattr(stepped, name)).abs().max()) <= tol, name
    assert torch.isfinite(paired.u).all() and float(paired.u[0].max()) > 0


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
    """P2a through each load path, on a shape with face tiles, partial y
    tiles, a ragged last x segment and (for the ring) columns loaded as
    tensor boxes, and on one with partial y and z tiles, and P2b, bit for
    bit against their plain versions."""
    shape = (20, 36, 100)
    f = torch.randn((27,) + shape, device=cuda)
    for g in (f, torch.randn((27, 40, 20, 132), device=cuda)):
        want = probes.pair_pipeline_plain(g, passes)
        for load in probes.PIPELINE_LOADS:
            assert torch.equal(probes.pair_pipeline(g, passes, load=load), want), load
    assert probes.pipeline_geometry(shape, "ring")["boxed_columns"] == 6
    for g in (f, torch.randn((27, 2, 3, 5), device=cuda), torch.randn((27, 70, 9, 33),
                                                                        device=cuda)):
        tile = probes.pair_compute_only(g, passes)
        assert tile.shape == (27,) + probes.first_block(tuple(g.shape[1:]))
        assert torch.equal(tile, probes.pair_compute_only_plain(g, passes))


def test_pair_compute_only_geometry_on_card(cuda):
    """P2b's persistent grid: 256 threads (a column tile's plane), at least
    four blocks resident an SM (32 warps), every resident block launched
    but never more than the units; at 256^3 bit for bit its plain version
    at 0, 20 and 60 passes."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for shape, units in (((256, 256, 256), 256 * 256), ((2, 3, 5), 2), ((70, 9, 33), 280)):
        geo = probes.compute_only_geometry(shape)
        assert geo["threads"] == 256 and geo["seg_len"] == probes.PAIR_SEG_MAX
        assert geo["blocks_per_sm"] >= 4 and geo["units"] == units
        assert geo["blocks"] == min(units, geo["blocks_per_sm"] * sms)
    f = torch.randn((27, 256, 256, 256), device=cuda)
    for passes in (0, 20, 60):
        assert torch.equal(probes.pair_compute_only(f, passes),
                           probes.pair_compute_only_plain(f, passes)), passes


def test_pair_pipeline_geometry_and_refusals_on_card(cuda):
    """P2a's launch geometry (the library's) equals the one the sources'
    constants give for the card's SM count; the staged and ring paths
    refuse a z extent of no whole 16-byte pieces (the direct one takes it)."""
    from torch_cases import p2a_geometry

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for shape in ((256, 256, 256), (20, 36, 100), (9, 11, 45), (1024, 256, 256)):
        for load in probes.PIPELINE_LOADS:
            assert probes.pipeline_geometry(shape, load) == p2a_geometry(shape, load, sms)
    f = torch.randn((27, 9, 11, 45), device=cuda)
    assert torch.equal(probes.pair_pipeline(f, 20, load="direct"),
                       probes.pair_pipeline_plain(f, 20))
    for load in ("stages", "ring"):
        with pytest.raises(ValueError, match="Z % 4"):
            probes.pair_pipeline(f, 20, load=load)


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


@pytest.mark.parametrize("cid,eq", COLLISION_CASES, ids=[c + (f"-{e}" if e else "")
                                                         for c, e in COLLISION_CASES])
def test_collision_instances_match_plain_on_card(cuda, cid, eq):
    """Each collision of the family sources (csrc/coll_*.cu) through the
    A-B step (two steps, on the box of every 3D code with Z = 150) and the
    A-A even then odd steps (the box of every A-A code), each step against
    the plain version on the same input: |df| <= 1e-6 (KBC too), |drho| <=
    2e-6, |du| <= 1e-6."""
    shape, force = (24, 20, 150), (1e-5, -2e-6, 3e-6)
    for streaming, m in (("AB", bc_box(shape)), ("AA", aa_box(shape))):
        cfg = interop.config_from_spec(**collision_spec(cid, streaming, eq))
        dom = interop.domain_from_numpy(m, (False, False, True))
        step = (make_fused_step if streaming == "AB" else make_fused_step_aa)(cfg, dom, cuda)
        f = seeded_state(cfg, shape, cuda, seed=11)
        f = f + 1e-4 * torch.randn(f.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
        for it, parity in enumerate((0, 0) if streaming == "AB" else (0, 1)):
            fp, rp, up = step.plain(f, 0.02, u_in=U_IN, force=force, parity=parity)
            fk, rk, uk = step(f.clone() if parity == 0 else f, 0.02, u_in=U_IN, force=force,
                              parity=parity)
            torch.cuda.synchronize()
            assert float((fk - fp).abs().max()) <= KERNEL_TOL_F, (streaming, it)
            assert float((rk - rp).abs().max()) <= 2e-6, (streaming, it)
            assert float((uk - up).abs().max()) <= 1e-6, (streaming, it)
            f = fk
        counts = (step.kernel.launches,) if streaming == "AB" else (step.even.launches,
                                                                     step.odd.launches)
        assert counts == ((2,) if streaming == "AB" else (1, 1)) and step.plain_calls == 0


#: the collision cases of the force_field, B10 and B1b family instances: the
#: per-step compares' and CUM with the entropic equilibrium
ROUTE_CASES = COLLISION_CASES + (("CUM", "EQ_ENTROPIC"),)
ROUTE_IDS = [c + (f"-{e}" if e else "") for c, e in ROUTE_CASES]


def _close(k, p, label):
    torch.cuda.synchronize()
    d = tuple(float((a - b).abs().max()) for a, b in zip(k, p))
    assert d[0] <= KERNEL_TOL_F and d[1] <= 2e-6 and d[2] <= 1e-6, (label, d)


@pytest.mark.parametrize("cid,eq", ROUTE_CASES, ids=ROUTE_IDS)
def test_collision_routes_force_field_and_pair_match_plain_on_card(cuda, cid, eq):
    """Each collision's force_field instances (B4 A-B on the box of every 3D
    code, B2/B3 even then odd on the box of every A-A code, Z = 150) with a
    seeded per-site force of ~1e-5 and a homogeneous one, and its full-set
    pair (B1b, the box of every A-A code over several x segments), each
    against its plain version on the same input at the step bounds; CUM
    with eq_entropic also through the step's instances (its family row)."""
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair_aa

    shape, force = (24, 20, 150), (1e-5, -2e-6, 3e-6)
    rng = np.random.default_rng(13)
    field = torch.from_numpy((1e-5 * rng.standard_normal((3,) + shape)).astype(np.float32))
    field = field.to(cuda)
    kw = dict(u_in=U_IN, force=field, force_add=force)
    for streaming, m in (("AB", bc_box(shape)), ("AA", aa_box(shape))):
        cfg = interop.config_from_spec(**collision_spec(cid, streaming, eq))
        dom = interop.domain_from_numpy(m, (False, False, True))
        step = (make_fused_step if streaming == "AB" else make_fused_step_aa)(
            cfg, dom, cuda, force_field=True)
        assert step._instance[0] != "cum"
        f = seeded_state(cfg, shape, cuda, seed=11)
        f = f + 1e-4 * torch.randn(f.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
        if cid == "CUM":
            lean = (make_fused_step if streaming == "AB" else make_fused_step_aa)(cfg, dom, cuda)
            g = f
            for parity in ((0,) if streaming == "AB" else (0, 1)):
                p = lean.plain(g, 0.02, u_in=U_IN, force=force, parity=parity)
                k = lean(g.clone() if parity == 0 else g, 0.02, u_in=U_IN, force=force,
                         parity=parity)
                _close(k, p, (streaming, "step", parity))
                g = k[0]
        for parity in ((0,) if streaming == "AB" else (0, 1)):
            p = step.plain(f, 0.02, parity=parity, **kw)
            k = step(f.clone() if parity == 0 else f, 0.02, parity=parity, **kw)
            _close(k, p, (streaming, "force_field", parity))
            f = k[0]
        if streaming == "AA":
            pair = make_fused_pair_aa(cfg, dom, cuda)
            assert pair.geometry()["segments"] >= 2
            p = pair.plain(f, 0.02, u_in=U_IN, force=force)
            _close(pair(f, 0.02, u_in=U_IN, force=force), p, "B1b")
            assert pair.kernel.launches == 1 and pair.plain_calls == 0
            assert (step.even.launches, step.odd.launches) == (1, 1)
        else:
            assert step.kernel.launches == 1 and step.plain_calls == 0


@pytest.mark.parametrize("cid,eq", ROUTE_CASES, ids=ROUTE_IDS)
def test_collision_routes_nn_step_matches_plain_on_card(cuda, cid, eq):
    """Each collision's one-kernel NN step (B10), A-B, A-A even and odd, on
    the wall duct with the Carreau-Yasuda hook CY(0.1, 1, 2, 0.5), against
    the plain hooked step on the same input at the step bounds."""
    import dataclasses

    from tnl_lbm_tpu_torch.kernels.fused_nn_step import make_fused_nn_step
    from tnl_lbm_tpu_torch.ops.non_newtonian import CarreauYasuda, make_nn_forcing_hook
    from torch_cases import nn_case

    m, periodic, _, hper = nn_case("duct")
    model = CarreauYasuda(0.1, 1.0, 2.0, 0.5)
    for streaming in ("AB", "AA"):
        cfg = dataclasses.replace(
            interop.config_from_spec(**collision_spec(cid, streaming, eq)),
            forcing_hook=make_nn_forcing_hook(model, periodic=hper))
        step = make_fused_nn_step(cfg, interop.domain_from_numpy(m, periodic), model, hper,
                                  cuda)
        assert step._variant is None
        f = seeded_state(cfg, m.shape, cuda, seed=17)
        for parity in ((0,) if streaming == "AB" else (0, 1)):
            p = step.plain(f, 0.02, force=(1e-5, 0.0, 0.0), parity=parity)
            k = step(f, 0.02, force=(1e-5, 0.0, 0.0), parity=parity)
            _close(k, p, (streaming, parity))
            f = k[0]
        assert step.plain_calls == 0


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
    # a per-site profile: CUM_WELL's step has the profile instance, CUM's not
    cum = make_fused_step(interop.config_from_spec("CUM", "EQ", False, "AB"),
                          interop.domain_from_numpy(m, periodic), cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP Bprof"):
        cum(f, 0.02, u_in=torch.zeros((3,) + m.shape))
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


def nn_kernels_match_plain(cuda, shape, n_steps=2):
    """B9 and B10 (A-B; A-A even and odd) on the wall duct of ``shape``
    against their plain versions, the hook wrapped as the domain and, for
    B9, not; ``n_steps`` chained steps of B10 per pattern."""
    import dataclasses

    from tnl_lbm_tpu_torch.kernels.fused_nn import make_nn_force_kernel
    from tnl_lbm_tpu_torch.kernels.fused_nn_step import make_fused_nn_step
    from tnl_lbm_tpu_torch.ops.non_newtonian import make_nn_forcing_hook
    from torch_cases import NN_MODELS, nn_case

    m, periodic, model, per = nn_case("duct", shape=shape)
    dom = interop.domain_from_numpy(m, periodic)
    rho, u = nn_inputs(dom.shape, cuda, seed=8)
    for hook_per in (per, None):
        b9 = make_nn_force_kernel(NN_MODELS[model], dom, cuda, periodic=hook_per)
        fk, fp = b9(rho, u, 0.02), b9.plain(rho, u, 0.02)
        torch.cuda.synchronize()
        scale = float(fp.abs().max())
        assert scale > 0 and float((fk - fp).abs().max()) <= 1e-6 * scale, hook_per
    for streaming in ("AB", "AA"):
        cfg = dataclasses.replace(
            interop.config_from_spec("CUM_WELL", "EQ_WELL", True, streaming),
            forcing_hook=make_nn_forcing_hook(NN_MODELS[model], periodic=per))
        step = make_fused_nn_step(cfg, dom, NN_MODELS[model], per, cuda)
        fk = cfg.eq(cfg.lat, rho, u).float().contiguous()
        fp = fk.clone()
        for it in range(n_steps):
            parity = it % 2 if streaming == "AA" else 0
            fk, rk, uk = step(fk, 0.02, force=(1e-5, 0.0, 0.0), parity=parity)
            fp, rp, up = step.plain(fp, 0.02, force=(1e-5, 0.0, 0.0), parity=parity)
            torch.cuda.synchronize()
            assert float((fk - fp).abs().max()) <= 1e-6, f"{streaming} f, step {it}"
            assert float((rk - rp).abs().max()) <= 2e-6, f"{streaming} rho, step {it}"
            assert float((uk - up).abs().max()) <= 1e-6, f"{streaming} u, step {it}"
        assert step.plain_calls == 0


@pytest.mark.parametrize("shape", [(13, 176, 128), (3, 400, 352)], ids=["ragged", "x3"])
def test_nn_kernels_match_plain_on_x_segments(cuda, shape):
    """B9 and B10 where their own segment rule gives a last segment shorter
    than the others (X = 13 on a plane of 44 B10 and 88 B9 column tiles) and
    one segment shorter than SEG_MAX that covers X = 3 (a plane of more
    column tiles than the card runs at once): the march's first and last
    planes of every segment against the plain versions."""
    from tnl_lbm_tpu_torch.kernels.fused_nn import nn_geometry

    X = shape[0]
    for kind in (0, 1):
        geo = nn_geometry(kind, shape)
        assert geo["segments"] == -(-X // geo["seg_len"]) and geo["seg_len"] <= 32
        if X == 3:
            assert geo["segments"] == 1, geo
        else:
            assert geo["segments"] > 1 and X % geo["seg_len"] != 0, geo
    nn_kernels_match_plain(cuda, shape)


def test_nn_kernels_match_plain_on_a_tall_plane(cuda):
    """B9 and B10 with Y above 32767, where a slot's y no longer fits in the
    low 15 bits of its packed y << 16 | z table entry."""
    nn_kernels_match_plain(cuda, (3, 33000, 5))


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
    """Two pairs of the full-set A-A pair (B1b, one launch each) on a box
    no column tile divides, each against its plain version on the same
    input, and bit for bit the same at x segments of 19 planes (the last
    one starting at X - 1, where the box's OUTFLOW_RIGHT plane is) and of
    one plane."""
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair_aa

    shape = (20, 36, 40)
    if kind == "aa_box":
        m, periodic, u_in = aa_box(shape), (False, False, True), U_IN
    else:
        m = duct(shape, nothing=True) if kind == "duct" else np.zeros(shape, np.uint8)
        m[7, 9, 11] = GEO.NOTHING
        periodic = (True, True, True) if kind == "torus" else (True, False, False)
        u_in = None
    cfg = interop.config_from_spec(*AB_SPECS[spec], "AA")
    dom = interop.domain_from_numpy(m, periodic)
    pair = make_fused_pair_aa(cfg, dom, cuda)
    segmented = [make_fused_pair_aa(cfg, dom, cuda, seg_len=seg) for seg in (19, 1)]
    f = seeded_state(cfg, shape, cuda)
    f0, force = f.clone(), (1e-5, 0.0, 0.0)
    for it in range(2):
        fk, rk, uk = pair(f, 0.02, u_in, force)
        fp, rp, up = pair.plain(f, 0.02, u_in, force)
        torch.cuda.synchronize()
        assert float((fk - fp).abs().max()) <= 1e-6, f"f, pair {it}"
        assert float((rk - rp).abs().max()) <= 2e-6 and float((uk - up).abs().max()) <= 1e-6
        for other in segmented:
            fs, rs, us = other(f, 0.02, u_in, force)
            assert torch.equal(fs, fk) and torch.equal(rs, rk) and torch.equal(us, uk), \
                other.seg_len
        f = fk
    assert torch.equal(pair(f0.clone(), 0.02, u_in, force)[0], pair(f0, 0.02, u_in, force)[0])
    assert torch.equal(f0, seeded_state(cfg, shape, cuda))  # f is never written
    assert pair.kernel.launches == 4 and pair.plain_calls == 0


def test_two_kernel_pair_without_macro_and_refusals(cuda):
    """B1b without rho and u writes the same state; its geometry is the
    lean instance's on the duct (B1's 9 ring groups), and the 12-group ring
    with the outflow pull on the box of every code and in the full-set
    CUM_WELL instance launched on the duct (within 1e-6 of the lean one);
    a half-precision state or another shape raises."""
    from tnl_lbm_tpu_torch.kernels.fused import aa_variant
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair_aa

    from torch_cases import march_constants

    k = march_constants()
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AA")
    dom = interop.domain_from_numpy(duct((8, 16, 8), True), (True, False, False))
    f = seeded_state(cfg, (8, 16, 8), cuda)
    full, bare = make_fused_pair_aa(cfg, dom, cuda), make_fused_pair_aa(cfg, dom, cuda, False)
    f2, rho, u = bare(f, 0.02)
    assert rho is None and u is None and torch.equal(f2, full(f, 0.02)[0])
    assert full.variant == 3 and full.geometry()["ring_groups"] == 9
    assert full.geometry()["smem_bytes"] == k["RING_BYTES"] + k["CODE_BYTES"]
    full_set = make_fused_pair_aa(cfg, dom, cuda)
    full_set.variant = aa_variant(cfg, full_set.codes, lean=False)  # the full-set CUM_WELL one
    assert full_set.variant == 0 and full_set.geometry()["smem_bytes"] == k["OUT_SMEM_BYTES"]
    for a, b in zip(full_set(f, 0.02), full(f, 0.02)):
        assert float((a - b).abs().max()) <= 1e-6
    box = make_fused_pair_aa(cfg, interop.domain_from_numpy(aa_box((8, 16, 12)),
                                                            (False, False, True)), cuda)
    assert box.variant == 0 and box.geometry()["smem_bytes"] == k["OUT_SMEM_BYTES"]
    assert box.geometry()["ring_groups"] == 3 * k["OUT_GROUPS"]
    with pytest.raises(ValueError):
        bare(f.half(), 0.02)
    with pytest.raises(ValueError):
        bare(f[:, :4].contiguous(), 0.02)  # not the domain's shape


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


@pytest.mark.parametrize("variant", probes.ELEMENT_VARIANTS)
def test_element_pipeline_marches_segments_on_card(cuda, variant):
    """P3's march over several x segments (the last one short; the odd ones
    walking backwards) and three y tiles, each of the script's four
    variants: the interior equals the plain version's bit for bit."""
    tx, ty, passes = variant
    fpad = torch.randn((27, 80 + 4, 96 + 16, 20), device=cuda)
    assert probes.element_geometry(tx, ty, 80, 20)["segments"] == 3
    got = probes.element_pipeline(fpad, tx, ty, passes)
    want = probes.element_pipeline_plain(fpad, tx, ty, passes)
    torch.cuda.synchronize()
    assert torch.equal(probes.interior(got), probes.interior(want))


@pytest.mark.parametrize("n", [5, 20])
@pytest.mark.parametrize("res", [1, 2])
@pytest.mark.parametrize("kind", RESIDENT_KINDS)
@pytest.mark.parametrize("instance", RESIDENT_INSTANCES, ids=["srt", "srt_force", "clbm"])
def test_resident_chunk_equals_per_step_launches(cuda, instance, kind, res, n):
    """B5's resident chunk against ``n`` launches of the step kernel from the
    same state: f, rho and u bit for bit, the state in the buffer the
    ping-pong leaves it in; against the plain chained steps within 1e-5.
    sim2d_3's channel at res 1 and 2 with the disk's Bouzidi ring and the
    profile, without thetas and with the vector, and a box periodic in x
    and y; each instance; an odd and an even chunk."""
    collision, forced = instance
    m, periodic, bz = resident_case_2d(kind, res)
    cfg = interop.config_2d_from_spec(collision)
    step = make_fused_step_2d(cfg, interop.domain_from_numpy(m, periodic, lat=cfg.lat,
                                                             bouzidi=bz), cuda)
    chunk = FusedChunk2D(step)
    u_in, force = resident_inflow(kind, m.shape[1], cuda), FORCE_2D if forced else None
    f0 = seeded_2d(cfg, m.shape, cuda, seed=6)
    a, b = f0.clone(), torch.empty_like(f0)
    for _ in range(n):
        fs, rs, us = step(a, 0.02, u_in=u_in, force=force, out=b)
        a, b = fs, a
    c, d = f0.clone(), torch.empty_like(f0)
    fk, rk, uk = chunk(c, 0.02, n, u_in=u_in, force=force, out=d)
    torch.cuda.synchronize()
    assert fk is (d if n % 2 else c)
    assert torch.equal(fk, fs) and torch.equal(rk, rs) and torch.equal(uk, us)
    assert chunk.kernel.launches == 1 and chunk.steps == n and chunk.plain_calls == 0
    fp, rp, up = chunk.plain(f0, 0.02, n, u_in=u_in, force=force)
    for k, p in ((fk, fp), (rk, rp), (uk, up)):
        assert float((k - p).abs().max()) <= 1e-5


def test_resident_chunk_refuses_and_the_run_keeps_per_step(cuda, tmp_path, monkeypatch):
    """A lattice over the size rule: the wrapper raises, ``Simulation`` runs
    per-step launches (replayed from its graphs); a launch the kernel's own
    check refuses raises; the geometry of 128 x 32 on the card."""
    from tnl_lbm_tpu_torch.sim.state import Simulation

    cfg = interop.config_2d_from_spec("CLBM")
    m, periodic, _ = case_2d("channel", (640, 80))
    dom = interop.domain_from_numpy(m, periodic, lat=cfg.lat, phys_viscosity=0.02)
    with pytest.raises(ValueError, match="does not fit"):
        FusedChunk2D(make_fused_step_2d(cfg, dom, cuda))
    sim = Simulation(cfg, dom, device=cuda, sim_id="big", results_parent=tmp_path,
                     steps_per_dispatch=8, use_fused=True)
    sim.sim_init()
    for _ in range(4):
        sim._advance(8)
    assert sim._step.kernel.launches == 32 and sim.graph_replays == 3
    m, periodic, bz = resident_case_2d("ring", 1)
    chunk = FusedChunk2D(make_fused_step_2d(cfg, interop.domain_from_numpy(
        m, periodic, lat=cfg.lat, bouzidi=bz), cuda))
    geo = chunk.geometry()
    assert (geo["rows"], geo["threads"], geo["smem_bytes"]) == (8, 256, 26880)
    assert geo["active_clusters"] >= 1 and geo["cluster"] == 16
    monkeypatch.setattr(fused_2d, "resident_fits", lambda shape, thetas=False: True)
    chunk = FusedChunk2D(make_fused_step_2d(cfg, dom, cuda))  # past the Python rule
    with pytest.raises(RuntimeError, match="launch failed"):  # the C side refuses the launch
        chunk(seeded_2d(cfg, dom.shape, cuda), 0.02, 4)
    assert chunk.kernel.launches == 0


def test_resident_route_in_a_run_on_card(cuda, tmp_path):
    """A D2Q9 channel's chunks without statistics through the resident chunk
    (``resident_route``): chunks replayed from graphs equal the same chunks
    eager and the run's own per-step chunks, bit for bit; a replay adds the
    chunk's one launch; the step kernel is not launched.  ``Simulation``
    alone launches the step kernel per step."""
    runs = {}
    for route in ("resident", "per_step"):
        sim = driver_run("b5", tmp_path / route, stats=False, resident=route == "resident")
        for _ in range(3):
            sim._advance(8)
        runs[route] = sim
    assert runs["per_step"]._step.kernel.launches == 24 and not hasattr(runs["per_step"],
                                                                         "resident")
    sim = runs["resident"]
    assert sim._step.kernel.launches == 0 and sim.resident.kernel.launches == 3
    assert sim.graph_replays == 2
    assert torch.equal(sim.f, runs["per_step"].f) and torch.equal(sim.u, runs["per_step"].u)
    start, bufs, it = fields(sim), (sim.f, sim._spare), sim.iterations
    for _ in range(2):
        sim._advance(8)
    assert sim.resident.kernel.launches == 5
    graph = fields(sim)
    sim.f, sim._spare = bufs
    for name, t in start.items():
        getattr(sim, name).copy_(t)
    sim.iterations = it
    sim._graph_chunk = sim._chunk
    for _ in range(2):
        sim._advance(8)
    assert sim.resident.kernel.launches == 7 and sim._step.kernel.launches == 0
    for name, t in graph.items():
        assert torch.equal(t, getattr(sim, name)), name


@pytest.mark.parametrize("Z", [24, 256])
@pytest.mark.parametrize("load", ["ld4", "ld16", "tma"])
def test_window_copy_matches_plain_on_card(cuda, load, Z):
    """Every covering window of the script (wy 48, 40 and 36) through the
    pipelined load path equals the interior bit for bit, with 4 plane
    buffers (Z = 24) and with 2 or 3 (Z = 256); variant 7 raises."""
    fpad = torch.randn((27, 32 + 4, 64 + 16, Z), device=cuda)
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


# ----------------------------------------- the chunked dispatch as CUDA graphs

def driver_run(case, where, stats=True, resident=False):
    """A small ``Simulation`` on the card through one route: B5 on a D2Q9
    channel, B4 on sim_2's duct under A-B, B2/B3 per step and B1 in pairs
    under A-A, B1b in pairs on the box of every A-A code (CUM with
    eq_inv_cum, an inflow vector); 8-step chunks with a body force, both
    statistics windows on
    (``stats``); B5's chunks through its resident chunk (``resident``,
    ``torch_cases.resident_route``)."""
    from tnl_lbm_tpu_torch.sim.state import Simulation

    force = FORCE_2D if case == "b5" else (1e-5, 0.0, 0.0)

    class Run(Simulation):
        def body_force(self, phys_time):
            return np.asarray(force)

        def update_inflow(self, phys_time):
            return {"b5": np.asarray(U_IN_2D), "b1b": np.asarray(U_IN)}.get(case)

    if case == "b5":
        m, periodic, bz = case_2d("channel", (37, 40))
        cfg = interop.config_2d_from_spec("CLBM")
        dom = interop.domain_from_numpy(m, periodic, lat=cfg.lat, bouzidi=bz, phys_viscosity=0.02)
    elif case == "b1b":
        cfg = interop.config_from_spec(*AB_SPECS["CUM_INV_CUM"], "AA")
        dom = interop.domain_from_numpy(aa_box((16, 24, 20)), (False, False, True),
                                        phys_viscosity=0.02)
    else:
        streaming = "AB" if case == "b4" else "AA"
        cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, streaming)
        dom = interop.domain_from_numpy(duct((16, 24, 20), True), (True, False, False),
                                        phys_viscosity=0.02)
    sim = Run(cfg, dom, device="cuda", sim_id=case, results_parent=where, steps_per_dispatch=8,
              use_fused=True, pair_dispatch=case in ("b1", "b1b"))
    sim.collect_stats = sim.collect_stats2 = stats
    if resident:
        resident_route(sim)
    sim.sim_init()
    return sim


def fields(sim):
    return {n: getattr(sim, n).clone() for n in ("f", "rho", "u", "vm", "vm2", "vm_b", "vm2_b")
            if getattr(sim, n) is not None}


@pytest.mark.parametrize("case", ["b5", "b4", "b2_b3", "b1", "b1b"])
def test_graph_replay_equals_eager_chunk_and_counts_its_launches(cuda, tmp_path, case):
    """After the eager warm-up and a capture from each buffer, chunks
    replayed from CUDA graphs equal the same chunks run eagerly from the
    same state, bit for bit (f, rho, u, both statistics windows), and each
    replay adds the launches the eager chunk makes to the kernel's count."""
    from tnl_lbm_tpu_torch.kernels.fused import kernel_counters

    sim = driver_run(case, tmp_path)
    for _ in range(3):
        sim._advance(8)
    assert sim.graph_replays >= 1 and len(sim._graphs) >= 1
    start, bufs, it = fields(sim), (sim.f, sim._spare), sim.iterations
    counts = (sim.stat_counter, sim.stat2_counter)
    kernels = kernel_counters(sim._step, sim._pair)
    before, replays = [k.launches for k in kernels], sim.graph_replays
    for _ in range(2):
        sim._advance(8)
    assert sim.graph_replays == replays + 2
    replayed = [k.launches - b for k, b in zip(kernels, before)]
    graph = fields(sim)
    sim.f, sim._spare = bufs
    for n, t in start.items():
        getattr(sim, n).copy_(t)
    sim.iterations, (sim.stat_counter, sim.stat2_counter) = it, counts
    before = [k.launches for k in kernels]
    sim._graph_chunk = sim._chunk
    for _ in range(2):
        sim._advance(8)
    eager = [k.launches - b for k, b in zip(kernels, before)]
    assert replayed == eager and sum(eager) == (8 if case in ("b1", "b1b") else 16)
    for n, t in graph.items():
        assert torch.equal(t, getattr(sim, n)), n
    assert sum(getattr(w, "plain_calls", 0) for w in (sim._step, sim._pair)) == 0


def test_checkpoint_round_trip_on_the_card_is_bit_exact(cuda, tmp_path):
    """Three chunks in pairs, a background checkpoint, a resumed run of
    three more chunks, against six uninterrupted: bit for bit."""
    from tnl_lbm_tpu_torch.io import native

    whole = driver_run("b1", tmp_path / "whole")
    for _ in range(6):
        whole._advance(8)
    cut = driver_run("b1", tmp_path / "cut")
    for _ in range(3):
        cut._advance(8)
    cut.save_state(background=True)
    native.flush()
    resumed = driver_run("b1", tmp_path / "cut")
    assert resumed.start_iterations == 24 and native.errors() == 0
    for _ in range(3):
        resumed._advance(8)
    for n, t in fields(whole).items():
        assert torch.equal(t, getattr(resumed, n)), n


def test_native_writer_writes_and_flushes_beside_the_card(cuda, tmp_path):
    from tnl_lbm_tpu_torch.io import native

    data = torch.arange(1 << 16, dtype=torch.float32, device="cuda").cpu().numpy().tobytes()
    native.write_blob_async(tmp_path / "x.bin", data)
    native.flush()
    assert (tmp_path / "x.bin").read_bytes() == data and native.errors() == 0


# ------------------------------------------------------------------ IBM

IBM_GRID = (24, 16, 16)
#: case -> (sphere centre, radius, spacing, method, dirac): each operator
#: space of the solver - point-space ELLPACK A, node-space Gram B,
#: point-space ELLPACK G, the matrix-free Gram (clipped stencils)
IBM_CASES = {
    "A": ((10.0, 8.0, 8.0), 4.0, 1.2, "modified", "phi2"),
    "B": ((10.0, 8.0, 8.0), 5.0, 0.35, "original", "phi2"),
    "G": ((10.0, 8.0, 8.0), 4.0, 1.2, "original", "phi3"),
    "free": ((10.0, 8.0, 1.0), 3.0, 1.2, "original", "phi2"),
}
IBM_PINNED = 8  # CG iterations of the pinned solves
TOL_IBM_F = 1e-5  # relative to max |F|


def ibm_case(name, device):
    from tnl_lbm_tpu_torch.ibm import IBM
    from tnl_lbm_tpu_torch.ibm.generators import points_sphere
    from tnl_lbm_tpu_torch.utils.units import Lattice

    center, radius, sigma, method, dirac = IBM_CASES[name]
    units = Lattice(global_size=IBM_GRID, phys_origin=(0, 0, 0), phys_dl=1.0, phys_dt=1.0,
                    phys_viscosity=0.05)
    return IBM(units, points_sphere(center, radius, sigma), dirac=dirac, method=method,
               max_iters=IBM_PINNED, tol=1e-30, device=device)


def ibm_inputs(device, seed=3):
    rng = np.random.default_rng(seed)
    u = torch.as_tensor((rng.standard_normal((3,) + IBM_GRID) * 0.01).astype(np.float32))
    rho = torch.as_tensor((1 + 0.01 * rng.standard_normal(IBM_GRID)).astype(np.float32))
    return u.to(device), rho.to(device)


@pytest.mark.parametrize("name", sorted(IBM_CASES))
def test_ibm_solve_on_the_card_matches_the_cpu(cuda, name):
    """The solver built and run on the card against the same solver on the
    CPU: the same structure, the forces of the compact and the generic
    path within 1e-5 of max |F|, CG pinned."""
    card, host = ibm_case(name, cuda), ibm_case(name, "cpu")
    assert (card.space, card.method, card.u) == (host.space, host.method, host.u)
    assert card.weights.device.type == "cuda" and card.uflat.device.type == "cuda"
    for key in ("uflat", "uid", "E_idx"):
        a, b = getattr(card, key), getattr(host, key)
        assert (a is None) == (b is None) and (a is None or torch.equal(a.cpu(), b)), key
    u, rho = ibm_inputs("cpu")
    for generic in (False, True):
        cc, ch = card.hook_consts(), host.hook_consts()
        if generic:
            cc["uflat"] = ch["uflat"] = None
        want = host.compute_forces(u, rho, consts=ch)
        got = card.compute_forces(u.to(cuda), rho.to(cuda), consts=cc)
        assert got.device.type == "cuda" and card.last_cg_iters == host.last_cg_iters == IBM_PINNED
        scale = float(want.abs().max())
        assert scale > 0 and float((got.cpu() - want).abs().max()) <= TOL_IBM_F * scale


def test_ibm_node_solve_ignores_the_callers_tf32(cuda):
    """The node-space products run in full float32 whatever the caller set:
    with TF32 allowed the forces equal those without, bit for bit, and the
    caller's setting is back afterwards."""
    ibm = ibm_case("B", cuda)
    assert ibm.space == "node"
    u, rho = ibm_inputs(cuda)
    want = ibm.compute_forces(u, rho)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        got = ibm.compute_forces(u, rho)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got, want)


def sim_ibm_run(res, device, results, steps, use_fused=True, steps_per_dispatch=1):
    """sim_ibm at ``res`` for ``steps`` steps from the app's start, CG pinned."""
    from tnl_lbm_tpu_torch.apps import sim_ibm

    sim = sim_ibm.build(res, device=device, results_parent=results, use_fused=use_fused)
    sim.ibm.max_iters, sim.ibm.tol = IBM_PINNED, 1e-30
    sim.steps_per_dispatch = steps_per_dispatch
    sim.phys_final_time = (steps - 0.5) * sim.domain.units.phys_dt
    sim.sample_phases_at_finish = False
    assert sim.run() and sim.iterations == steps
    return sim


def test_sim_ibm_kernel_route_matches_the_plain_step(cuda, tmp_path):
    """sim_ibm res 2 through the hooked pipeline (B4 macro_only, the IBM
    solve, B4 force_field) against the plain hooked step on the card, 100
    steps, CG pinned: rho and u within the apps' 1e-5."""
    kernel = sim_ibm_run(2, cuda, tmp_path / "kernel", 100)
    plain = sim_ibm_run(2, cuda, tmp_path / "plain", 100, use_fused=False)
    assert kernel._step.route == "pipeline" and kernel._step.plain_calls == 0
    assert [k.kernel.launches for k in kernel._step.kernels] == [100, 100]
    for name in ("rho", "u"):
        a, b = getattr(kernel, name), getattr(plain, name)
        assert bool(torch.isfinite(a).all()) and float((a - b).abs().max()) <= 1e-5, name


def test_sim_ibm_in_chunks_equals_the_run_per_step(cuda, tmp_path):
    """An IBM run with steps_per_dispatch=10 takes the eager chunk on the
    card (the hook reads the host: no graph is captured), every step
    through the kernels, and equals the run per step within 1e-5 (the
    point-space scatter adds with atomics, so bit equality is not promised)."""
    chunked = sim_ibm_run(2, cuda, tmp_path / "chunked", 100, steps_per_dispatch=10)
    per_step = sim_ibm_run(2, cuda, tmp_path / "per_step", 100)
    assert chunked.graph_replays == 0 and not chunked._graphs
    assert [k.kernel.launches for k in chunked._step.kernels] == [100, 100]
    assert chunked._step.plain_calls == 0
    for name in ("f", "rho", "u"):
        a, b = getattr(chunked, name), getattr(per_step, name)
        assert float((a - b).abs().max()) <= 1e-5, name


# ------------------------------ the float64 instances and B4's profile instance

F64_TOL = {"f": 1e-12, "rho": 2e-12, "u": 1e-12}
F32_TOL = {"f": 1e-6, "rho": 2e-6, "u": 1e-6}
#: an inflow velocity and a force that float32 cannot hold
U_IN64 = (0.0312345678901234, 0.0051234567890123, -0.0041234567890123)
FORCE64 = (1.2345678901234e-5, 2.345678901234e-7, -3.45678901234e-7)


def cum_well(streaming, dtype):
    return interop.config_from_spec("CUM_WELL", "EQ_WELL", True, streaming, dtype=dtype)


def seeded64(shape, device, dtype=torch.float64, seed=7):
    """Well-conditioned DFs at a seeded developed state, built in float64."""
    rng = np.random.default_rng(seed)
    rho = torch.from_numpy(1 + 0.01 * rng.standard_normal(shape)).to(device)
    u = torch.from_numpy(0.02 * rng.standard_normal((3,) + shape)).to(device)
    cfg = cum_well("AB", "float64")
    return cfg.eq(cfg.lat, rho, u).to(dtype).contiguous()


def within(kernel_out, plain_out, tol, what):
    torch.cuda.synchronize()
    for name, a, b in zip(("f", "rho", "u"), kernel_out, plain_out):
        d = float((a.double() - b.double()).abs().max())
        assert d <= tol[name], (what, name, d)


@pytest.mark.parametrize("dtype,profile", [("float64", None), ("float64", "1yz"),
                                           ("float64", "xyz"), ("float32", "1yz"),
                                           ("float32", "xyz")])
def test_ab_f64_and_profile_instances_match_plain_on_card(cuda, dtype, profile):
    """B4's float64 step and its profile instance (float32 and float64) on
    the box of every code with Z past one block, two steps each from the
    same input on both sides, against the plain version: float64 at 1e-12,
    float32 at the step bounds.  A profile [3, 1, Y, Z] or [3, X, Y, Z] on
    the card is read in place through its strides."""
    shape = (24, 20, 150)
    m = bc_box(shape)
    step = make_fused_step(cum_well("AB", dtype), interop.domain_from_numpy(
        m, (False, False, True)), cuda)
    dt = torch.float64 if dtype == "float64" else torch.float32
    u_in = np.asarray(U_IN64)
    if profile is not None:
        X = shape[0] if profile == "xyz" else 1
        u_in = torch.from_numpy(0.03 * np.random.default_rng(3).standard_normal(
            (3, X) + shape[1:])).to(cuda, dt)
    f = seeded64(shape, cuda, dt)
    tol = F64_TOL if dtype == "float64" else F32_TOL
    for it in range(2):
        out = step(f, 0.02, u_in=u_in, force=FORCE64)
        within(out, step.plain(f, 0.02, u_in=u_in, force=FORCE64), tol, f"step {it}")
        assert out[0].dtype == dt
        f = out[0]
    kernel = step.kernel if profile is None else step.profile
    assert kernel.launches == 2 and step.plain_calls == 0
    assert kernel.name == "ab_step" + ("_f64" if dtype == "float64" else "") + (
        "_profile" if profile else "")


@pytest.mark.parametrize("kind", ["duct", "aa_box"])
def test_aa_f64_instances_match_plain_on_card(cuda, kind):
    """B2 and B3's float64 CUM_WELL steps, the odd step's lean instance on
    sim_2's duct and the full-set one on the box of every A-A code, four
    alternating steps from the same input on both sides at 1e-12."""
    if kind == "duct":
        shape, periodic = (32, 64, 64), (True, False, False)
        m = duct(shape, True)
    else:
        shape, periodic = (24, 20, 150), (False, False, True)
        m = aa_box(shape)
    step = make_fused_step_aa(cum_well("AA", "float64"), interop.domain_from_numpy(m, periodic),
                              cuda)
    assert step.variant == (3 if kind == "duct" else 0)
    f = seeded64(shape, cuda)
    for it in range(4):
        fp = step.plain(f, 0.02, u_in=U_IN64, force=FORCE64, parity=it % 2)
        out = step(f.clone() if it % 2 == 0 else f, 0.02, u_in=U_IN64, force=FORCE64,
                   parity=it % 2)
        within(out, fp, F64_TOL, f"step {it}")
        f = out[0]
    assert step.even.launches == step.odd.launches == 2 and step.plain_calls == 0


@pytest.mark.parametrize("periodic", PERIODIC,
                         ids=["".join("p" if p else "c" for p in per) for per in PERIODIC])
@pytest.mark.parametrize("seg_len", [None, 7], ids=["auto_segments", "segments_of_7"])
def test_pair_f64_matches_plain_on_card(cuda, periodic, seg_len):
    """B1's float64 instance (8 x 16 column tiles, no stages) on a 20x36x40
    box, which no column tile divides, with NOTHING sites, per periodic
    combination and in x segments of 7: two pairs from the same input on
    both sides at 1e-12; NOTHING sites keep their bits."""
    shape = (20, 36, 40)
    m = duct(shape, True)
    m[7, 9, 11] = GEO.NOTHING
    if periodic == (True, True, True):
        m[:] = GEO.FLUID
        m[3, 4, 5] = GEO.NOTHING
    pair = make_fused_pair2_aa(cum_well("AA", "float64"), interop.domain_from_numpy(m, periodic),
                               cuda, seg_len=seg_len)
    assert pair.store_dtype == torch.float64 and pair.kernel.name == "aa_pair_f64"
    geo = pair.geometry()
    assert (geo["ty"], geo["tz"], geo["stages"], geo["threads"]) == (8, 16, 0, 320)
    f = f0 = seeded64(shape, cuda)
    for it in range(2):
        out = pair(f, 0.02, force=FORCE64)
        within(out, pair.plain(f, 0.02, force=FORCE64), F64_TOL, f"pair {it}")
        f = out[0]
    keep = torch.as_tensor(m == GEO.NOTHING, device=cuda)
    assert torch.equal(f[:, keep], f0[:, keep])
    assert pair.kernel.launches == 2 and pair.plain_calls == 0


def test_f64_graph_route_keeps_the_profile_in_float64(cuda, tmp_path):
    """sim_2 --velocity --precision double at res 1 on the card: the chunks
    run as CUDA graphs through B4's float64 profile instance, whose profile
    on the card is the host profile in float64 (``_device_input``), and the
    replayed chunks equal the same chunks run eagerly, bit for bit."""
    from tnl_lbm_tpu_torch.apps import sim_2

    sim = sim_2.build(1, device=cuda, use_forcing=False, precision="double", use_fused=True,
                      results_parent=tmp_path)
    sim.sim_init()
    for _ in range(3):
        sim._advance(10)
    assert sim.graph_replays >= 1 and sim._step.profile.launches == 30
    prof = sim._device_input(sim.u_profile)
    assert prof.dtype == torch.float64 and prof.device.type == "cuda"
    assert torch.equal(prof.cpu(), torch.from_numpy(sim.u_profile))
    start, bufs, it = fields(sim), (sim.f, sim._spare), sim.iterations
    for _ in range(2):
        sim._advance(10)
    graph = fields(sim)
    sim.f, sim._spare = bufs
    for n, t in start.items():
        getattr(sim, n).copy_(t)
    sim.iterations = it
    sim._graph_chunk = sim._chunk
    for _ in range(2):
        sim._advance(10)
    for n, t in graph.items():
        assert torch.equal(t, getattr(sim, n)), n
    assert sim._step.plain_calls == 0 and sim._step.kernel.launches == 0


def test_float64_state_never_reaches_a_float32_entry_on_card(cuda):
    """A float32 kernel refuses a float64 state and a float64 one a float32
    state; neither launches."""
    m, periodic = duct((8, 16, 8), True), (True, False, False)
    for streaming in ("AB", "AA"):
        make = make_fused_step if streaming == "AB" else make_fused_step_aa
        s32 = make(cum_well(streaming, "float32"), interop.domain_from_numpy(m, periodic), cuda)
        s64 = make(cum_well(streaming, "float64"), interop.domain_from_numpy(m, periodic), cuda)
        for step, dt in ((s32, torch.float64), (s64, torch.float32)):
            with pytest.raises(NotImplementedError):
                step(torch.zeros((27, 8, 16, 8), device=cuda, dtype=dt), 0.02, parity=1)
    pair = make_fused_pair2_aa(cum_well("AA", "float64"), interop.domain_from_numpy(m, periodic),
                               cuda)
    with pytest.raises(ValueError):
        pair(torch.zeros((27, 8, 16, 8), device=cuda), 0.02)
    assert pair.kernel.launches == 0


# ------------------------------------------------ the sharded lattice (A13a)

def card_plan(counts, device):
    """A plan of prod(counts) shards, every one on ``device``."""
    from tnl_lbm_tpu_torch.parallel.sharded import Mesh, ShardPlan

    devices = np.empty(int(np.prod(counts)), dtype=object)
    devices[:] = [device] * devices.size
    return ShardPlan(Mesh(devices.reshape(counts), ("x", "y", "z")), ("x", "y", "z"))


HALO_SPECS = {"cum_well": ("CUM_WELL", "EQ_WELL", True), "cum_quad": ("CUM", "EQ", False),
              "cum_invcum": ("CUM", "EQ_INV_CUM", False)}


def halo_cases():
    """(name, map, periodic, streaming, spec, dtype) of the haloed kernels'
    compares: every code of each pattern and sim_2's duct (the lean odd
    instance)."""
    box = bc_box((12, 16, 10))
    for spec in HALO_SPECS:
        yield f"bc_box_{spec}", box, (False, False, True), "AB", spec, "float32"
        yield f"aa_box_{spec}", aa_box(box.shape), (False, False, True), "AA", spec, "float32"
    yield "bc_box_cum_well_f64", box, (False, False, True), "AB", "cum_well", "float64"
    yield "duct_lean", duct((8, 16, 16), True), (True, False, False), "AA", "cum_well", "float32"


@pytest.mark.parametrize("counts", [(2, 2, 1), (1, 2, 1)], ids=["x2y2", "y2"])
@pytest.mark.parametrize("case", list(halo_cases()), ids=lambda c: c[0])
def test_halo_kernels_match_plain_on_card(cuda, case, counts):
    """B4 and B3 on each shard's haloed block against their plain versions
    on the card, the step bounds (float64: 1e-12)."""
    from tnl_lbm_tpu_torch.parallel import sharded as sh

    _, m, periodic, streaming, spec, dtype = case
    cfg = interop.config_from_spec(*HALO_SPECS[spec], streaming, dtype=dtype)
    dom = interop.domain_from_numpy(m, periodic)
    plan = card_plan(counts, cuda)
    make = sh.make_sharded_fused_step if streaming == "AB" else sh.make_sharded_fused_step_aa
    step = make(cfg, dom, plan)
    rng = np.random.default_rng(4)
    rho = torch.from_numpy(1 + 0.01 * rng.standard_normal(m.shape))
    u = torch.from_numpy(0.02 * rng.standard_normal((3,) + m.shape))
    f = plan.shard_field(cfg.eq(cfg.lat, rho, u).to(cfg.compute_dtype), like_f=True)
    halo = step.exchange(f)
    ls = step.local_step
    tol = (1e-12, 2e-12, 1e-12) if dtype == "float64" else (1e-6, 2e-6, 1e-6)
    for k in range(plan.n_shards):
        kw = ({"map_arr_in": step.maps.blocks[k]} if streaming == "AB" else
              {"parity": 1, "map_ring_in": step.rings[k], "bflags": step.bflags[k]})
        out = ls(halo[k], 0.02, u_in=U_IN, force=(1e-5, 0.0, 0.0), **kw)
        plain = ls.plain(halo[k], 0.02, u_in=U_IN, force=(1e-5, 0.0, 0.0), **kw)
        for a, b, t in zip(out, plain, tol):
            assert float((a.double() - b.double()).abs().max()) <= t
    kernel = ls.kernel if streaming == "AB" else ls.odd
    assert kernel.name.endswith("_halo") and kernel.launches == plan.n_shards
    assert ls.plain_calls == 0


@pytest.mark.parametrize("streaming", ["AB", "AA"])
def test_sharded_runs_equal_one_shard_on_card(cuda, streaming, tmp_path):
    """sim_2 res 1 with the kernels, 20 steps through Simulation on 1, 2
    (y) and 4 (x/y) shards of one card: the same f, rho and u bit for bit,
    and within the step bounds of the unsharded kernels' run."""
    from tnl_lbm_tpu_torch.apps import sim_2

    runs = {}
    for name, counts in (("none", None), ("one", (1, 1, 1)), ("y2", (1, 2, 1)),
                         ("x2y2", (2, 2, 1))):
        sim = sim_2.build(1, device=cuda, streaming=streaming, use_fused=True,
                          results_parent=tmp_path / name, final_time=0.08)
        if counts is not None:
            sim = sim_2.Sim2(sim.cfg, sim.domain, device=cuda, sim_id=name,
                             results_parent=tmp_path / name, phys_final_time=0.08,
                             fx_lbm=sim.fx_lbm, analytical=sim.analytical, use_fused=True,
                             steps_per_dispatch=10, plan=card_plan(counts, cuda))
        sim.run()
        f = sim.f.gather() if counts is not None else sim.f
        runs[name] = (f, sim.rho, sim.u, sim.iterations)
        if counts is not None:
            assert sim._step.local_step.plain_calls == 0
    assert {r[3] for r in runs.values()} == {20}
    for name in ("y2", "x2y2"):
        for a, b in zip(runs[name][:3], runs["one"][:3]):
            assert torch.equal(a, b), name
    for a, b, t in zip(runs["one"][:3], runs["none"][:3], (1e-6, 2e-6, 1e-6)):
        assert float((a - b).abs().max()) <= t
