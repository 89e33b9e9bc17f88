"""The operations bound of ``chip_smoke.py``'s JSON record, on the CPU with no
card: every FP32 instruction (FADD, FMUL, FFMA, FMNMX and their immediate
forms) is one issue slot of the FP32 pipe, whatever it computes, and every
MUFU one slot of the SFU; the rates are the card's own, its SM count times
128 (FP32) or 16 (SFU) lanes times its maximum SM clock."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

if str(ROOT / "tests") not in sys.path:
    sys.path.insert(0, str(ROOT / "tests"))

SASS = """
        code for sm_90a
                Function : toy_kernel
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;                   /* 0x00000a0000017a02 */
        /*0010*/                   FFMA R2, R3, R4, R5 ;                    /* 0x0000000403027223 */
        /*0020*/                   FADD R2, R2, 1 ;                         /* 0x3f80000002027421 */
        /*0030*/              @P0  FMUL R6, R2, R2 ;                        /* 0x0000000202060220 */
        /*0040*/                   FMUL32I R6, R6, 1.5 ;                    /* 0x3fc0000006067820 */
        /*0050*/                   FADD32I R7, R6, 2 ;                      /* 0x4000000006077421 */
        /*0060*/             @!P1  FFMA32I R7, R7, 0.5, R6 ;                /* 0x3f00000007077823 */
        /*0070*/                   FMNMX R8, R7, R6, !PT ;                  /* 0x0000000607087209 */
        /*0080*/                   MUFU.RCP R9, R8 ;                        /* 0x0000000800097308 */
        /*0090*/                   IMAD R10, R1, R1, RZ ;                   /* 0x00000001010a7224 */
        /*00a0*/                   DADD R12, R12, R14 ;                     /* 0x0000000e0c0c7229 */
        /*00b0*/                   HFMA2 R16, R16, R16, R16 ;               /* 0x0000001010107231 */
        /*00c0*/                   EXIT ;                                   /* 0x000000000000794d */
                Function : other_kernel
        /*0000*/                   FADD R0, R0, R0 ;                        /* 0x0000000000007221 */
        /*0010*/                   MUFU.EX2 R1, R0 ;                        /* 0x0000000000017308 */
        /*0020*/                   MUFU.RSQ R2, R0 ;                        /* 0x0000000000027308 */
"""


def test_sass_counts_one_fp32_slot_per_instruction():
    """FFMA counts once, as FADD and FMUL do (the pipe issues it in one slot),
    predicated instructions too; MUFU goes to the SFU, DADD to the FP64
    pipe; integer and half-precision instructions to none."""
    assert cs.count_sass_ops(SASS) == {"toy_kernel": (7, 1, 1), "other_kernel": (1, 2, 0)}


def test_bound_counts_issue_slots_at_the_cards_rates():
    """P2b at 256^3: a multiply and an add per DF and pass, 20 passes, 1080
    FP32 slots a site, ~0.54 ms on an H100 at 1980 MHz - twice what the
    data sheet's 67 TFLOP/s gave for it (FFMA as two operations)."""
    rates = cs.card_rates(132, 1980.0)
    assert rates["fp32_per_s"] == pytest.approx(132 * 128 * 1.98e9)
    assert rates["sfu_per_s"] == pytest.approx(132 * 16 * 1.98e9)
    sites = 256 ** 3
    ms, by = cs.bound(0.0, (1080, 0), rates=rates)
    assert by == "operations" and ms == pytest.approx(1080 * sites / rates["fp32_per_s"] * 1e3)
    assert abs(ms - 0.5417) < 1e-3
    assert ms / (1080 * sites / 67e12 * 1e3) == pytest.approx(2.0, rel=0.01)
    sfu_ms, by = cs.bound(0.0, (10, 100), rates=rates)  # the slower pipe sets it
    assert by == "operations" and sfu_ms == pytest.approx(100 * sites / rates["sfu_per_s"] * 1e3)
    ms, by = cs.bound(216.0, (1080, 0), rates=rates)  # P2a: bytes bound it
    assert by == "bytes" and ms == pytest.approx(216 * sites / 3.35e12 * 1e3)
    # a slower clock (a card below its power limit's clocks) gives a longer bound
    assert cs.bound(0.0, (1080, 0), rates=cs.card_rates(132, 1755.0))[0] > 0.5417
    assert cs.ops_ms(2 * 1080 * sites, 0, rates) == pytest.approx(2 * 0.5417, rel=1e-3)


#: a kernel whose IEEE division calls its slow path, as cuobjdump lists it
#: with addresses (the CALL's target a number) and as nvdisasm lists it
#: with labels (the target a name)
CALLS = {
    "addresses": """
                Function : div_kernel
        /*0000*/                   FFMA R2, R3, R4, R5 ;
        /*0010*/                   MUFU.RCP R6, R2 ;
        /*0020*/              @!P0 BRA 0x60 ;
        /*0030*/                   MOV R8, 0x50 ;
        /*0040*/                   CALL.REL.NOINC 0x90 ;
        /*0050*/                   BRA 0x60 ;
        /*0060*/                   FMUL R7, R6, R3 ;
        /*0070*/                   EXIT ;
        /*0080*/                   BRA 0x80;
        /*0090*/                   FFMA R9, R2, R6, -1 ;
        /*00a0*/                   MUFU.RCP R10, R9 ;
        /*00b0*/                   FADD R9, R9, R10 ;
        /*00c0*/                   RET.REL.NODEC R8 0x0 ;
""",
    "labels": """
                Function : div_kernel
        /*0000*/                   FFMA R2, R3, R4, R5 ;
        /*0010*/                   MUFU.RCP R6, R2 ;
        /*0020*/              @!P0 BRA `(.L_x_1) ;
        /*0030*/                   MOV R8, 0x50 ;
        /*0040*/                   CALL.REL.NOINC `($__internal_0_$__cuda_sm3x_div_rn_noftz_f32_slowpath) ;
        /*0050*/                   BRA `(.L_x_1) ;
.L_x_1:
        /*0060*/                   FMUL R7, R6, R3 ;
        /*0070*/                   EXIT ;
.L_x_2:
        /*0080*/                   BRA `(.L_x_2);
        .weak           $__internal_0_$__cuda_sm3x_div_rn_noftz_f32_slowpath
$__internal_0_$__cuda_sm3x_div_rn_noftz_f32_slowpath:
        /*0090*/                   FFMA R9, R2, R6, -1 ;
        /*00a0*/                   MUFU.RCP R10, R9 ;
        /*00b0*/                   FADD R9, R9, R10 ;
        /*00c0*/                   RET.REL.NODEC R8 `(div_kernel) ;
""",
}


@pytest.mark.parametrize("listing", CALLS)
def test_sass_counts_leave_out_the_slow_paths_on_request(listing):
    """By default the slow path counts, as every branch does; without
    ``subroutines`` the code from the CALL's target on is left out, and
    the call's own block and the body after it still count."""
    sass = CALLS[listing]
    assert cs.count_sass_ops(sass) == {"div_kernel": (4, 2, 0)}
    assert cs.count_sass_ops(sass, subroutines=False) == {"div_kernel": (2, 1, 0)}
    assert cs.count_sass_ops(SASS, subroutines=False) == cs.count_sass_ops(SASS)


def test_site_ops_source_has_a_kernel_per_collision_id():
    """tests/collision_site_ops.py writes one kernel per id of
    COLLISION_INSTANCES, with the collision type and storage its family
    kernel instantiates and the id's KBC bits as a constant."""
    import re

    import collision_site_ops as so

    from tnl_lbm_tpu_torch.kernels.fused import COLLISION_INSTANCES, WELL_COLLISIONS

    types = so.family_types()
    text = so.source()
    kernels = re.findall(r'extern "C" __global__ void (\w+)\(.*?\n.*?\n\s*fluid_site<(\w+), '
                         r"(\d+), (.+?)>\(", text)
    assert len(kernels) == len(COLLISION_INSTANCES) == 16
    for (name, well, kbc, ctype), (cid, (_, _, bits)) in zip(kernels, COLLISION_INSTANCES.items()):
        assert name == so.kernel_name(cid)
        assert (ctype, well == "true") == types[so.tag(cid)]
        assert (well == "true") == (cid in WELL_COLLISIONS)
        assert int(kbc) == bits
    assert {int(k) for _, _, k, _ in kernels} == set(range(8))  # N1-N4, C1-C4 and the rest
    assert "moments_local<WELL>(v, p.fx, p.fy, p.fz, false," in text
    assert "moments_local<WELL>(v, p.fx, p.fy, p.fz, true," in so.source(neumaier=True)


def test_fp64_pipe_counts_its_own_slots():
    """Every DFMA, DADD and DMUL is one slot of the FP64 pipe,
    which has half the FP32 pipe's lanes (34 TFLOP/s at 132 SMs and
    1980 MHz, DFMA as two operations); the bound takes the slowest pipe."""
    sass = SASS.replace("HFMA2 R16", "DFMA R16").replace("IMAD R10", "DMUL R10")
    assert cs.count_sass_ops(sass) == {"toy_kernel": (7, 1, 3), "other_kernel": (1, 2, 0)}
    rates = cs.card_rates(132, 1980.0)
    assert rates["fp64_per_s"] == pytest.approx(132 * 64 * 1.98e9)
    assert 2 * rates["fp64_per_s"] == pytest.approx(33.45e12, rel=1e-3)
    sites = 256 ** 3
    ms, by = cs.bound(465.0, (0, 0, 2300), rates=rates)  # a float64 site: bytes bind
    assert by == "bytes" and ms == pytest.approx(465 * sites / 3.35e12 * 1e3)
    ms, by = cs.bound(465.0, (821, 0, 3000), rates=rates)
    assert by == "operations" and ms == pytest.approx(3000 * sites / rates["fp64_per_s"] * 1e3)
    assert cs.ops_ms(0, 0, rates, 2300 * sites) > cs.ops_ms(2300 * sites, 0, rates)
