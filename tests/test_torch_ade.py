"""The port's D3Q7 advection-diffusion (ADE) stack on the CPU, held against the
JAX package.

The four ADE collisions, the plain ADE step for both patterns with every
ADEGEO code (transfer links and a per-site diffusion field included), the
interface flags and their packing, and the ADE step (B6), whose wrapper runs
its plain version on CPU tensors, go through the same seeded inputs as the
JAX functions; B6's plain version is held once against the JAX Pallas
kernel in interpret mode, as tests/test_ade.py runs it.  Bounds per step:
|dg| < 1e-6, |dphi| < 2e-6.

The JAX plain ADE step reads an A-A odd step's OUTFLOW_RIGHT sites from
the site's own slot at x-1, where its A-A Pallas kernel, the port's plain
step and the A-A coupled kernel read the opposite slot, as every other
A-A odd read does.  The A-A comparisons run the JAX step with that read
made the opposite slot's (``read_opp_at_aa_outflow``); the difference
itself is asserted once.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.kernels import fused_ade as jfa
from tnl_lbm_tpu.models import D3Q7
from tnl_lbm_tpu.ops import collision_ade as jcade
from tnl_lbm_tpu.ops import equilibrium as jeq
from tnl_lbm_tpu.ops import streaming as jstream
from tnl_lbm_tpu.sim import Domain as JDomain
from tnl_lbm_tpu.sim import LBMConfig as JConfig
from tnl_lbm_tpu.sim import step_ade as jsa
from tnl_lbm_tpu.utils import Lattice as JLattice
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.kernels import fused_ade as pfa
from tnl_lbm_tpu_torch.ops import collision_ade as pcade
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim import step_ade as psa
from tnl_lbm_tpu_torch.sim.step_ade import ADEGEO

from torch_cases import ADE_COLLISIONS, ADE_KINDS, PHI_IN, TCOEF, ade_box, ade_case

NU = 0.02


def seeded(shape, seed=3):
    """(g, u, nu field) as float32 numpy arrays, from a seeded phi and velocity."""
    rng = np.random.default_rng(seed)
    phi = (0.5 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    u = (0.02 * rng.standard_normal((3,) + shape)).astype(np.float32)
    nu = (0.01 + 0.02 * rng.random(shape)).astype(np.float32)
    g = np.array(jeq.eq_quadratic(D3Q7, jnp.asarray(phi), jnp.asarray(u)), np.float32)
    return g, u, nu


def jax_side(collision, m, periodic, streaming="AB"):
    cfg = JConfig(lat=D3Q7, collision=jcade.COLLISIONS_D3Q7[collision], eq=jeq.eq_quadratic,
                  streaming=streaming, compute_dtype=jnp.float32)
    dom = JDomain(lat=D3Q7, units=JLattice(m.shape, (0, 0, 0), 1.0, 1.0), map=m.copy(),
                  periodic=periodic)
    return cfg, dom


def port_side(collision, m, periodic, streaming="AB"):
    return (interop.ade_config_from_spec(collision, streaming),
            interop.domain_from_numpy(m, periodic, lat=interop.D3Q7))


def diff(j, p) -> float:
    return float(np.abs(np.asarray(j) - p.numpy()).max())


def read_opp_at_aa_outflow(monkeypatch):
    """For the rest of the calling test, the JAX plain ADE step's
    OUTFLOW_RIGHT pull reads the opposite slot at x-1, the A-A odd read of
    its Pallas kernel (module docstring).  Only ``step_ade``'s view of the
    streaming module changes, so only A-A ADE steps may be built under it."""

    def pull_shift_x_opp(lat, fpad, shape, dx=-1):
        return jnp.stack([jstream._shift_slices(fpad[int(lat.opp[q])],
                                                [dx] + [-int(c) for c in lat.c[q][1:]], shape)
                          for q in range(lat.Q)])

    patched = types.SimpleNamespace(**vars(jstream))
    patched.pull_shift_x = pull_shift_x_opp
    monkeypatch.setattr(jsa, "stream", patched)


# ------------------------------------------------------------------- ops

@pytest.mark.parametrize("nu_kind", ["scalar", "field"])
@pytest.mark.parametrize("collision", ADE_COLLISIONS)
def test_ade_collisions_match_jax(collision, nu_kind):
    shape = (6, 5, 4)
    g, u, nu_field = seeded(shape, seed=1)
    phi = g.sum(0)
    nu = nu_field if nu_kind == "field" else NU
    got = pcade.COLLISIONS_D3Q7[collision](D3Q7, torch.from_numpy(g), torch.from_numpy(phi),
                                          torch.from_numpy(u),
                                          torch.from_numpy(nu) if nu_kind == "field" else nu)
    want = jcade.COLLISIONS_D3Q7[collision](D3Q7, jnp.asarray(g), jnp.asarray(phi),
                                            jnp.asarray(u), jnp.asarray(nu))
    assert diff(want, got) < 1e-7
    assert sorted(pcade.COLLISIONS_D3Q7) == sorted(jcade.COLLISIONS_D3Q7)


def test_adegeo_tables_match_jax():
    assert [(c.name, int(c)) for c in psa.ADEGEO] == [(c.name, int(c)) for c in jsa.ADEGEO]
    assert {int(c) for c in psa.SOLID_PHASE} == {int(c) for c in jsa.SOLID_PHASE}
    assert {int(c) for c in psa._COLLIDING} == {int(c) for c in jsa._COLLIDING}
    assert {int(k): v for k, v in psa._SYM.items()} == {int(k): v for k, v in jsa._SYM.items()}
    assert {int(c) for c in pfa.SUPPORTED_ADE_CODES} == {int(c) for c in jfa.SUPPORTED_ADE_CODES}


def test_codes_present_reads_adegeo_on_d3q7():
    """A D3Q7 map's codes are ADEGEO members (WALL_BODY = 2 is GEO.INFLOW's
    integer, OUTFLOW_PE = 11 is GEO.SYM_LEFT's); a D3Q27 map keeps GEO."""
    m, periodic = ade_case("channel")
    codes = interop.domain_from_numpy(m, periodic, lat=interop.D3Q7).codes_present()
    assert codes == {ADEGEO.FLUID, ADEGEO.WALL_BODY, ADEGEO.INFLOW, ADEGEO.OUTFLOW_PE}
    assert all(type(c) is ADEGEO for c in codes)
    nse = interop.domain_from_numpy(m, periodic).codes_present()
    assert GEO.INFLOW in nse and all(type(c) is GEO for c in nse)
    assert interop.domain_from_numpy(m, periodic).lat.Q == 27


def test_pull_offset_reads_x_minus_2_like_jax():
    g = np.arange(7 * 8 * 4 * 4, dtype=np.float32).reshape(7, 8, 4, 4)
    for periodic in ((False, False, False), (True, True, False)):
        want = jsa._pull_offset(D3Q7, jnp.asarray(g), periodic, (8, 4, 4), -1)
        got = psa._pull_offset(D3Q7, torch.from_numpy(g), periodic, (8, 4, 4), -1)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("kind", ADE_KINDS)
def test_transfer_flags_and_packing_match_jax(kind):
    m, _ = ade_case(kind)
    np.testing.assert_array_equal(psa.transfer_direction_flags(D3Q7, m),
                                  jsa.transfer_direction_flags(D3Q7, m))
    packed = pfa.pack_transfer_flags(D3Q7, m)
    np.testing.assert_array_equal(packed, jfa.pack_transfer_flags(D3Q7, m))
    assert packed.max() < 64  # six bits: the kernels take one byte per site


# ------------------------------------------------------------ the plain step

def aa_box():
    """``ade_box`` with OUTFLOW_PE (A-B only) as OUTFLOW_RIGHT."""
    m = ade_box()
    m[m == int(ADEGEO.OUTFLOW_PE)] = int(ADEGEO.OUTFLOW_RIGHT)
    return m


@pytest.mark.parametrize("collision", ADE_COLLISIONS)
@pytest.mark.parametrize("streaming", ["AB", "AA"])
def test_make_ade_step_matches_jax(streaming, collision, monkeypatch):
    """Four steps (A-A: both parities twice) on every code, with transfer
    links and a per-site diffusion field; A-A against the JAX step with the
    opposite-slot outflow read (module docstring)."""
    m = ade_box() if streaming == "AB" else aa_box()
    periodic = (False, False, True)
    if streaming == "AA":
        read_opp_at_aa_outflow(monkeypatch)
    jcfg, jdom = jax_side(collision, m, periodic, streaming)
    cfg, dom = port_side(collision, m, periodic, streaming)
    jstep, pstep = jsa.make_ade_step(jcfg, jdom), psa.make_ade_step(cfg, dom)
    g, u, nu = seeded(m.shape)
    tdirs = jsa.transfer_direction_flags(D3Q7, m)
    gj, gp = jnp.asarray(g), torch.from_numpy(g)
    for it in range(4):
        gj, pj = jstep(gj, jnp.asarray(u), jnp.asarray(nu), phi_in=PHI_IN,
                       transfer_dirs=jnp.asarray(tdirs), transfer_coeff=TCOEF, parity=it % 2)
        gp, pp = pstep(gp, torch.from_numpy(u), torch.from_numpy(nu), phi_in=PHI_IN,
                       transfer_dirs=torch.from_numpy(tdirs), transfer_coeff=TCOEF,
                       parity=it % 2)
        assert diff(gj, gp) < 1e-6, f"g, step {it}"
        assert diff(pj, pp) < 2e-6, f"phi, step {it}"


def test_jax_plain_ade_step_reads_own_slot_at_aa_outflow(monkeypatch):
    """One A-A odd step from the same g: the port's plain step equals the
    JAX plain step with the opposite-slot outflow read everywhere, and the
    unchanged JAX step everywhere but the two x planes the outflow sites
    push to, where phi differs at the OUTFLOW_RIGHT sites."""
    m, periodic = aa_box(), (False, False, True)
    g, u, nu = seeded(m.shape)
    gp, pp = psa.make_ade_step(*port_side("CLBM", m, periodic, "AA"))(
        torch.from_numpy(g), torch.from_numpy(u), torch.from_numpy(nu), phi_in=PHI_IN, parity=1)
    args = (jnp.asarray(g), jnp.asarray(u), jnp.asarray(nu))
    jcfg, jdom = jax_side("CLBM", m, periodic, "AA")
    gj, pj = jsa.make_ade_step(jcfg, jdom)(*args, phi_in=PHI_IN, parity=1)
    assert diff(gj[:, :-2], gp[:, :-2]) < 1e-6 and diff(pj[:-1], pp[:-1]) < 2e-6
    outflow = m[-1] == ADEGEO.OUTFLOW_RIGHT
    assert float(np.abs(np.asarray(pj)[-1] - pp.numpy()[-1])[outflow].min()) > 1e-4
    read_opp_at_aa_outflow(monkeypatch)
    gj, pj = jsa.make_ade_step(jcfg, jdom)(*args, phi_in=PHI_IN, parity=1)
    assert diff(gj, gp) < 1e-6 and diff(pj, pp) < 2e-6


def test_make_ade_step_refuses_outflow_pe_under_aa():
    cfg, dom = port_side("SRT", ade_box(), (False, False, True), "AA")
    with pytest.raises(NotImplementedError, match="A-B"):
        psa.make_ade_step(cfg, dom)
    jcfg, jdom = jax_side("SRT", ade_box(), (False, False, True), "AA")
    with pytest.raises(NotImplementedError, match="A-B"):
        jsa.make_ade_step(jcfg, jdom)
    # a shard's block (the plain sharded step, tests/test_torch_sharded_2d_ade.py)
    # takes its map at each call
    block = psa.make_ade_step(*port_side("SRT", aa_box(), (False, False, True)),
                              local_shape=(4, 4, 4))
    with pytest.raises(ValueError, match="map_arr"):
        block(torch.zeros((7, 4, 4, 4)), torch.zeros((3, 4, 4, 4)), NU)


def test_make_ade_step_leaves_inflow_without_phi_in_like_jax():
    m, periodic = ade_case("channel")
    jcfg, jdom = jax_side("MRT", m, periodic)
    cfg, dom = port_side("MRT", m, periodic)
    g, u, _ = seeded(m.shape)
    gj, pj = jsa.make_ade_step(jcfg, jdom)(jnp.asarray(g), jnp.asarray(u), NU)
    gp, pp = psa.make_ade_step(cfg, dom)(torch.from_numpy(g), torch.from_numpy(u), NU)
    assert diff(gj, gp) < 1e-6 and diff(pj, pp) < 2e-6


# ------------------------------------------------------------ B6 plain version

@pytest.mark.parametrize("nu_kind", ["scalar", "field"])
@pytest.mark.parametrize("collision", ADE_COLLISIONS)
@pytest.mark.parametrize("kind", ADE_KINDS)
def test_fused_ade_plain_matches_jax_xla(kind, collision, nu_kind):
    """Three steps of B6 (its plain version on CPU tensors) against the JAX
    XLA ADE step with the transfer flags and coefficient passed in."""
    m, periodic = ade_case(kind)
    jcfg, jdom = jax_side(collision, m, periodic)
    cfg, dom = port_side(collision, m, periodic)
    step = pfa.make_fused_ade_step(cfg, dom, "cpu", variable_diffusion=nu_kind == "field",
                                   transfer_coeff=TCOEF)
    jstep = jsa.make_ade_step(jcfg, jdom)
    g, u, nu_field = seeded(m.shape, seed=4)
    nu_j = jnp.asarray(nu_field) if nu_kind == "field" else NU
    nu_p = torch.from_numpy(nu_field) if nu_kind == "field" else NU
    tdirs = jnp.asarray(jsa.transfer_direction_flags(D3Q7, m))
    gj, gp = jnp.asarray(g), torch.from_numpy(g)
    for it in range(3):
        gj, pj = jstep(gj, jnp.asarray(u), nu_j, phi_in=PHI_IN, transfer_dirs=tdirs,
                       transfer_coeff=TCOEF)
        gp, pp = step(gp, torch.from_numpy(u), nu_p, phi_in=PHI_IN)
        assert diff(gj, gp) < 1e-6, f"g, step {it}"
        assert diff(pj, pp) < 2e-6, f"phi, step {it}"
    assert step.plain_calls == 3 and step.kernel.launches == 0


def test_fused_ade_plain_matches_jax_pallas_interpret():
    """B6's plain version against the JAX Pallas ADE kernel in interpret
    mode at 8x16x8, on every code with transfer links and a nu field."""
    m, periodic = ade_case("box")
    jcfg, jdom = jax_side("CLBM", m, periodic)
    cfg, dom = port_side("CLBM", m, periodic)
    jstep = jfa.make_fused_ade_step(jcfg, jdom, tile=(8, 8), tiles_per_program=1,
                                    variable_diffusion=True, transfer_coeff=TCOEF)
    step = pfa.make_fused_ade_step(cfg, dom, "cpu", variable_diffusion=True,
                                   transfer_coeff=TCOEF)
    g, u, nu = seeded(m.shape, seed=6)
    gj, pj = jstep(jnp.asarray(g), jnp.asarray(u), jnp.asarray(nu), phi_in=PHI_IN)
    gp, pp = step(torch.from_numpy(g), torch.from_numpy(u), torch.from_numpy(nu), phi_in=PHI_IN)
    assert diff(gj, gp) < 1e-6 and diff(pj, pp) < 2e-6


def test_fused_ade_wrapper_contract():
    m, periodic = ade_case("box")
    cfg, dom = port_side("SRT", m, periodic)
    step = pfa.make_fused_ade_step(cfg, dom, "cpu", transfer_coeff=TCOEF)
    g, u, nu = (torch.from_numpy(a) for a in seeded(m.shape))
    out = torch.empty_like(g)
    g_new, phi = step(g, u, NU, phi_in=torch.tensor(PHI_IN), out=out)
    assert g_new is out and phi.shape == m.shape
    gp, pp = step.plain(g, u, NU, phi_in=PHI_IN)
    assert torch.equal(gp, g_new) and torch.equal(pp, phi)
    assert step.plain_calls == 1
    step.reset_counts()
    assert step.plain_calls == 0
    with pytest.raises(ValueError, match="variable_diffusion"):
        step(g, u, nu)
    with pytest.raises(ValueError):
        step(g, u, NU, out=g)
    # the sharded step's haloed block (tests/test_torch_sharded_2d_ade.py): by
    # default of the domain's shape, its map and flags given at each call
    halo = pfa.make_fused_ade_step(cfg, dom, "cpu", prepadded=True)
    assert halo.kernel.name == "ade_step_halo" and halo.shape == dom.shape
    with pytest.raises(ValueError, match="map_arr_in"):
        halo(g, u, NU)
    with pytest.raises(NotImplementedError, match="make_fused_coupled_step_aa"):
        pfa.make_fused_ade_step(interop.ade_config_from_spec("SRT", "AA"), dom, "cpu")
    with pytest.raises(NotImplementedError):
        interop.ade_config_from_spec("TRT")
    assert pfa.supports_ade(dom) and step.tflags is not None and step.tflags.dtype == torch.uint8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pfa.make_fused_ade_step(cfg, dom, "cuda")
