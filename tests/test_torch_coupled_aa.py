"""The A-A coupled pair (B8) and the extended A-A steps (B2, B3) on the CPU,
held against the JAX package.

On CPU tensors the wrappers run their plain versions.  The A-A steps'
plain versions (``FusedStepAA``) take every A-A code and the three
variants now; they are held against the JAX ``make_step`` on a box of
every code.  B8's plain version (``FusedCoupledAA``) is held against the
JAX plain coupled A-A steps (``make_step``, then ``make_ade_step``) on
sim_coupled's A-A maps (at 32 x 16 x 16; the res-1 maps run in
tests/test_torch_coupled.py's A-A wall witness) and on a box whose NSE and
ADE NOTHING sites differ, and its NSE half against the A-A steps bit for
bit; under ``-m slow`` both against the JAX Pallas kernels in interpret
mode.  Bounds
per step (tests/test_fused_kernel.py:65-67): |df| < 1e-6, |drho| < 2e-6,
|du| < 1e-6, |dg| < 1e-6, |dphi| < 2e-6.

The JAX plain ADE step pulls an A-A odd step's OUTFLOW_RIGHT sites from
the site's own slot at x-1, where its A-A Pallas kernel, the port's plain
ADE step and B8 pull the opposite slot, as every other A-A odd read does;
B8 is held against the JAX plain steps with that read made the opposite
slot's (tests/test_torch_ade.py ``read_opp_at_aa_outflow``, where the
difference itself is asserted).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.models import D3Q7, D3Q27
from tnl_lbm_tpu.ops import collision as jcol
from tnl_lbm_tpu.ops import collision_ade as jcade
from tnl_lbm_tpu.ops import equilibrium as jeq
from tnl_lbm_tpu.sim import Domain as JDomain
from tnl_lbm_tpu.sim import LBMConfig as JConfig
from tnl_lbm_tpu.sim import make_step as j_make_step
from tnl_lbm_tpu.sim import step_ade as jsa
from tnl_lbm_tpu.utils import Lattice as JLattice
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.apps import sim_coupled
from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa
from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step_aa
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim.step_ade import ADEGEO

from test_torch_ade import read_opp_at_aa_outflow
from torch_cases import AB_SPECS, PHI_IN, U_IN, aa_box, ade_aa_box, ade_box, sim_coupled_aa_maps

NU, FORCE, NU_ADE = 0.02, (1e-5, 0.0, 0.0), 0.01
BOUNDS = {"f": 1e-6, "g": 1e-6, "rho": 2e-6, "u": 1e-6, "phi": 2e-6}
SIM_COUPLED_RES1 = (64, 32, 32)
#: sim_coupled's A-A maps at half of res 1 along each axis, small for the CPU suite
SIM_COUPLED_SMALL = (32, 16, 16)


def seeded(shape, eq, seed=3):
    """(f at the equilibrium ``eq``, g, per-site nu) from a seeded state."""
    rng = np.random.default_rng(seed)
    rho = jnp.asarray((1 + 0.01 * rng.standard_normal(shape)).astype(np.float32))
    u = jnp.asarray((0.02 * rng.standard_normal((3,) + shape)).astype(np.float32))
    phi = jnp.asarray((0.5 + 0.1 * rng.standard_normal(shape)).astype(np.float32))
    nu = (0.005 + 0.01 * rng.random(shape)).astype(np.float32)
    return (np.array(eq(D3Q27, rho, u), np.float32),
            np.array(jeq.eq_quadratic(D3Q7, phi, u), np.float32), nu)


def jax_side(spec, collision, mn, pn, ma, pa):
    """(NSE config, ADE config, NSE domain, ADE domain) of the JAX package."""
    cid, eq, well = AB_SPECS[spec]
    units = JLattice(mn.shape, (0, 0, 0), 1.0, 1.0)
    return (JConfig(lat=D3Q27, collision=jcol.COLLISIONS_D3Q27[cid], eq=jeq.EQUILIBRIA[eq],
                    well=well, streaming="AA", compute_dtype=jnp.float32),
            JConfig(lat=D3Q7, collision=jcade.COLLISIONS_D3Q7[collision], streaming="AA",
                    compute_dtype=jnp.float32),
            JDomain(lat=D3Q27, units=units, map=mn.copy(), periodic=pn),
            JDomain(lat=D3Q7, units=units, map=ma.copy(), periodic=pa))


def port_pair(spec, collision, mn, pn, ma, pa, variable_diffusion=False):
    cfg = interop.config_from_spec(*AB_SPECS[spec], "AA")
    acfg = interop.ade_config_from_spec(collision, "AA")
    return make_fused_coupled_step_aa(cfg, interop.domain_from_numpy(mn, pn), acfg,
                                      interop.domain_from_numpy(ma, pa, lat=D3Q7), "cpu",
                                      variable_diffusion=variable_diffusion)


def max_diffs(names, ref, got):
    """name -> max |ref - got|."""
    return {n: float(np.abs(np.asarray(a) - b.numpy()).max()) for n, a, b in zip(names, ref, got)}


def within(d, label):
    assert all(v < BOUNDS[k] for k, v in d.items()), (label, d)


# ------------------------------------------------------- B2, B3: every code

@pytest.mark.parametrize("spec", sorted(AB_SPECS))
def test_aa_step_plain_matches_jax_on_every_code(spec):
    """Four alternating steps of the A-A steps' plain versions on a box of
    every A-A code (INFLOW, INFLOW_LEFT, OUTFLOW_EQ, OUTFLOW_RIGHT, the six
    SYM planes, PERIODIC, WALL, NOTHING), Z = 12, with an inflow velocity."""
    m, periodic = aa_box((8, 16, 12)), (False, False, True)
    jcfg, _, jdom, _ = jax_side(spec, "CLBM", m, periodic, m, periodic)
    jstep = j_make_step(jcfg, jdom)
    step = make_fused_step_aa(interop.config_from_spec(*AB_SPECS[spec], "AA"),
                              interop.domain_from_numpy(m, periodic), "cpu")
    a_a = {GEO.FLUID, GEO.WALL, GEO.INFLOW, GEO.INFLOW_LEFT, GEO.OUTFLOW_EQ, GEO.OUTFLOW_RIGHT,
           GEO.PERIODIC, GEO.NOTHING, GEO.SYM_TOP, GEO.SYM_BOTTOM, GEO.SYM_LEFT, GEO.SYM_RIGHT,
           GEO.SYM_BACK, GEO.SYM_FRONT}
    assert step.codes == a_a
    f0, _, _ = seeded(m.shape, jcfg.eq)
    fj, fp = jnp.asarray(f0), torch.from_numpy(f0.copy())
    for it in range(4):
        fj, rj, uj = jstep(fj, NU, u_in=jnp.asarray(U_IN), force=jnp.asarray(FORCE),
                           parity=it % 2)
        fp, rp, up = step(fp, NU, u_in=U_IN, force=FORCE, parity=it % 2)
        within(max_diffs(("f", "rho", "u"), (fj, rj, uj), (fp, rp, up)), (spec, it))
    assert step.plain_calls == 4 and step.even.launches == step.odd.launches == 0
    assert float(np.abs(fp.numpy() - f0).max()) > 1e-5


# ------------------------------------------------------------ B8: plain

def coupled_case(case):
    """(NSE spec, mn, pn, ma, pa): sim_coupled's A-A maps at
    SIM_COUPLED_SMALL with its CUM + eq_quadratic, or a box of every A-A
    code whose NSE and ADE NOTHING sites differ, with CUM_WELL."""
    if case == "sim_coupled":
        return ("CUM",) + sim_coupled_aa_maps(SIM_COUPLED_SMALL)
    shape = (12, 16, 8)
    return "CUM_WELL", aa_box(shape), (False, False, True), ade_aa_box(shape), (False, False, True)


def test_sim_coupled_aa_maps_are_the_apps(tmp_path):
    sim = sim_coupled.build(1, device="cpu", streaming="AA", use_fused=True,
                            results_parent=tmp_path)
    mn, pn, ma, pa = sim_coupled_aa_maps(SIM_COUPLED_RES1)
    np.testing.assert_array_equal(sim.domain.map, mn)
    np.testing.assert_array_equal(sim.ade_domain.map, ma)
    assert (sim.domain.periodic, sim.ade_domain.periodic) == (pn, pa)
    assert sim.cfg.collision.__name__ == "collide_cum" and not sim.cfg.well


@pytest.mark.parametrize("nu_kind", ["scalar", "field"])
@pytest.mark.parametrize("collision", ["CLBM", "MRT"])
@pytest.mark.parametrize("case", ["sim_coupled", "nothing_box"])
def test_coupled_aa_plain_matches_jax_steps(case, collision, nu_kind, monkeypatch):
    """Four alternating coupled steps: B8's plain version against the JAX
    plain steps (the ADE step with the opposite-slot outflow read, module
    docstring), and its NSE half bit for bit against the A-A steps'."""
    read_opp_at_aa_outflow(monkeypatch)
    spec, mn, pn, ma, pa = coupled_case(case)
    jcfg, jacfg, jdom, jadom = jax_side(spec, collision, mn, pn, ma, pa)
    jstep, jade = j_make_step(jcfg, jdom), jsa.make_ade_step(jacfg, jadom)
    field = nu_kind == "field"
    pair = port_pair(spec, collision, mn, pn, ma, pa, variable_diffusion=field)
    aa = make_fused_step_aa(pair.nse.cfg, interop.domain_from_numpy(mn, pn), "cpu")
    f0, g0, nu = seeded(mn.shape, jcfg.eq)
    nu_j, nu_p = (jnp.asarray(nu), torch.from_numpy(nu)) if field else (NU_ADE, NU_ADE)
    fj, gj = jnp.asarray(f0), jnp.asarray(g0)
    fp, gp, fa = torch.from_numpy(f0.copy()), torch.from_numpy(g0.copy()), torch.from_numpy(f0)
    assert ADEGEO.OUTFLOW_RIGHT in pair.ade.codes
    assert (ADEGEO.NOTHING in pair.ade.codes) == (case == "nothing_box")
    for it in range(4):
        par = it % 2
        fj, rj, uj = jstep(fj, NU, u_in=jnp.asarray(U_IN), force=jnp.asarray(FORCE), parity=par)
        gj, pj = jade(gj, uj, nu_j, phi_in=PHI_IN, parity=par)
        fp, gp, rp, up, pp = pair(fp, gp, NU, nu_p, u_in=U_IN, force=FORCE, phi_in=PHI_IN,
                                  parity=par)
        fa, ra, ua = aa(fa, NU, u_in=U_IN, force=FORCE, parity=par)
        assert torch.equal(fa, fp) and torch.equal(ra, rp) and torch.equal(ua, up), it
        within(max_diffs(("f", "rho", "u", "g", "phi"), (fj, rj, uj, gj, pj),
                         (fp, rp, up, gp, pp)), (case, it))
    assert pair.plain_calls == 4 and pair.even.launches == pair.odd.launches == 0
    assert float(np.abs(gp.numpy() - g0).max()) > 1e-5


def test_coupled_aa_wrapper_contract():
    """Even in place, odd out of place (into out_f/out_g when given); the
    plain version leaves its inputs alone and counts nothing; NOTHING sites
    of either map keep their DFs; the refusals name their reason and the
    A-B coupled kernel."""
    shape = (8, 16, 8)
    mn, ma, per = aa_box(shape), ade_aa_box(shape), (False, False, True)
    pair = port_pair("CUM_WELL", "CLBM", mn, per, ma, per)
    jcfg, *_ = jax_side("CUM_WELL", "CLBM", mn, per, ma, per)
    f0, g0, _ = seeded(shape, jcfg.eq)
    f, g = torch.from_numpy(f0.copy()), torch.from_numpy(g0.copy())
    keep = (torch.from_numpy(mn == GEO.NOTHING), torch.from_numpy(ma == ADEGEO.NOTHING))
    fe, ge, _, _, _ = pair(f, g, NU, NU_ADE, parity=0, out_f=torch.empty_like(f))
    assert fe is f and ge is g and not torch.equal(f, torch.from_numpy(f0))
    outs = torch.empty_like(f), torch.empty_like(g)
    fo, go, _, _, _ = pair(f, g, NU, NU_ADE, parity=1, out_f=outs[0], out_g=outs[1])
    assert fo is outs[0] and go is outs[1]
    fn, gn, _, _, _ = pair(fo, go, NU, NU_ADE, parity=1)
    assert fn is not fo and gn is not go
    for state, ref, mask in ((fn, f0, keep[0]), (gn, g0, keep[1])):
        assert mask.any() and torch.equal(state[:, mask], torch.from_numpy(ref)[:, mask])
    kept = fn.clone(), gn.clone()
    plain = pair.plain(fn, gn, NU, NU_ADE, parity=0)
    assert torch.equal(fn, kept[0]) and torch.equal(gn, kept[1]) and len(plain) == 5
    assert pair.plain_calls == 3
    pair.reset_counts()
    assert pair.plain_calls == 0
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AA")
    acfg = interop.ade_config_from_spec("CLBM", "AA")
    dom = interop.domain_from_numpy(mn, per)
    transfer = ade_box(shape)  # TRANSFER_FS/SF/SW links
    transfer[transfer == ADEGEO.OUTFLOW_PE] = ADEGEO.OUTFLOW_RIGHT
    with pytest.raises(NotImplementedError, match="neighbours' phi.*make_fused_coupled_step"):
        make_fused_coupled_step_aa(cfg, dom, acfg,
                                   interop.domain_from_numpy(transfer, per, lat=D3Q7), "cpu")
    pe = ma.copy()
    pe[-1, 1:-1, 1:-1] = ADEGEO.OUTFLOW_PE
    with pytest.raises(NotImplementedError, match="OUTFLOW_PE.*make_fused_coupled_step"):
        make_fused_coupled_step_aa(cfg, dom, acfg, interop.domain_from_numpy(pe, per, lat=D3Q7),
                                   "cpu")
    interp = mn.copy()
    interp[-1, 2:4, 2:4] = GEO.OUTFLOW_RIGHT_INTERP
    with pytest.raises(NotImplementedError, match="OUTFLOW_RIGHT_INTERP.*make_fused_coupled"):
        make_fused_coupled_step_aa(cfg, interop.domain_from_numpy(interp, per), acfg,
                                   interop.domain_from_numpy(ma, per, lat=D3Q7), "cpu")
    with pytest.raises(ValueError, match="streaming='AA'"):
        make_fused_coupled_step_aa(interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AB"),
                                   dom, acfg, interop.domain_from_numpy(ma, per, lat=D3Q7), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_fused_coupled_step_aa(cfg, dom, acfg,
                                       interop.domain_from_numpy(ma, per, lat=D3Q7), "cuda")


# ------------------------------------------- the JAX Pallas kernels, interpret

@pytest.mark.slow
@pytest.mark.parametrize("spec", ["CUM_WELL", "CUM"])
def test_coupled_aa_plain_matches_jax_pallas_interpret(spec):
    """B8's plain version against the JAX A-A coupled pair in interpret mode,
    four alternating steps with a nu field, on a 16x16x8 channel with
    sim_coupled's codes (ADE OUTFLOW_RIGHT included) and NOTHING sites that
    differ between the maps: every field within the bounds everywhere."""
    from tnl_lbm_tpu.kernels.fused_coupled import make_fused_coupled_step_aa as j_pair

    mn, pn, ma, pa = sim_coupled_aa_maps((16, 16, 8))
    mn[5, 7, 3] = GEO.NOTHING
    ma[9, 4, 5] = ADEGEO.NOTHING
    jcfg, jacfg, jdom, jadom = jax_side(spec, "CLBM", mn, pn, ma, pa)
    ref = j_pair(jcfg, jdom, jacfg, jadom, tile_even=(8, 8), tile_odd=(8, 8),
                 tiles_per_program=1, variable_diffusion=True)
    pair = port_pair(spec, "CLBM", mn, pn, ma, pa, variable_diffusion=True)
    f0, g0, nu = seeded(mn.shape, jcfg.eq)
    fj, gj, fp, gp = jnp.asarray(f0), jnp.asarray(g0), torch.from_numpy(f0), torch.from_numpy(g0)
    for it in range(4):
        j = ref(fj, gj, NU, jnp.asarray(nu), u_in=jnp.asarray(U_IN), force=jnp.asarray(FORCE),
                phi_in=PHI_IN, parity=it % 2)
        p = pair(fp, gp, NU, torch.from_numpy(nu), u_in=U_IN, force=FORCE, phi_in=PHI_IN,
                 parity=it % 2)
        within(max_diffs(("f", "g", "rho", "u", "phi"), j, p), (spec, it))
        fj, gj, fp, gp = j[0], j[1], p[0], p[1]


@pytest.mark.slow
def test_aa_step_plain_matches_jax_pallas_interpret_on_every_code():
    from tnl_lbm_tpu.kernels.fused_aa import make_fused_step_aa as j_make_fused_step_aa

    m, periodic = aa_box((8, 16, 8)), (False, False, True)
    jcfg, _, jdom, _ = jax_side("CUM", "CLBM", m, periodic, m, periodic)
    jstep = j_make_fused_step_aa(jcfg, jdom, tile_even=(8, 8), tile_odd=(8, 8))
    step = make_fused_step_aa(interop.config_from_spec(*AB_SPECS["CUM"], "AA"),
                              interop.domain_from_numpy(m, periodic), "cpu")
    f0, _, _ = seeded(m.shape, jcfg.eq)
    fj, fp = jnp.asarray(f0), torch.from_numpy(f0.copy())
    for it in range(4):
        fj, rj, uj = jstep(fj, NU, u_in=jnp.asarray(U_IN), force=jnp.asarray(FORCE),
                           parity=it % 2)
        fp, rp, up = step(fp, NU, u_in=U_IN, force=FORCE, parity=it % 2)
        within(max_diffs(("f", "rho", "u"), (fj, rj, uj), (fp, rp, up)), it)


def test_regcap_probe_refuses_without_a_card():
    """The register-cap probe of B8 (``kernels/regcap_probe.py``) runs on
    the card only."""
    from tnl_lbm_tpu_torch.kernels import regcap_probe

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        regcap_probe.main()
