"""The port's coupled NSE+ADE path on the CPU, held against the JAX package.

The coupled A-B step (B7), whose wrapper runs its plain version on CPU
tensors, against the JAX XLA composition (NSE ``make_step``, then
``make_ade_step``) and against the port's A-B step (B4) then ADE step (B6)
plain versions; the ``coupled_kernel`` choice of ``CoupledSimulation``
against the JAX CoupledSimulation's; sim_coupled at resolution 1 against the JAX app
(map, units, counters, a few steps of rho, u and phi, and the VTK2D cut
with phi byte for byte); the refusals that name their ROADMAP items.
Bounds per step: |df| < 1e-6, |drho| < 2e-6, |du| < 1e-6, |dg| < 1e-6,
|dphi| < 2e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.apps import sim_coupled as jsim
from tnl_lbm_tpu.io import native
from tnl_lbm_tpu.models import D3Q7, D3Q27
from tnl_lbm_tpu.ops import collision as jcol
from tnl_lbm_tpu.ops import collision_ade as jcade
from tnl_lbm_tpu.ops import equilibrium as jeq
from tnl_lbm_tpu.sim import Domain as JDomain
from tnl_lbm_tpu.sim import LBMConfig as JConfig
from tnl_lbm_tpu.sim import make_step as j_make_step
from tnl_lbm_tpu.sim import step_ade as jsa
from tnl_lbm_tpu.sim.coupled import CoupledSimulation as JCoupled
from tnl_lbm_tpu.utils import Lattice as JLattice
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.apps import sim_coupled
from tnl_lbm_tpu_torch.kernels import fused_coupled
from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
from tnl_lbm_tpu_torch.kernels.fused_ade import make_fused_ade_step
from tnl_lbm_tpu_torch.kernels.fused_coupled import make_fused_coupled_step
from tnl_lbm_tpu_torch.sim.coupled import CoupledSimulation
from tnl_lbm_tpu_torch.sim.state import VTK2D

from test_torch_ade import read_opp_at_aa_outflow
from torch_cases import AB_SPECS, PHI_IN, TCOEF, U_IN, coupled_cases, local_scale, seeded_ade

NU, FORCE = 0.02, (1e-5, 0.0, 0.0)


def seeded(shape, seed=11):
    """(f for each NSE spec's equilibrium: a callable, g, nu field)."""
    rng = np.random.default_rng(seed)
    rho = (1 + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    u = (0.02 * rng.standard_normal((3,) + shape)).astype(np.float32)
    phi = (0.5 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    nu = (0.01 + 0.02 * rng.random(shape)).astype(np.float32)
    g = np.array(jeq.eq_quadratic(D3Q7, jnp.asarray(phi), jnp.asarray(u)), np.float32)
    return (lambda eq: np.array(eq(D3Q27, jnp.asarray(rho), jnp.asarray(u)), np.float32)), g, nu


def diffs(j, p):
    return [float(np.abs(np.asarray(a) - b.numpy()).max()) for a, b in zip(j, p)]


def within(d, label):
    """d = [df, dg, drho, du, dphi] against the step bounds."""
    bounds = (1e-6, 1e-6, 2e-6, 1e-6, 2e-6)
    assert all(x < b for x, b in zip(d, bounds)), (label, d)


@pytest.mark.parametrize("spec", sorted(AB_SPECS))
@pytest.mark.parametrize("case", ["channel", "box"])
def test_coupled_plain_matches_jax_xla_and_b4_then_b6(case, spec):
    """Three coupled steps with a per-site nu field and transfer links:
    B7's plain version against the JAX XLA steps, and bit for bit against
    the port's B4 then B6 plain versions."""
    label, mn, pn, ma, pa = next(c for c in coupled_cases() if c[0] == case)
    cid, eq, well = AB_SPECS[spec]
    jcfg = JConfig(lat=D3Q27, collision=jcol.COLLISIONS_D3Q27[cid], eq=jeq.EQUILIBRIA[eq],
                   well=well, compute_dtype=jnp.float32)
    jacfg = JConfig(lat=D3Q7, collision=jcade.collide_clbm_ade, compute_dtype=jnp.float32)
    units = JLattice(mn.shape, (0, 0, 0), 1.0, 1.0)
    jstep = j_make_step(jcfg, JDomain(lat=D3Q27, units=units, map=mn.copy(), periodic=pn))
    jade = jsa.make_ade_step(jacfg, JDomain(lat=D3Q7, units=units, map=ma.copy(), periodic=pa))
    cfg = interop.config_from_spec(cid, eq, well, "AB")
    acfg = interop.ade_config_from_spec("CLBM")
    dom = interop.domain_from_numpy(mn, pn)
    adom = interop.domain_from_numpy(ma, pa, lat=interop.D3Q7)
    one = make_fused_coupled_step(cfg, dom, acfg, adom, "cpu", variable_diffusion=True,
                                  transfer_coeff=TCOEF)
    b4 = make_fused_step(cfg, dom, "cpu")
    b6 = make_fused_ade_step(acfg, adom, "cpu", variable_diffusion=True, transfer_coeff=TCOEF)
    f_of, g0, nu = seeded(mn.shape)
    f0 = f_of(jcfg.eq)
    tdirs = jnp.asarray(jsa.transfer_direction_flags(D3Q7, ma))
    fj, gj = jnp.asarray(f0), jnp.asarray(g0)
    fp, gp = torch.from_numpy(f0.copy()), torch.from_numpy(g0.copy())
    nu_t = torch.from_numpy(nu)
    for it in range(3):
        fj, rj, uj = jstep(fj, NU, u_in=jnp.asarray(U_IN), force=jnp.asarray(FORCE))
        gj, pj = jade(gj, uj, jnp.asarray(nu), phi_in=PHI_IN, transfer_dirs=tdirs,
                      transfer_coeff=TCOEF)
        f2, r2, u2 = b4(fp, NU, u_in=U_IN, force=FORCE)
        g2, p2 = b6(gp, u2, nu_t, phi_in=PHI_IN)
        fp, gp, rp, up, pp = one(fp, gp, NU, nu_t, u_in=U_IN, force=FORCE, phi_in=PHI_IN)
        within(diffs((fj, gj, rj, uj, pj), (fp, gp, rp, up, pp)), f"{label} {spec} step {it}")
        for a, b in zip((f2, g2, r2, u2, p2), (fp, gp, rp, up, pp)):
            assert torch.equal(a, b), f"B4 then B6 differs from B7's plain version, step {it}"
    assert one.plain_calls == 3 and one.kernel.launches == 0


# ---------------------------------------------------- CoupledSimulation

class PeriodicCoupled(CoupledSimulation):
    def body_force(self, t):
        return np.array([1e-4, 0.0, 0.0])


def coupled_pair(tmp_path, tag, streaming, use_fused, transfer=False, cls=PeriodicCoupled):
    """The JAX and the port CoupledSimulation on one small periodic config
    (tests/test_ade.py:271), neither initialised."""
    n = 8
    ma = np.zeros((n, 16, 16), np.uint8)
    if transfer:
        ma[5, 4:-4, 4:-4] = jsa.ADEGEO.TRANSFER_FS
        ma[6, 4:-4, 4:-4] = jsa.ADEGEO.TRANSFER_SF
    mn = np.zeros((n, 16, 16), np.uint8)
    per = (True,) * 3
    units = JLattice((n, 16, 16), (0, 0, 0), 1.0, 1.0, phys_viscosity=0.02)
    jcfg = JConfig(lat=D3Q27, collision=jcol.collide_cum_well, eq=jeq.eq_well, well=True,
                   streaming=streaming)
    jacfg = JConfig(lat=D3Q7, collision=jcade.collide_clbm_ade, streaming=streaming)
    ref = JCoupled(jcfg, JDomain(lat=D3Q27, units=units, map=mn, periodic=per), jacfg,
                   JDomain(lat=D3Q7, units=units, map=ma, periodic=per), sim_id=f"j_{tag}",
                   results_parent=tmp_path, use_fused=use_fused)
    cfg = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, streaming)
    acfg = interop.ade_config_from_spec("CLBM", streaming)
    port = cls(cfg, interop.domain_from_numpy(mn, per, phys_viscosity=0.02), acfg,
               interop.domain_from_numpy(ma, per, lat=interop.D3Q7), device="cpu",
               sim_id=f"p_{tag}", results_parent=tmp_path, use_fused=use_fused)
    return ref, port


@pytest.mark.parametrize("streaming,use_fused,transfer", [
    ("AB", True, False), ("AB", True, True), ("AB", False, False), ("AA", False, False),
    ("AA", True, False), ("AA", True, True)])
def test_coupled_kernel_choice_matches_jax(tmp_path, streaming, use_fused, transfer):
    """The port picks the JAX CoupledSimulation's path ("xla" is the port's
    "plain"), the A-A coupled pair included; where the JAX one degrades to
    its two-kernel path with the ADE half unfused (the A-A pair with
    transfer codes), the port raises naming the reason and the A-B path."""
    ref, port = coupled_pair(tmp_path, f"{streaming}{use_fused}{transfer}", streaming,
                             use_fused, transfer)
    assert ref.can_compute()
    ref.sim_init()
    ref._lock.release()
    if streaming == "AA" and use_fused and transfer:
        assert ref.coupled_kernel == "two-kernel"
        with pytest.raises(NotImplementedError, match="neighbours' phi.*A-B coupled kernel"):
            port.sim_init()
        return
    port.sim_init()
    assert port.coupled_kernel == {"xla": "plain"}.get(ref.coupled_kernel, ref.coupled_kernel)


class TwoKernelCoupled(PeriodicCoupled):
    """Drops the coupled kernel after ``sim_init``, as chip_smoke.py does to
    hold B7 against B4 then B6: ``_advance`` then runs the A-B step and the
    ADE step that ``sim_init`` built."""

    def sim_init(self):
        super().sim_init()
        self._coupled_step, self.coupled_kernel = None, "two-kernel"


def test_two_kernel_path_runs_b4_then_b6(tmp_path):
    """With the coupled kernel dropped, use_fused runs the A-B step then the
    ADE step in the same ping-pong buffers, with the one-kernel path's
    result bit for bit."""
    _, one = coupled_pair(tmp_path, "one", "AB", True, transfer=True)
    _, two = coupled_pair(tmp_path, "two", "AB", True, transfer=True, cls=TwoKernelCoupled)
    one.sim_init()
    two.sim_init()
    assert (one.coupled_kernel, two.coupled_kernel) == ("one-kernel-AB", "two-kernel")
    buffers = {id(two.f), id(two._spare), id(two.g), id(two._g_spare)}
    one._advance(3)
    two._advance(3)
    assert {id(two.f), id(two._spare), id(two.g), id(two._g_spare)} == buffers
    for name in ("f", "g", "rho", "u", "phi"):
        assert torch.equal(getattr(one, name), getattr(two, name)), name
    assert one._coupled_step.plain_calls == 3 and two._coupled_step is None
    assert two._step.plain_calls == 3 and two._ade_step.plain_calls == 3
    for s in (one, two):
        s._lock.release()


# ------------------------------------------------------------ sim_coupled

def build_both(tmp_path, use_fused, streaming="AB"):
    return (sim_coupled.build(1, device="cpu", use_fused=use_fused, streaming=streaming,
                              results_parent=tmp_path / "port"),
            jsim.build(1, results_parent=tmp_path / "jax", streaming=streaming))


def test_sim_coupled_build_matches_jax(tmp_path):
    port, ref = build_both(tmp_path, True)
    for a, b in ((port.domain, ref.domain), (port.ade_domain, ref.ade_domain)):
        np.testing.assert_array_equal(a.map, b.map)
        assert a.periodic == tuple(b.periodic) and a.lat.Q == b.lat.Q
    for name in ("phys_dl", "phys_dt", "phys_viscosity"):
        assert getattr(port.domain.units, name) == getattr(ref.domain.units, name)
    assert port.lbm_inflow_vx == ref.lbm_inflow_vx > 0
    assert (port.ade_diffusion, port.phi_inflow) == (ref.ade_diffusion, ref.phi_inflow)
    assert port.cfg.collision.__name__ == ref.cfg.collision.__name__
    assert port.ade_cfg.collision.__name__ == ref.ade_cfg.collision.__name__
    assert {k: c.period for k, c in port.cnt.items()} == {k: ref.cnt[k].period for k in port.cnt}
    assert [(p.axis, p.name, p.position) for p in port.probes_2d] == \
        [(p.axis, p.name, p.position) for p in ref.probes_2d]


@pytest.mark.parametrize("use_fused", [True, False], ids=["b7_plain", "plain"])
def test_sim_coupled_steps_match_jax(tmp_path, use_fused):
    """Five coupled steps of sim_coupled res 1 from the app's own start: the
    port (B7's plain version, or the plain steps) against the JAX app's XLA
    path, in rho, u and phi."""
    port, ref = build_both(tmp_path, use_fused)
    assert ref.can_compute() and port.can_compute()
    ref.sim_init()
    port.sim_init()
    for it in range(5):
        ref._advance(1)
        port._advance(1)
        d = diffs((ref.rho, ref.u, ref.phi), (port.rho, port.u, port.phi))
        assert d[0] < 2e-6 and d[1] < 1e-6 and d[2] < 2e-6, (it, d)
    assert float(port.phi[1].max()) > 0
    assert port.coupled_kernel == ("one-kernel-AB" if use_fused else "plain")
    ref._lock.release()
    port._lock.release()


WALL_STEPS = 20


def wall_growth_against_jax(tmp_path, streaming, monkeypatch):
    """WALL_STEPS steps of sim_coupled res 1 through the port's coupled
    kernel's plain version (B7 on A-B, B8 on A-A) and the JAX app's plain
    path, each port step started from the JAX app's state: f, rho and u
    held to the step bounds, g and phi to them relative to ``local_scale``
    of the input g.  On A-A the JAX plain ADE step reads OUTFLOW_RIGHT
    sites from the opposite slot, as B8 does (tests/test_torch_ade.py
    ``read_opp_at_aa_outflow``).  Returns the histories, per step [JAX,
    port], of max |phi| on the walls past the inlet plane and of the
    minimum of phi on the y band the walls cannot reach yet."""
    if streaming == "AA":
        read_opp_at_aa_outflow(monkeypatch)
    port, ref = build_both(tmp_path, True, streaming)
    assert ref.can_compute() and port.can_compute()
    ref.sim_init()
    port.sim_init()
    assert port.coupled_kernel == f"one-kernel-{streaming}"
    Y = ref.ade_domain.shape[1]
    walls, band_min = [], []
    for it in range(1, WALL_STEPS + 1):
        port.f = torch.from_numpy(np.array(ref.f))
        port.g = torch.from_numpy(np.array(ref.g))
        scale = local_scale(port.g)
        ref._advance(1)
        port._advance(1)
        d = diffs((ref.f, ref.rho, ref.u), (port.f, port.rho, port.u))
        assert d[0] < 1e-6 and d[1] < 2e-6 and d[2] < 1e-6, (it, d)
        for name, bound in (("g", 1e-6), ("phi", 2e-6)):
            a, b = torch.from_numpy(np.array(getattr(ref, name))), getattr(port, name)
            rel = float(((a.double() - b.double()).abs() / scale).max())
            assert rel < bound, (it, name, rel)
        phi_j, phi_p = np.asarray(ref.phi), port.phi.numpy()
        walls.append([float(np.abs(p[1:, [0, -1]]).max()) for p in (phi_j, phi_p)])
        if it < Y // 2 - 1:  # y it+1 .. Y-it-2: out of the walls' reach after it steps
            band = (slice(None), slice(it + 1, Y - it - 1))
            band_min.append([float(p[band].min()) for p in (phi_j, phi_p)])
    ref._lock.release()
    port._lock.release()
    return np.array(walls), np.array(band_min)


def test_sim_coupled_wall_growth_and_inlet_undershoot_match_jax(tmp_path, monkeypatch):
    """The JAX app's own faults, seen in the port alike: phi at the
    WALL_BODY walls grows about 1.9x per step, and the inlet's step front
    undershoots below zero where the walls cannot reach yet (the port's
    side: B7's plain version; ``wall_growth_against_jax``)."""
    walls, band_min = wall_growth_against_jax(tmp_path, "AB", monkeypatch)
    rates = walls[-5:] / walls[-6:-1]
    assert walls[-1, 0] > 1e3 and ((rates > 1.8) & (rates < 2.0)).all(), (walls, rates)
    np.testing.assert_allclose(walls[:, 1], walls[:, 0], rtol=2e-6)
    assert band_min[:, 0].min() < -0.05, band_min
    np.testing.assert_allclose(band_min[:, 1], band_min[:, 0], rtol=0, atol=2e-6)


def test_sim_coupled_aa_walls_stay_bounded_unlike_ab(tmp_path, monkeypatch):
    """Under A-A streaming, through B8's plain version, the WALL_BODY walls
    do not grow as on A-B: |phi| on them peaks below 0.2 and decays, below
    half its peak over the last two steps of WALL_STEPS (on A-B it passes
    1e3), while the inlet front undershoots as on A-B; the port agrees with
    the JAX app's A-A run."""
    walls, band_min = wall_growth_against_jax(tmp_path, "AA", monkeypatch)
    peak = walls[:, 0].max()
    assert 0 < peak < 0.2 and walls[-2:, 0].max() < peak / 2, walls
    np.testing.assert_allclose(walls[:, 1], walls[:, 0], rtol=2e-6)
    assert band_min[:, 0].min() < -0.05, band_min
    np.testing.assert_allclose(band_min[:, 1], band_min[:, 0], rtol=0, atol=2e-6)


def test_sim_coupled_vtk2d_with_phi_matches_jax_byte_for_byte(tmp_path):
    port, ref = build_both(tmp_path, True)
    rng = np.random.default_rng(9)
    shape = ref.domain.shape
    rho = (1 + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    u = (0.02 * rng.standard_normal((3,) + shape)).astype(np.float32)
    phi = rng.random(shape).astype(np.float32)
    port.rho, port.u, port.phi = (torch.from_numpy(a) for a in (rho, u, phi))
    ref.rho, ref.u, ref.phi = (jnp.asarray(a) for a in (rho, u, phi))
    for sim in (port, ref):
        for it in (7, 19):
            sim.iterations = it
            sim._write_vtk_2d()
    native.flush()
    want = {p.name: p.read_bytes() for p in sorted((ref.results_dir / "vtk2D").glob("*"))}
    got = {p.name: p.read_bytes() for p in sorted((port.results_dir / "vtk2D").glob("*"))}
    assert sorted(got) == sorted(want) and "cut_Z_000001.vti" in got
    assert b'Name="phi"' in got["cut_Z_000000.vti"]
    for name in want:
        assert got[name] == want[name], name


def test_sim_coupled_cli_runs_on_the_cpu(tmp_path):
    sim = sim_coupled.main(["1", "--device", "cpu", "--use-fused", "--final-time", "0.01",
                            "--results-dir", str(tmp_path)])
    assert sim.iterations == 18 and (sim.results_dir / "flag.finished").exists()
    assert sim.coupled_kernel == "one-kernel-AB"
    assert sim._coupled_step.plain_calls == 18 and sim._coupled_step.kernel.launches == 0
    assert sim.cnt[VTK2D].count > 0 and (sim.results_dir / "vtk2D" / "cut_Z.pvd").exists()
    assert torch.isfinite(sim.phi).all() and float(sim.phi[1, 16].max()) > 0


def test_sim_coupled_options_that_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        sim_coupled.main(["1", "--device", "cpu", "--sharded", "--results-dir", str(tmp_path)])
    # A-A with the kernels: the A-A coupled pair (B8), its plain version here
    fused = sim_coupled.main(["1", "--device", "cpu", "--streaming", "AA", "--use-fused",
                              "--final-time", "0.002", "--results-dir", str(tmp_path / "aa")])
    assert fused.iterations == 4 and fused.coupled_kernel == "one-kernel-AA"
    assert fused._coupled_step.plain_calls == 4
    assert fused._coupled_step.even.launches == fused._coupled_step.odd.launches == 0
    sim = sim_coupled.main(["1", "--device", "cpu", "--streaming", "AA", "--final-time",
                            "0.002", "--results-dir", str(tmp_path / "aa_plain")])
    assert sim.iterations == 4 and sim.coupled_kernel == "plain"
    # one semantics: the plain steps and B8's plain version agree everywhere,
    # the ADE outflow included, from a seeded g whose phi reaches it
    f0, g0 = fused.f.clone(), seeded_ade(tuple(sim.ade_domain.shape), "cpu")[0]
    for run in (fused, sim):
        run.f, run.g = f0.clone(), g0.clone()
        run._advance(2)
    assert fused.iterations == sim.iterations == 6
    for name, bound in (("f", 1e-6), ("g", 1e-6), ("phi", 2e-6)):
        d = float((getattr(fused, name) - getattr(sim, name)).abs().max())
        assert d < bound, (name, d)
    # a checkpoint saves g beside f (JAX sim/coupled.py:55-58)
    assert sim.checkpoint_arrays_extra().keys() == {"g"}
    assert sim.checkpoint_arrays_extra()["g"] is sim.g
    step = fused_coupled.make_fused_coupled_step_aa(sim.cfg, sim.domain, sim.ade_cfg,
                                                    sim.ade_domain, "cpu")
    assert step.plain_calls == 0 and step.even.launches == step.odd.launches == 0
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        CoupledSimulation(sim.cfg, sim.domain, sim.ade_cfg, sim.ade_domain, plan=object(),
                          device="cpu", results_parent=tmp_path / "plan")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sim_coupled.build(1, device="cuda", results_parent=tmp_path / "cuda")
