"""Port ``sim.make_step`` (plain PyTorch) == JAX ``sim.make_step``, step by step.

Both sides are built from one spec through ``tnl_lbm_tpu_torch.interop``
and start from the same seeded near-equilibrium state.  Per-step bounds are
the JAX kernel suite's (tests/test_fused_kernel.py:65-67): |df| < 1e-6,
|drho| < 2e-6, |du| < 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.models import D3Q27
from tnl_lbm_tpu.ops import collision as jcol
from tnl_lbm_tpu.ops import equilibrium as jeq
from tnl_lbm_tpu.sim import Domain as JDomain
from tnl_lbm_tpu.sim import LBMConfig as JConfig
from tnl_lbm_tpu.sim import initial_dfs as j_initial_dfs
from tnl_lbm_tpu.sim import make_step as j_make_step
from tnl_lbm_tpu.sim import obstacles as jobs
from tnl_lbm_tpu.utils import Lattice as JLattice
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim import initial_dfs, make_step
from tnl_lbm_tpu_torch.sim import obstacles as pobs

SHAPE = (8, 16, 8)
FORCE = np.array([1e-5, 0.0, 0.0])
NU = 0.02


def geometry(kind):
    """(map, periodic): sim_2's duct (NOTHING ring, WALL planes, periodic x)
    with one interior NOTHING site, or an all-fluid torus."""
    m = np.zeros(SHAPE, np.uint8)
    if kind == "torus":
        return m, (True, True, True)
    m[:, 1] = m[:, -2] = GEO.WALL
    m[:, :, 1] = m[:, :, -2] = GEO.WALL
    m[:, 0] = m[:, -1] = GEO.NOTHING
    m[:, :, 0] = m[:, :, -1] = GEO.NOTHING
    m[5, 5, 5] = GEO.NOTHING
    return m, (True, False, False)


def spec(streaming, cid="CUM_WELL"):
    eq = "EQ_WELL" if cid == "CUM_WELL" else "EQ"
    return dict(collision_id=cid, eq=eq, well=cid == "CUM_WELL", streaming=streaming,
                dtype="float32")


def jax_side(s, m, periodic):
    cfg = JConfig(lat=D3Q27, collision=jcol.COLLISIONS_D3Q27[s["collision_id"]],
                  eq=jeq.EQUILIBRIA[s["eq"]], well=s["well"], streaming=s["streaming"],
                  compute_dtype=jnp.float32)
    dom = JDomain(lat=D3Q27, units=JLattice(m.shape, (0, 0, 0), 1.0, 1.0), map=m.copy(),
                  periodic=periodic)
    return cfg, dom


def rand_f(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    rho = jnp.asarray(1 + 0.01 * rng.standard_normal(SHAPE), jnp.float32)
    u = jnp.asarray(0.02 * rng.standard_normal((3,) + SHAPE), jnp.float32)
    return np.asarray(jcfg.eq(D3Q27, rho, u).astype(jnp.float32))


def run_both(streaming, kind, n_steps, cid="CUM_WELL"):
    m, periodic = geometry(kind)
    s = spec(streaming, cid)
    jcfg, jdom = jax_side(s, m, periodic)
    cfg = interop.config_from_spec(**s)
    dom = interop.domain_from_numpy(m, periodic)
    jstep, pstep = j_make_step(jcfg, jdom), make_step(cfg, dom)
    f0 = rand_f(jcfg, seed=5)
    fj, fp = jnp.asarray(f0), interop.state_from_numpy(f0, "cpu")
    for it in range(n_steps):
        parity = it % 2 if streaming == "AA" else 0
        fj, rj, uj = jstep(fj, NU, force=jnp.asarray(FORCE, jnp.float32), parity=parity)
        fp, rp, up = pstep(fp, NU, force=FORCE, parity=parity)
        assert np.abs(np.asarray(fj) - interop.state_to_numpy(fp)).max() < 1e-6, f"f, step {it}"
        assert np.abs(np.asarray(rj) - rp.numpy()).max() < 2e-6, f"rho, step {it}"
        assert np.abs(np.asarray(uj) - up.numpy()).max() < 1e-6, f"u, step {it}"
    return fj, fp


@pytest.mark.parametrize("kind", ["duct", "torus"])
@pytest.mark.parametrize("streaming,n_steps", [("AA", 4), ("AB", 2)])
def test_make_step_matches_jax(streaming, n_steps, kind):
    fj, fp = run_both(streaming, kind, n_steps)
    # the state moved: the steps did work (not a comparison of two no-ops)
    assert np.abs(interop.state_to_numpy(fp) - rand_f(jax_side(spec(streaming), *geometry(kind))[0], 5)).max() > 1e-5


def test_make_step_cum_not_well_matches_jax():
    run_both("AA", "duct", 2, cid="CUM")


def test_initial_dfs_matches_jax():
    m, periodic = geometry("duct")
    s = spec("AA")
    jcfg, jdom = jax_side(s, m, periodic)
    f_j = np.asarray(j_initial_dfs(jcfg, jdom, rho0=1.01, u0=[0.01, 0.0, -0.02]))
    f_p = initial_dfs(interop.config_from_spec(**s), interop.domain_from_numpy(m, periodic),
                      "cpu", rho0=1.01, u0=[0.01, 0.0, -0.02])
    assert f_p.is_contiguous() and f_p.dtype == torch.float32
    assert np.abs(f_j - f_p.numpy()).max() < 1e-7


@pytest.mark.parametrize("code", [GEO.INFLOW, GEO.OUTFLOW_EQ, GEO.SYM_TOP, GEO.PERIODIC])
def test_unported_codes_raise(code):
    """The plain step and the A-A even/odd kernels (B2, B3) take the A-A
    codes; the pair (B1) still refuses everything beyond FLUID/WALL/NOTHING."""
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair2_aa, make_fused_step_aa

    m, periodic = geometry("duct")
    m[3, 3, 3] = int(code)
    cfg, dom = interop.config_from_spec(**spec("AA")), interop.domain_from_numpy(m, periodic)
    make_step(cfg, dom)
    assert code in make_fused_step_aa(cfg, dom, "cpu").codes
    with pytest.raises(NotImplementedError, match="ROADMAP B1"):
        make_fused_pair2_aa(cfg, dom, "cpu")


def test_unported_collision_and_config_raise():
    # every id of the JAX registries is ported; an id outside them raises
    with pytest.raises(NotImplementedError):
        interop.config_from_spec("KBC_N5", "EQ", False, "AB")
    with pytest.raises(NotImplementedError):
        interop.config_from_spec("SRT", "EQ_SHIFTED", False, "AB")
    with pytest.raises(ValueError):
        interop.config_from_spec("CUM", "EQ", False, "XY")


def test_obstacles_match_jax():
    units_args = ((12, 10, 8), (0.0, 0.0, 0.0), 0.1)
    jd = JDomain(lat=D3Q27, units=JLattice(*units_args), map=np.zeros((12, 10, 8), np.uint8))
    pd = interop.domain_from_numpy(np.zeros((12, 10, 8), np.uint8), (False,) * 3,
                                   phys_dl=0.1)
    for mod, d in ((jobs, jd), (pobs, pd)):
        mod.draw_sphere(d, (0.5, 0.4, 0.3), 0.25)
        mod.draw_cylinder_x(d, 0.2, 0.2, 0.1, GEO.NOTHING)
        mod.draw_cubi(d, (0.8, 0.5, 0.4), 0.2)
        mod.set_boundary_x(d, 0, GEO.WALL)
        mod.set_boundary_z(d, 7, GEO.NOTHING)
    np.testing.assert_array_equal(jd.map, pd.map)
