"""Port ops (``tnl_lbm_tpu_torch.ops``) == JAX ops on the same seeded inputs.

Inputs are numpy arrays made from a seed and handed to both packages; the
JAX side gets explicit float32 (the suite runs with x64 enabled).  Bound:
1e-6 absolute in float32 - both sides do the same float32 arithmetic, in
orders that differ only where XLA reorders a sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.kernels import fused as jfused
from tnl_lbm_tpu.models import D3Q27
from tnl_lbm_tpu.ops import boundary as jbc
from tnl_lbm_tpu.ops import collision as jcol
from tnl_lbm_tpu.ops import contract as jcontract
from tnl_lbm_tpu.ops import equilibrium as jeq
from tnl_lbm_tpu.ops import moments as jmom
from tnl_lbm_tpu.ops import streaming as jstream
from tnl_lbm_tpu.utils import Lattice as JLattice
from tnl_lbm_tpu_torch.kernels import fused as pfused
from tnl_lbm_tpu_torch.ops import boundary as pbc
from tnl_lbm_tpu_torch.ops import collision as pcol
from tnl_lbm_tpu_torch.ops import contract as pcontract
from tnl_lbm_tpu_torch.ops import equilibrium as peq
from tnl_lbm_tpu_torch.ops import moments as pmom
from tnl_lbm_tpu_torch.ops import streaming as pstream
from tnl_lbm_tpu_torch.utils import Lattice as PLattice

SHAPE = (4, 6, 5)
TOL = 1e-6


def macro(seed=0):
    rng = np.random.default_rng(seed)
    rho = (1 + 0.01 * rng.standard_normal(SHAPE)).astype(np.float32)
    u = (0.02 * rng.standard_normal((3,) + SHAPE)).astype(np.float32)
    return rho, u


def both(arr):
    return jnp.asarray(arr, jnp.float32), torch.from_numpy(np.array(arr, copy=True))


def close(j, p, tol=TOL):
    j = np.asarray(j)
    p = p.numpy() if torch.is_tensor(p) else np.asarray(p)
    assert j.shape == p.shape
    assert np.abs(j.astype(np.float64) - p.astype(np.float64)).max() <= tol


@pytest.mark.parametrize("name", ["EQ", "EQ_WELL"])
def test_equilibria_match_jax(name):
    rho, u = macro()
    jr, pr = both(rho)
    ju, pu = both(u)
    close(jeq.EQUILIBRIA[name](D3Q27, jr, ju), peq.EQUILIBRIA[name](D3Q27, pr, pu))


@pytest.mark.parametrize("kind", ["quad", "well"])
def test_eq_local_matches_jax(kind):
    rho, u = macro(1)
    jr, pr = both(rho)
    ju, pu = both(u)
    close(jfused._eq_local(D3Q27, jr, ju, kind), pfused._eq_local(D3Q27, pr, pu, kind))


@pytest.mark.parametrize("well,high_precision,with_force",
                         [(True, False, True), (True, True, False), (False, False, True)])
def test_density_velocity_matches_jax(well, high_precision, with_force):
    rho, u = macro(2)
    eq = jeq.eq_well if well else jeq.eq_quadratic
    f = np.asarray(eq(D3Q27, jnp.asarray(rho), jnp.asarray(u)), np.float32)
    jf, pf = both(f)
    force = np.array([1e-5, -2e-6, 3e-6], np.float32).reshape(3, 1, 1, 1)
    jF, pF = both(force) if with_force else (None, None)
    jrho, ju = jmom.density_velocity(D3Q27, jf, force=jF, well=well, high_precision=high_precision)
    prho, pu = pmom.density_velocity(D3Q27, pf, force=pF, well=well, high_precision=high_precision)
    close(jrho, prho, 2e-6)
    close(ju, pu)


def test_moments_local_matches_jax():
    rho, u = macro(3)
    f = np.asarray(jeq.eq_well(D3Q27, jnp.asarray(rho), jnp.asarray(u)), np.float32)
    jf, pf = both(f)
    force = [1e-5, 0.0, -1e-6]
    for hp in (False, True):
        jrho, ju = jfused._moments_local(D3Q27, jf, [jnp.float32(v) for v in force], True, hp)
        prho, pu = pfused._moments_local(D3Q27, pf, force, True, hp)
        close(jrho, prho, 2e-6)
        close(ju, pu)


@pytest.mark.parametrize("cid,eq,well", [("CUM", "EQ", False), ("CUM_WELL", "EQ_WELL", True)])
def test_collide_cum_matches_jax(cid, eq, well):
    rho, u = macro(4)
    rng = np.random.default_rng(14)
    f = np.asarray(jeq.EQUILIBRIA[eq](D3Q27, jnp.asarray(rho), jnp.asarray(u)), np.float32)
    f = f + (1e-4 * rng.standard_normal(f.shape)).astype(np.float32)  # off equilibrium
    jf, pf = both(f)
    jrho, ju = jmom.density_velocity(D3Q27, jf, well=well)
    prho, pu = pmom.density_velocity(D3Q27, pf, well=well)
    out_j = jcol.COLLISIONS_D3Q27[cid](D3Q27, jf, jrho, ju, 0.02)
    out_p = pcol.COLLISIONS_D3Q27[cid](D3Q27, pf, prho, pu, 0.02)
    close(out_j, out_p)
    # the relaxation moved the state: the comparison is not of two identities
    assert np.abs(np.asarray(out_j) - f).max() > 1e-6


@pytest.mark.parametrize("well", [False, True])
@pytest.mark.parametrize("geier_2017,antialias,omega2",
                         [(True, False, 1.0), (False, True, 1.0), (True, True, 1.2),
                          (False, False, 1.3)])
def test_collide_cum_options_match_jax(geier_2017, antialias, omega2, well):
    """The Geier-2017 limiters, anti-aliasing and a bulk rate omega2 != 1
    (off the main path, which runs the defaults) against the JAX operator."""
    rho, u = macro(6)
    rng = np.random.default_rng(16)
    eq = jeq.eq_well if well else jeq.eq_quadratic
    f = np.asarray(eq(D3Q27, jnp.asarray(rho), jnp.asarray(u)), np.float32)
    f = f + (1e-4 * rng.standard_normal(f.shape)).astype(np.float32)
    jf, pf = both(f)
    jrho, ju = jmom.density_velocity(D3Q27, jf, well=well)
    prho, pu = pmom.density_velocity(D3Q27, pf, well=well)
    kw = dict(geier_2017=geier_2017, antialias=antialias, omega2=omega2, well=well)
    out_j = jcol.collide_cum(D3Q27, jf, jrho, ju, 0.02, **kw)
    out_p = pcol.collide_cum(D3Q27, pf, prho, pu, 0.02, **kw)
    close(out_j, out_p)
    default = pcol.collide_cum(D3Q27, pf, prho, pu, 0.02, well=well)
    assert (out_p - default).abs().max() > 0  # the options changed the result


@pytest.mark.parametrize("well", [False, True])
def test_central_moments_round_trip_matches_jax(well):
    rho, u = macro(5)
    eq = jeq.eq_well if well else jeq.eq_quadratic
    f = np.asarray(eq(D3Q27, jnp.asarray(rho), jnp.asarray(u)), np.float32)
    jf, pf = both(f)
    ju, pu = both(u)
    kj = jcol.central_moments(D3Q27, jf, ju, well=well)
    kp = pcol.central_moments(D3Q27, pf, pu, well=well)
    for a in range(3):
        for b in range(3):
            for g in range(3):
                close(kj[a][b][g], kp[a][b][g])
    close(jcol.dfs_from_central_moments(D3Q27, kj, ju, well=well),
          pcol.dfs_from_central_moments(D3Q27, kp, pu, well=well))
    close(f, pcol.dfs_from_central_moments(D3Q27, kp, pu, well=well), 1e-6)


@pytest.mark.parametrize("periodic", [(True, False, False), (False, True, True)])
def test_streaming_matches_jax(periodic):
    rng = np.random.default_rng(6)
    f = rng.standard_normal((27,) + SHAPE).astype(np.float32)
    jf, pf = both(f)
    jp = jstream.pad_halo(jf, periodic)
    pp = pstream.pad_halo(pf, periodic)
    close(jp, pp, 0.0)
    close(jstream.pull(D3Q27, jp, SHAPE), pstream.pull(D3Q27, pp, SHAPE), 0.0)
    close(jstream.pull_from(D3Q27, jp, SHAPE, D3Q27.opp),
          pstream.pull_from(D3Q27, pp, SHAPE, D3Q27.opp), 0.0)


def test_lattice_dot_is_exact_and_matches_jax():
    rng = np.random.default_rng(7)
    arr = rng.standard_normal((27, 5)).astype(np.float32)
    jout = jcontract.lattice_dot(D3Q27.c.T, jnp.asarray(arr))
    pout = pcontract.lattice_dot(D3Q27.c.T, torch.from_numpy(arr))
    close(jout, pout, 0.0)
    assert pcontract.lattice_dot(np.zeros(27), torch.from_numpy(arr)).abs().max() == 0


def test_boundary_transforms_match_jax():
    rng = np.random.default_rng(8)
    f = rng.standard_normal((27,) + SHAPE).astype(np.float32)
    mask = rng.random(SHAPE) < 0.5
    jf, pf = both(f)
    jm, pm = jnp.asarray(mask), torch.from_numpy(mask)
    close(jbc.apply_bounce_back(D3Q27, jf, jm), pbc.apply_bounce_back(D3Q27, pf, pm), 0.0)
    for code, (axis, sign) in jbc.sym_table(3).items():
        assert pbc.sym_table(3)[pbc.GEO(int(code))] == (axis, sign)
        close(jbc.apply_symmetry(D3Q27, jf, jm, axis, sign),
              pbc.apply_symmetry(D3Q27, pf, pm, axis, sign), 0.0)
    assert {int(c) for c in pbc.collision_mask_codes(3)} == {int(c) for c in jbc.collision_mask_codes(3)}
    assert {c.name: int(c) for c in pbc.GEO} == {c.name: int(c) for c in jbc.GEO}


def test_units_match_jax():
    args = dict(global_size=(32, 64, 64), phys_origin=(0, 0, 0), phys_dl=0.25 / 62,
                phys_dt=1.1e-3, phys_viscosity=1.5e-5)
    j, p = JLattice(**args), PLattice(**args)
    assert p.lbm_viscosity() == j.lbm_viscosity()
    assert p.phys2lbm_force(1e-4) == j.phys2lbm_force(1e-4)
    assert p.lbm2phys_velocity(0.01) == j.lbm2phys_velocity(0.01)
    assert p.num_sites == j.num_sites
    np.testing.assert_array_equal(p.lbm2phys_point([1, 2, 3]), j.lbm2phys_point([1, 2, 3]))
