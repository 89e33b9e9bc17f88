"""The layout variants on the CPU, held against the JAX package: the A-A
pair with the even and odd steps' codes (B1b, ``make_fused_pair_aa``, one
launch a pair on the card) and the site-major A-B step (B4s,
``make_fused_step_sitemajor``) with its layout helpers.

On CPU tensors the wrappers run their plain versions: B1b's is the even
step's plain version then the odd step's, on the unpadded state; B4s's is
``from_sitemajor``, B4's plain step and ``to_sitemajor``.
They are held against two JAX ``make_step`` A-A steps and one A-B step, at
the JAX kernel suite's bounds per step (tests/test_fused_kernel.py:65-67):
|df| < 1e-6, |drho| < 2e-6, |du| < 1e-6; under ``-m slow`` against the JAX
Pallas kernels in interpret mode, as tests/test_fused_kernel.py:229-311 runs
them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.kernels import fused as jfused
from tnl_lbm_tpu.models import D3Q27
from tnl_lbm_tpu.ops import collision as jcol
from tnl_lbm_tpu.ops import equilibrium as jeq
from tnl_lbm_tpu.sim import Domain as JDomain
from tnl_lbm_tpu.sim import LBMConfig as JConfig
from tnl_lbm_tpu.sim import make_step as j_make_step
from tnl_lbm_tpu.utils import Lattice as JLattice
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.kernels import fused
from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair_aa
from tnl_lbm_tpu_torch.ops.boundary import GEO

from torch_cases import AB_SPECS, U_IN, aa_box, bc_box

NU, FORCE = 0.02, (1e-5, 0.0, 0.0)
BOUNDS = {"f": 1e-6, "rho": 2e-6, "u": 1e-6}


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread, beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def duct_map(shape, periodic):
    """The JAX suite's torus or duct (test_fused_kernel.py:237-241) with a
    NOTHING site."""
    m = np.zeros(shape, np.uint8)
    if not periodic[1]:
        m[:, 0] = m[:, -1] = GEO.WALL
        m[:, :, 0] = m[:, :, -1] = GEO.WALL
    m[4, 5, 6] = GEO.NOTHING
    return m


def jax_side(spec, m, periodic, streaming):
    cid, eq, well = AB_SPECS[spec]
    units = JLattice(m.shape, (0, 0, 0), 1.0, 1.0)
    return (JConfig(lat=D3Q27, collision=jcol.COLLISIONS_D3Q27[cid], eq=jeq.EQUILIBRIA[eq],
                    well=well, streaming=streaming, compute_dtype=jnp.float32),
            JDomain(lat=D3Q27, units=units, map=m.copy(), periodic=periodic))


def seeded(jcfg, shape, seed=9):
    rng = np.random.default_rng(seed)
    rho = jnp.asarray((1 + 0.01 * rng.standard_normal(shape)).astype(np.float32))
    u = jnp.asarray((0.02 * rng.standard_normal((3,) + shape)).astype(np.float32))
    return np.array(jcfg.eq(D3Q27, rho, u), np.float32)


def within(ref, got, label):
    d = {n: float(np.abs(np.asarray(a) - b.numpy()).max())
         for n, a, b in zip(("f", "rho", "u"), ref, got)}
    assert all(v < BOUNDS[k] for k, v in d.items()), (label, d)


def port_pair(spec, m, periodic, **kw):
    return make_fused_pair_aa(interop.config_from_spec(*AB_SPECS[spec], "AA"),
                              interop.domain_from_numpy(m, periodic), "cpu", **kw)


# ------------------------------------------------------------ B1b

@pytest.mark.parametrize("periodic", [(True, True, True), (True, False, False)],
                         ids=["torus", "duct"])
def test_two_kernel_pair_plain_matches_jax_steps(periodic):
    """Two pairs against four JAX A-A steps at 16^3 with a NOTHING site."""
    m = duct_map((16, 16, 16), periodic)
    jcfg, jdom = jax_side("CUM_WELL", m, periodic, "AA")
    jstep = j_make_step(jcfg, jdom)
    pair = port_pair("CUM_WELL", m, periodic)
    f0 = seeded(jcfg, m.shape)
    fj, fp = jnp.asarray(f0), torch.from_numpy(f0.copy())
    for it in range(2):
        fj, _, _ = jstep(fj, NU, force=jnp.asarray(FORCE), parity=0)
        fj, rj, uj = jstep(fj, NU, force=jnp.asarray(FORCE), parity=1)
        fp, rp, up = pair(fp, NU, force=FORCE)
        within((fj, rj, uj), (fp, rp, up), (periodic, it))
    assert pair.plain_calls == 2 and pair.kernel.launches == 0
    assert np.array_equal(fp.numpy()[:, 4, 5, 6], f0[:, 4, 5, 6])  # NOTHING keeps its DFs


@pytest.mark.parametrize("spec", sorted(AB_SPECS))
def test_two_kernel_pair_plain_matches_jax_on_every_code(spec):
    """Two pairs on the box of every A-A code per variant, with an inflow
    velocity, against two JAX A-A steps each; the pair built without rho
    and u gives the same state."""
    m, periodic = aa_box((8, 16, 12)), (False, False, True)
    jcfg, jdom = jax_side(spec, m, periodic, "AA")
    jstep = j_make_step(jcfg, jdom)
    pair = port_pair(spec, m, periodic)
    bare = port_pair(spec, m, periodic, with_macro=False)
    assert GEO.OUTFLOW_RIGHT in pair.codes and GEO.INFLOW_LEFT in pair.codes
    f0 = seeded(jcfg, m.shape)
    fj, fp = jnp.asarray(f0), torch.from_numpy(f0.copy())
    for it in range(2):
        for parity in (0, 1):
            fj, rj, uj = jstep(fj, NU, u_in=jnp.asarray(U_IN), force=jnp.asarray(FORCE),
                               parity=parity)
        f2, none_rho, none_u = bare(fp, NU, U_IN, FORCE)
        fp, rp, up = pair(fp, NU, U_IN, FORCE)
        assert torch.equal(f2, fp) and none_rho is None and none_u is None
        within((fj, rj, uj), (fp, rp, up), (spec, it))
    assert float(np.abs(fp.numpy() - f0).max()) > 1e-5


def test_two_kernel_pair_refusals():
    m, periodic = duct_map((8, 8, 8), (True, False, False)), (True, False, False)
    pair = port_pair("CUM_WELL", m, periodic, with_macro=False)
    f = torch.zeros((27, 8, 8, 8))
    assert pair(f, NU)[1:] == (None, None)
    with pytest.raises(TypeError):
        port_pair("CUM_WELL", m, periodic, tile_even=(8, 16))
    with pytest.raises(ValueError):
        pair(torch.zeros((27, 10, 10, 8)), NU)  # not the domain's [Q, X, Y, Z] state
    with pytest.raises(ValueError):
        pair(f.double(), NU)
    with pytest.raises(NotImplementedError, match="ROADMAP Bprof"):
        pair(f, NU, u_in=np.zeros((3, 8, 8, 8), np.float32))  # a per-site inflow profile
    with pytest.raises(ValueError, match="seg_len"):
        port_pair("CUM_WELL", m, periodic, seg_len=0)
    interp = bc_box((8, 10, 12))
    with pytest.raises(NotImplementedError, match="OUTFLOW_RIGHT_INTERP"):
        port_pair("CUM_WELL", interp, (False, False, True))
    with pytest.raises(ValueError, match="streaming='AA'"):
        make_fused_pair_aa(interop.config_from_spec(*AB_SPECS["CUM_WELL"], "AB"),
                           interop.domain_from_numpy(m, periodic), "cpu")


def test_full_pair_plain_matches_jax_with_outflow_right():
    """The plain pair on an inflow-outflow channel, moment inflow and
    OUTFLOW_RIGHT on the x faces, CUM with eq_inv_cum as sim_1 runs: three
    pairs against six JAX A-A steps.  The plain version has no x segments;
    the card tests hold the kernel's segments to it."""
    m = aa_box((36, 9, 10))
    m[1:-1, 3, 4] = GEO.WALL  # a wall line along x
    periodic = (False, False, True)
    jcfg, jdom = jax_side("CUM_INV_CUM", m, periodic, "AA")
    jstep = j_make_step(jcfg, jdom)
    pair = port_pair("CUM_INV_CUM", m, periodic)
    f0 = seeded(jcfg, m.shape)
    fj, fp = jnp.asarray(f0), torch.from_numpy(f0.copy())
    for it in range(3):
        for parity in (0, 1):
            fj, rj, uj = jstep(fj, NU, u_in=jnp.asarray(U_IN), force=jnp.asarray(FORCE),
                               parity=parity)
        fp, rp, up = pair(fp, NU, U_IN, FORCE)
        within((fj, rj, uj), (fp, rp, up), ("outflow channel", it))
    out = m == GEO.OUTFLOW_RIGHT
    assert out[-1].any() and float(np.abs(fp.numpy()[:, out] - f0[:, out]).max()) > 1e-5


def test_full_pair_writes_into_out_and_macro_out():
    """B1b into the caller's buffers, as pair dispatch and its CUDA graphs
    call it: the state into ``out`` (never ``f``), rho and u into
    ``macro_out``, the same values as new tensors; ``out=f`` and rho and u
    of a pair built without them are refused."""
    m, periodic = aa_box((8, 16, 12)), (False, False, True)
    jcfg, _ = jax_side("CUM_INV_CUM", m, periodic, "AA")
    pair = port_pair("CUM_INV_CUM", m, periodic)
    f = torch.from_numpy(seeded(jcfg, m.shape))
    f_before = f.clone()
    out, rho, u = torch.empty_like(f), torch.empty(m.shape), torch.empty((3,) + m.shape)
    got = pair(f, NU, U_IN, FORCE, out=out, macro_out=(rho, u))
    assert got[0] is out and got[1] is rho and got[2] is u and torch.equal(f, f_before)
    for a, b in zip(got, pair(f, NU, U_IN, FORCE)):
        assert torch.equal(a, b)
    assert pair.plain_calls == 2
    with pytest.raises(ValueError, match="second contiguous state buffer"):
        pair(f, NU, out=f)
    with pytest.raises(ValueError, match="macro_out"):
        pair(f, NU, macro_out=(rho, u[:2]))
    with pytest.raises(ValueError, match="with_macro=False"):
        port_pair("CUM_INV_CUM", m, periodic, with_macro=False)(f, NU, macro_out=(rho, u))


# ------------------------------------------------------------ B4s

def test_sitemajor_layout_equals_jax():
    """``to_sitemajor`` / ``from_sitemajor`` bit for bit against JAX's,
    the zero dummies included; the round trip is exact."""
    f = np.random.default_rng(4).standard_normal((27, 5, 6, 7)).astype(np.float32)
    fs = fused.to_sitemajor(torch.from_numpy(f))
    want = np.asarray(jfused.to_sitemajor(jnp.asarray(f)))
    assert fused.QPAD == jfused.QPAD and fs.shape == want.shape == (5, 6, 32, 7)
    assert np.array_equal(fs.numpy(), want) and not fs.numpy()[:, :, 27:].any()
    assert np.array_equal(fused.from_sitemajor(fs, 27).numpy(),
                          np.asarray(jfused.from_sitemajor(jnp.asarray(want), 27)))
    assert torch.equal(fused.from_sitemajor(fs, 27), torch.from_numpy(f))


@pytest.mark.parametrize("case", ["duct", "box_CUM_WELL", "box_CUM"])
def test_sitemajor_step_plain_matches_jax_step(case):
    """One site-major A-B step against the JAX ``make_step`` A-B step on the
    duct and on the box of every 3D code; the dummies stay zero."""
    if case == "duct":
        spec, m, periodic = "CUM_WELL", duct_map((12, 10, 8), (True, False, False)), \
            (True, False, False)
    else:
        spec, m, periodic = case[4:], bc_box((8, 10, 12)), (False, False, True)
    jcfg, jdom = jax_side(spec, m, periodic, "AB")
    f0 = seeded(jcfg, m.shape)
    fj, rj, uj = j_make_step(jcfg, jdom)(jnp.asarray(f0), NU, u_in=jnp.asarray(U_IN),
                                         force=jnp.asarray(FORCE))
    step = fused.make_fused_step_sitemajor(interop.config_from_spec(*AB_SPECS[spec], "AB"),
                                           interop.domain_from_numpy(m, periodic), "cpu")
    fs, rp, up = step(fused.to_sitemajor(torch.from_numpy(f0)), NU, u_in=U_IN, force=FORCE)
    assert not fs[:, :, 27:].any()
    within((fj, rj, uj), (fused.from_sitemajor(fs, 27), rp, up), case)
    assert step.plain_calls == 1 and step.kernel.launches == 0


def test_sitemajor_step_refusals_and_map_override():
    m, periodic = duct_map((8, 8, 8), (True, False, False)), (True, False, False)
    cfg = interop.config_from_spec(*AB_SPECS["CUM_WELL"], "AB")
    dom = interop.domain_from_numpy(m, periodic)
    for kw in ({"force_field": True}, {"macro_only": True}):
        with pytest.raises(NotImplementedError, match="B4s"):
            fused.make_fused_step_sitemajor(cfg, dom, "cpu", **kw)
    step = fused.make_fused_step_sitemajor(cfg, dom, "cpu", with_macro=False)
    f = torch.from_numpy(seeded(jax_side("CUM_WELL", m, periodic, "AB")[0], m.shape))
    fs = fused.to_sitemajor(f)
    out = step(fs, NU, force=FORCE)
    assert out[1:] == (None, None)
    with pytest.raises(ValueError):
        step(f, NU)  # the [Q, X, Y, Z] layout
    walls = m.copy()
    walls[3, 3, 3] = GEO.WALL  # a map of the domain's codes, passed per call
    a = step(fs, NU, force=FORCE, map_arr_in=walls)[0]
    b = fused.make_fused_step(cfg, interop.domain_from_numpy(walls, periodic), "cpu")(
        f, NU, force=FORCE)[0]
    assert torch.equal(fused.from_sitemajor(a, 27), b) and not torch.equal(a, out[0])


# ------------------------------------------------------------ Pallas, interpret mode

@pytest.mark.slow
@pytest.mark.parametrize("periodic", [(True, True, True), (True, False, False)],
                         ids=["torus", "duct"])
def test_two_kernel_pair_plain_matches_jax_pallas_interpret(periodic):
    from tnl_lbm_tpu.kernels.fused_aa import make_fused_pair_aa as j_make_fused_pair_aa

    m = duct_map((16, 16, 16), periodic)
    jcfg, jdom = jax_side("CUM_WELL", m, periodic, "AA")
    jpair = j_make_fused_pair_aa(jcfg, jdom, tile_even=(8, 8), k_even=2, tile_odd=(8, 8),
                                 k_odd=1)
    pair = port_pair("CUM_WELL", m, periodic)
    f0 = seeded(jcfg, m.shape)
    fj, fp = jnp.asarray(f0), torch.from_numpy(f0.copy())
    for it in range(2):
        fj, rj, uj = jpair(fj, NU, force=jnp.asarray(FORCE, jnp.float32))
        fp, rp, up = pair(fp, NU, force=FORCE)
        within((fj, rj, uj), (fp, rp, up), (periodic, it))


@pytest.mark.slow
def test_sitemajor_step_plain_matches_jax_pallas_interpret():
    m, periodic = duct_map((16, 16, 16), (True, False, False)), (True, False, False)
    jcfg, jdom = jax_side("CUM_WELL", m, periodic, "AB")
    jstep = jfused.make_fused_step_sitemajor(jcfg, jdom, tile=(8, 8))
    step = fused.make_fused_step_sitemajor(interop.config_from_spec(*AB_SPECS["CUM_WELL"], "AB"),
                                           interop.domain_from_numpy(m, periodic), "cpu")
    f0 = seeded(jcfg, m.shape)
    fsj, rj, uj = jstep(jfused.to_sitemajor(jnp.asarray(f0)), NU,
                        force=jnp.asarray(FORCE, jnp.float32))
    fs, rp, up = step(fused.to_sitemajor(torch.from_numpy(f0)), NU, force=FORCE)
    within((fsj, rj, uj), (fs, rp, up), "sitemajor")
