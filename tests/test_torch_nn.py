"""The forcing-hook slice of the port on the CPU, held against the JAX package.

The non-Newtonian hook (Carreau-Yasuda, Casson; its periodicity equal to
the domain's and not; 2D and 3D), the plain step's hook and u* pass, the
plain versions of the NN force kernel (B9), the one-kernel NN step (B10)
and the force_field / macro_only variants of B4, B2/B3 and B5, the routing
of ``make_hooked_fused_step``, ``Simulation`` and ``CoupledSimulation``
with a hook, and the blunted Carreau-Yasuda channel profile, from the same
seeded inputs.  Per-step bounds are the JAX suite's
(tests/test_fused_nn_step.py:41-43, tests/test_fused_kernel.py:65-67):
|df| < 1e-6, |drho| < 2e-6, |du| < 1e-6; the force F within 1e-6 of its
largest magnitude.  The JAX Pallas kernels run once each in interpret mode,
at 8x16x8, as the JAX suite runs them on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.kernels import fused_nn_step as j_fused_nn_step
from tnl_lbm_tpu.kernels.fused_nn import make_nn_force_kernel as j_make_nn_force_kernel
from tnl_lbm_tpu.models import D2Q9 as JD2Q9
from tnl_lbm_tpu.models import D3Q27 as JD3Q27
from tnl_lbm_tpu.ops import non_newtonian as jnn
from tnl_lbm_tpu.sim import make_step as j_make_step
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.kernels import fused_nn_step
from tnl_lbm_tpu_torch.kernels.fused import make_fused_step
from tnl_lbm_tpu_torch.kernels.fused_2d import make_fused_step_2d
from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa
from tnl_lbm_tpu_torch.kernels.fused_nn import make_nn_force_kernel
from tnl_lbm_tpu_torch.kernels.fused_nn_step import make_fused_nn_step
from tnl_lbm_tpu_torch.kernels.hooked import make_hooked_fused_step
from tnl_lbm_tpu_torch.models import D2Q9, D3Q27
from tnl_lbm_tpu_torch.ops import non_newtonian as pnn
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim import make_step
from tnl_lbm_tpu_torch.sim.state import Simulation

from test_torch_2d import both_sides
from test_torch_step import jax_side
from torch_cases import (
    BLUNT_FORCE,
    BLUNT_JAX,
    BLUNT_MODEL,
    BLUNT_NU,
    BLUNT_STEPS,
    NN_KINDS,
    NN_MODELS,
    U_IN,
    aa_box,
    bc_box,
    blunt_channel,
    nn_case,
    nn_state,
    shape_factor,
)

NU = 0.02
FORCE = (1e-5, 0.0, 0.0)
TOL_F, TOL_RHO, TOL_U = 1e-6, 2e-6, 1e-6
SPECS = {"CUM_WELL": ("CUM_WELL", "EQ_WELL", True), "CUM": ("CUM", "EQ_INV_CUM", False)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the lattices are small, and beside the
    other test workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def j_model(name):
    """The JAX package's rheology of the same constants as ``NN_MODELS[name]``."""
    m = NN_MODELS[name]
    if isinstance(m, pnn.CarreauYasuda):
        return jnn.CarreauYasuda(nu0=m.nu0, lam=m.lam, a=m.a, n=m.n)
    return jnn.Casson(k0=m.k0, k1=m.k1)


def hooked_pair(kind, streaming, hook_periodic="case", spec="CUM_WELL", model=None,
                shape=None):
    """(JAX cfg, JAX domain, port cfg, port domain, model name, hook
    periodicity) of an ``nn_case`` geometry with the NN hook on both sides."""
    m, periodic, case_model, case_per = nn_case(kind, shape)
    model = model or case_model
    per = case_per if hook_periodic == "case" else hook_periodic
    cid, eq, well = SPECS[spec]
    s = dict(collision_id=cid, eq=eq, well=well, streaming=streaming, dtype="float32")
    jcfg, jdom = jax_side(s, m, periodic)
    jcfg = dataclasses.replace(jcfg, forcing_hook=jnn.make_nn_forcing_hook(j_model(model),
                                                                           periodic=per))
    cfg = dataclasses.replace(interop.config_from_spec(**s), forcing_hook=pnn.make_nn_forcing_hook(
        NN_MODELS[model], periodic=per))
    return jcfg, jdom, cfg, interop.domain_from_numpy(m, periodic), model, per


def seeded_f(jcfg, shape, seed=5):
    rho, u = nn_state(shape, seed)
    return np.array(jcfg.eq(JD3Q27, jnp.asarray(rho), jnp.asarray(u)).astype(jnp.float32))


def diff(j, p) -> float:
    return float(np.abs(np.asarray(j, np.float64) - p.double().numpy()).max())


def assert_step(j, p, what):
    d = (diff(j[0], p[0]), diff(j[1], p[1]), diff(j[2], p[2]))
    assert d[0] < TOL_F and d[1] < TOL_RHO and d[2] < TOL_U, f"{what}: {d}"


# ------------------------------------------------------------------ the hook

@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("per_kind", ["domain", "other"])
@pytest.mark.parametrize("model", ["cy", "casson"])
def test_nn_hook_matches_jax(model, per_kind, D):
    """make_nn_forcing_hook on seeded rho, u and a fluid mask with walls:
    the hook wrapped as the domain and not (None: edge replication)."""
    shape = (8, 16, 8) if D == 3 else (12, 16)
    m = np.zeros(shape, np.uint8)
    m[:, 0] = m[:, -1] = GEO.WALL
    m[3:5, 6:8] = GEO.WALL
    dom_per = (True,) + (False,) * (D - 1)
    per = dom_per if per_kind == "domain" else None
    rho, u = nn_state(shape, seed=7)
    fluid = m == GEO.FLUID
    lat, jlat = (D3Q27, JD3Q27) if D == 3 else (D2Q9, JD2Q9)
    fj = jnn.make_nn_forcing_hook(j_model(model), periodic=per)(
        jlat, jnp.asarray(rho), jnp.asarray(u), NU, jnp.asarray(fluid))
    hook = pnn.make_nn_forcing_hook(NN_MODELS[model], periodic=per)
    fp = hook(lat, torch.from_numpy(rho), torch.from_numpy(u), NU, torch.from_numpy(fluid))
    scale = float(np.abs(np.asarray(fj)).max())
    assert scale > 0 and diff(fj, fp) <= TOL_F * scale
    assert hook.nn_model is NN_MODELS[model] and hook.nn_periodic == per


def test_viscosity_models_match_jax():
    gamma = np.array([0.0, 1e-24, 1e-6, 0.09, 3.0], np.float32)
    for name in ("cy", "casson", "cy_obstacle"):
        got = NN_MODELS[name](NU, torch.from_numpy(gamma)).numpy()
        want = np.asarray(j_model(name)(NU, jnp.asarray(gamma)))
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


# ------------------------------------------------------- the plain step's hook

@pytest.mark.parametrize("streaming", ["AB", "AA"])
@pytest.mark.parametrize("kind", NN_KINDS)
def test_hooked_plain_step_matches_jax(kind, streaming):
    """The plain hooked step against the JAX XLA hooked step, 4 chained
    steps (A-A: parities 0, 1, 0, 1), and the u* pass of the final state."""
    jcfg, jdom, cfg, dom, _, _ = hooked_pair(kind, streaming)
    jstep, pstep = j_make_step(jcfg, jdom), make_step(cfg, dom)
    f0 = seeded_f(jcfg, dom.shape)
    fj, fp = jnp.asarray(f0), torch.from_numpy(f0.copy())
    for it in range(4):
        parity = it % 2 if streaming == "AA" else 0
        j = jstep(fj, NU, force=jnp.asarray(FORCE, jnp.float32), parity=parity)
        p = pstep(fp, NU, force=FORCE, parity=parity)
        assert_step(j, p, f"{kind} {streaming} step {it}")
        fj, fp = j[0], p[0]
    for parity in ((0,) if streaming == "AB" else (0, 1)):
        rj, uj, mj = jstep.ustar(fj, force=jnp.asarray(FORCE, jnp.float32), parity=parity)
        rp, up, mp = pstep.ustar(fp, force=FORCE, parity=parity)
        assert diff(rj, rp) < TOL_RHO and diff(uj, up) < TOL_U
        assert np.array_equal(np.asarray(mj), mp.numpy())


@pytest.mark.parametrize("case", ["AB", "AA0", "AA1"])
def test_ustar_matches_jax_on_every_code(case):
    """make_step(...).ustar on a box of every code of the pattern
    (A-B: bc_box; A-A: aa_box), with the homogeneous force."""
    streaming, parity = case[:2], int(case[2:] or 0)
    m = (bc_box if streaming == "AB" else aa_box)((12, 10, 14))
    s = dict(collision_id="CUM_WELL", eq="EQ_WELL", well=True, streaming=streaming,
             dtype="float32")
    jcfg, jdom = jax_side(s, m, (False, False, True))
    dom = interop.domain_from_numpy(m, (False, False, True))
    f0 = seeded_f(jcfg, dom.shape, seed=8)
    rj, uj, mj = j_make_step(jcfg, jdom).ustar(jnp.asarray(f0), force=jnp.asarray(FORCE),
                                               parity=parity)
    rp, up, mp = make_step(interop.config_from_spec(**s), dom).ustar(
        torch.from_numpy(f0.copy()), force=FORCE, parity=parity)
    assert diff(rj, rp) < TOL_RHO and diff(uj, up) < TOL_U
    assert np.array_equal(np.asarray(mj), mp.numpy())


# ------------------------------------------------------ the kernels' plain versions

@pytest.mark.parametrize("kind", NN_KINDS)
def test_b9_plain_matches_jax_hook(kind):
    """B9's plain version (its wrapper on CPU tensors) against the JAX
    hook with the mask map == FLUID, CY and Casson, the hook wrapped as the
    domain and not."""
    m, periodic, _, _ = nn_case(kind)
    dom = interop.domain_from_numpy(m, periodic)
    rho, u = nn_state(dom.shape, seed=3)
    fluid = jnp.asarray(m == GEO.FLUID)
    for model in ("cy", "casson"):
        for per in (periodic, None if any(periodic) else (True, True, False)):
            b9 = make_nn_force_kernel(NN_MODELS[model], dom, "cpu", periodic=per)
            fp = b9(torch.from_numpy(rho), torch.from_numpy(u), NU)
            fj = jnn.make_nn_forcing_hook(j_model(model), periodic=per)(
                JD3Q27, jnp.asarray(rho), jnp.asarray(u), NU, fluid)
            scale = float(np.abs(np.asarray(fj)).max())
            assert scale > 0 and diff(fj, fp) <= TOL_F * scale, (model, per)
            assert b9.plain_calls == 1 and b9.kernel.launches == 0


@pytest.mark.parametrize("streaming", ["AB", "AA"])
@pytest.mark.parametrize("kind", NN_KINDS)
def test_b10_plain_matches_jax_xla(kind, streaming):
    """B10's plain version (its wrapper on CPU tensors) against the JAX XLA
    hooked step, 4 chained steps; on the duct also with the hook wrapping
    z where the domain does not."""
    pers = ("case",) + (((True, False, True),) if kind == "duct" else ())
    for per in pers:
        jcfg, jdom, cfg, dom, model, hook_per = hooked_pair(kind, streaming, per)
        assert fused_nn_step.supports(cfg, dom, hook_per)
        step = make_fused_nn_step(cfg, dom, NN_MODELS[model], hook_per, "cpu")
        jstep = j_make_step(jcfg, jdom)
        f0 = seeded_f(jcfg, dom.shape)
        fj, fp = jnp.asarray(f0), torch.from_numpy(f0.copy())
        for it in range(4):
            parity = it % 2 if streaming == "AA" else 0
            j = jstep(fj, NU, force=jnp.asarray(FORCE, jnp.float32), parity=parity)
            p = step(fp, NU, force=FORCE, parity=parity)
            assert_step(j, p, f"{kind} {streaming} {hook_per} step {it}")
            assert p[0] is not fp  # out of place in every mode
            fj, fp = j[0], p[0]
        assert step.plain_calls == 4
        assert step.ab.launches == step.even.launches == step.odd.launches == 0


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("case", ["AB", "AA0", "AA1"])
def test_variants_plain_match_jax_xla(case, spec):
    """The force_field variants (a seeded per-site force plus a homogeneous
    one) against the JAX XLA step with their sum as its force field, and the
    macro_only variants against the JAX u* pass, on a box of every code of
    the pattern and on the wall duct."""
    streaming, parity = case[:2], int(case[2:] or 0)
    cid, eq, well = SPECS[spec]
    s = dict(collision_id=cid, eq=eq, well=well, streaming=streaming, dtype="float32")
    box = (bc_box if streaming == "AB" else aa_box)((12, 10, 14))
    for m, periodic, u_in in ((box, (False, False, True), U_IN),
                              nn_case("duct")[:2] + (None,)):
        jcfg, jdom = jax_side(s, m, periodic)
        dom = interop.domain_from_numpy(m, periodic)
        cfg = interop.config_from_spec(**s)
        f0 = seeded_f(jcfg, dom.shape, seed=11)
        rng = np.random.default_rng(12)
        field = (1e-5 * rng.standard_normal((3,) + dom.shape)).astype(np.float32)
        total = (np.asarray(FORCE, np.float32).reshape(3, 1, 1, 1) + field).astype(np.float32)
        jstep = j_make_step(jcfg, jdom)
        jkw = dict(u_in=None if u_in is None else jnp.asarray(u_in, jnp.float32), parity=parity)
        build = make_fused_step if streaming == "AB" else make_fused_step_aa
        ff = build(cfg, dom, "cpu", force_field=True)
        j = jstep(jnp.asarray(f0), NU, force=jnp.asarray(total), **jkw)
        p = ff(torch.from_numpy(f0.copy()), NU, u_in=u_in, force=torch.from_numpy(field),
               force_add=FORCE, parity=parity)
        assert_step(j, p, f"{case} {spec} force_field")
        macro = build(cfg, dom, "cpu", macro_only=True)
        rj, uj, _ = jstep.ustar(jnp.asarray(f0), force=jnp.asarray(FORCE, jnp.float32),
                                parity=parity)
        rp, up = macro(torch.from_numpy(f0.copy()), NU, force=FORCE, parity=parity)
        assert diff(rj, rp) < TOL_RHO and diff(uj, up) < TOL_U, f"{case} {spec} macro_only"


@pytest.mark.parametrize("collision", ["SRT", "CLBM"])
@pytest.mark.parametrize("kind", ["channel", "bouzidi", "periodic"])
def test_b5_force_field_plain_matches_jax_xla(kind, collision):
    """B5's force_field variant against the JAX D2Q9 XLA step with the sum
    of the per-site and the homogeneous force, 4 chained steps."""
    jcfg, jdom, cfg, dom = both_sides(kind, collision)
    step = make_fused_step_2d(cfg, dom, "cpu", force_field=True)
    rng = np.random.default_rng(21)
    field = (1e-5 * rng.standard_normal((2,) + dom.shape)).astype(np.float32)
    fadd = np.asarray((2e-6, -1e-6), np.float32)
    total = (fadd.reshape(2, 1, 1) + field).astype(np.float32)
    u_in = None if kind == "periodic" else np.asarray((0.03, 0.0), np.float32)
    rng2 = np.random.default_rng(41)
    rho = jnp.asarray((1 + 0.01 * rng2.standard_normal(dom.shape)).astype(np.float32))
    u = jnp.asarray((0.02 * rng2.standard_normal((2,) + dom.shape)).astype(np.float32))
    f0 = np.asarray(jcfg.eq(JD2Q9, rho, u).astype(jnp.float32))
    jstep = j_make_step(jcfg, jdom)
    fj, fp = jnp.asarray(f0), torch.from_numpy(f0.copy())
    for it in range(4):
        j = jstep(fj, NU, u_in=None if u_in is None else jnp.asarray(u_in),
                  force=jnp.asarray(total))
        p = step(fp, NU, u_in=u_in, force=torch.from_numpy(field), force_add=fadd)
        assert_step(j, p, f"{kind} {collision} step {it}")
        fj, fp = j[0], p[0]
    assert step.plain_calls == 4 and step.kernel.name == "d2q9_step_force_field"


def test_jax_pallas_nn_kernels_in_interpret_mode():
    """One interpret-mode call each of the JAX NN force kernel and the JAX
    one-kernel NN step (A-B) at 8x16x8 on the wall duct (as
    tests/test_non_newtonian.py:117 and tests/test_fused_nn_step.py:52 run
    them), against B9's and B10's plain versions."""
    jcfg, jdom, cfg, dom, model, per = hooked_pair("duct", "AB", shape=(8, 16, 8))
    rho, u = nn_state(dom.shape, seed=9)
    fj = j_make_nn_force_kernel(j_model(model), jdom, jnp.float32, np.asarray(jdom.map) == 0,
                                periodic=per)(jnp.asarray(rho), jnp.asarray(u), NU)
    fp = make_nn_force_kernel(NN_MODELS[model], dom, "cpu", periodic=per)(
        torch.from_numpy(rho), torch.from_numpy(u), NU)
    assert diff(fj, fp) <= TOL_F * float(np.abs(np.asarray(fj)).max())
    f0 = seeded_f(jcfg, dom.shape, seed=10)
    j = j_fused_nn_step.make_fused_nn_step(jcfg, jdom, j_model(model), per)(
        jnp.asarray(f0), NU, force=jnp.asarray(FORCE, jnp.float32))
    p = make_fused_nn_step(cfg, dom, NN_MODELS[model], per, "cpu")(torch.from_numpy(f0), NU,
                                                                   force=FORCE)
    assert_step(j, p, "the JAX B10 in interpret mode vs the port's plain B10")


# ------------------------------------------------------------------ routing

def j_routes_single(jcfg, jdom, single_kernel=True) -> bool:
    """The JAX rule for the one-kernel route (kernels/hooked.py:66-73,
    149-151, with a homogeneous force and the hook's kernel on)."""
    hook = jcfg.forcing_hook
    return bool(single_kernel and jcfg.lat.D == 3
                and getattr(hook, "nn_model", None) is not None
                and j_fused_nn_step.supports(jcfg, jdom, hook.nn_periodic))


@pytest.mark.parametrize("streaming", ["AB", "AA"])
def test_hooked_route_matches_jax_rule(streaming):
    """make_hooked_fused_step takes B10 exactly where the JAX function does:
    across the hook's periodicity against the domain's, the codes (an
    OUTFLOW_RIGHT site; A-B also OUTFLOW_RIGHT_INTERP), the pinning flag
    and an IBM-style hook without the NN markers; else the pipeline, which
    B9 joins for an NN hook.  Under a plan that leaves z uncut
    make_sharded_hooked_fused_step takes B10 halo by the same rule (JAX
    hooked.py:317-323), B9 halo joining its pipeline; a z cut raises
    naming A13b."""
    from tnl_lbm_tpu_torch.kernels.hooked import make_sharded_hooked_fused_step

    from test_torch_sharded import cpu_plan

    plan = cpu_plan((2, 1, 1))
    plain_hook = lambda lat, rho, u, nu, fluid: torch.zeros_like(u)  # noqa: E731
    jplain_hook = lambda lat, rho, u, nu, fluid: jnp.zeros_like(u)  # noqa: E731
    seen = set()
    for kind in NN_KINDS:
        for per in ("case", None, (True, False, False), (True, True, True), (False, True, False)):
            for extra_code in (None, GEO.OUTFLOW_RIGHT, GEO.OUTFLOW_RIGHT_INTERP):
                if streaming == "AA" and extra_code == GEO.OUTFLOW_RIGHT_INTERP:
                    continue
                jcfg, jdom, cfg, dom, _, _ = hooked_pair(kind, streaming, per)
                if extra_code is not None:
                    jdom.map[-1, 5, 5] = dom.map[-1, 5, 5] = extra_code
                for flags in ({}, {"single_kernel": False}):
                    want = j_routes_single(jcfg, jdom, **flags)
                    step = make_hooked_fused_step(cfg, dom, "cpu", **flags)
                    assert (step.route == "single_kernel") == want, (kind, per, extra_code, flags)
                    assert step.nn_force is not None
                    sharded = make_sharded_hooked_fused_step(cfg, dom, plan, **flags)
                    assert sharded.route == step.route and sharded.nn_force is not None
                    seen.add(want)
    assert seen == {True, False}
    jcfg, jdom, cfg, dom, _, _ = hooked_pair("duct", streaming)
    jcfg = dataclasses.replace(jcfg, forcing_hook=jplain_hook)
    cfg = dataclasses.replace(cfg, forcing_hook=plain_hook)
    step = make_hooked_fused_step(cfg, dom, "cpu")
    assert not j_routes_single(jcfg, jdom) and step.route == "pipeline" and step.nn_force is None
    sharded = make_sharded_hooked_fused_step(cfg, dom, plan)
    assert sharded.route == "pipeline" and sharded.nn_force is None
    _, _, cfg, dom, _, _ = hooked_pair("duct", streaming)
    with pytest.raises(NotImplementedError, match="A13b"):
        make_sharded_hooked_fused_step(cfg, dom, cpu_plan((1, 1, 2)))


def test_per_site_force_takes_the_pipeline_and_b10_refuses_it():
    jcfg, jdom, cfg, dom, model, per = hooked_pair("duct", "AB")
    step = make_hooked_fused_step(cfg, dom, "cpu")
    assert step.route == "single_kernel"
    f0 = seeded_f(jcfg, dom.shape)
    field = np.full((3,) + dom.shape, 1e-5, np.float32)
    p = step(torch.from_numpy(f0), NU, force=torch.from_numpy(field))
    assert step.nn_single.plain_calls == 0 and step.base.plain_calls == 1
    j = j_make_step(jcfg, jdom)(jnp.asarray(f0), NU, force=jnp.asarray(field))
    assert_step(j, p, "per-site body force through the pipeline")
    with pytest.raises(NotImplementedError, match="per-site force"):
        step.nn_single(torch.from_numpy(f0), NU, force=field)
    with pytest.raises(NotImplementedError, match="hooked pipeline"):
        make_fused_nn_step(cfg, interop.domain_from_numpy(np.asarray(dom.map), (False,) * 3),
                           NN_MODELS[model], per, "cpu")


@pytest.mark.parametrize("case", ["AB", "AA", "2D"])
def test_hooked_step_on_cuda_without_a_card_raises(case):
    """A hooked step for device="cuda" on a box without a card raises, as
    the kernels' config check does; it never builds a plain step in the
    kernels' place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal")
    if case == "2D":
        _, _, cfg, dom = both_sides("channel", "CLBM")
        cfg = dataclasses.replace(cfg, forcing_hook=pnn.make_nn_forcing_hook(
            NN_MODELS["cy"], periodic=dom.periodic))
    else:
        _, _, cfg, dom, _, _ = hooked_pair("duct", case)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_hooked_fused_step(cfg, dom, "cuda")
    with pytest.raises(NotImplementedError, match="make_hooked_fused_step"):
        (make_fused_step_2d if case == "2D" else make_fused_step if case == "AB"
         else make_fused_step_aa)(cfg, dom, "cpu")


# ---------------------------------------------------------- Simulation

class Duct(Simulation):
    def body_force(self, phys_time):
        return np.array(FORCE)


@pytest.mark.parametrize("single", [True, False], ids=["one_kernel", "pipeline"])
@pytest.mark.parametrize("streaming", ["AB", "AA"])
def test_hooked_simulation_matches_jax(tmp_path, streaming, single):
    """Simulation(device="cpu", use_fused=True) with the NN hook, 4 steps,
    against the JAX hooked step chained from the same initial state, step
    by step; the route's wrappers ran (their plain versions, on the CPU)."""
    jcfg, jdom, cfg, dom, _, _ = hooked_pair("duct", streaming,
                                             "case" if single else None)
    dom = interop.domain_from_numpy(np.asarray(dom.map), dom.periodic, phys_viscosity=NU)
    sim = Duct(cfg, dom, device="cpu", results_parent=tmp_path, use_fused=True,
               phys_final_time=4 * dom.units.phys_dt)
    sim.sample_phases_at_finish = False
    sim.sim_init()
    assert sim._step.route == ("single_kernel" if single else "pipeline")
    jstep = j_make_step(jcfg, jdom)
    fj = jnp.asarray(sim.f.numpy())
    for it in range(4):
        parity = it % 2 if streaming == "AA" else 0
        fj, rj, uj = jstep(fj, NU, force=jnp.asarray(FORCE, jnp.float32), parity=parity)
        sim._advance(1)
        assert_step((fj, rj, uj), (sim.f, sim.rho, sim.u), f"{streaming} step {it}")
    assert sim._step.plain_calls == (4 if single else 12)
    phases = sim.sample_phase_timers(repeats=1)
    assert set(phases) == ({"single_kernel"} if single else {"ustar", "hook", "main_kernel"})


def test_blunted_profile_on_the_plain_step():
    """Shear thinning blunts the channel profile (JAX
    tests/test_non_newtonian.py:42-78, CUM_WELL float32, the hook wrapped
    as the domain): the port's plain step gives the JAX XLA step's shape
    factors within 1e-3 (BLUNT_JAX, measured there), the CY one more than
    0.01 below the Newtonian one."""
    m, periodic = blunt_channel()
    dom = interop.domain_from_numpy(m, periodic)
    base = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AB")
    hook = pnn.make_nn_forcing_hook(BLUNT_MODEL, periodic=periodic)
    factors = {}
    for label, cfg in (("newtonian", base),
                       ("carreau_yasuda", dataclasses.replace(base, forcing_hook=hook))):
        step = make_step(cfg, dom)
        f = interop.state_from_numpy(
            cfg.eq(cfg.lat, torch.ones(dom.shape), torch.zeros((3,) + dom.shape)).numpy(), "cpu")
        for _ in range(BLUNT_STEPS + 1):
            f, rho, u = step(f, BLUNT_NU, force=BLUNT_FORCE)
        factors[label] = shape_factor(u[0, 0, 0].numpy())
        assert abs(factors[label] - BLUNT_JAX[label]) < 1e-3, (label, factors[label])
    assert factors["carreau_yasuda"] < factors["newtonian"] - 0.01, factors


def test_coupled_simulation_runs_a_hook_through_two_kernels(tmp_path):
    """CoupledSimulation with the NN hook: the hooked A-B step then the ADE
    step ("two-kernel"), equal to the plain coupled run; a hook under A-A
    raises."""
    from tnl_lbm_tpu_torch.apps import sim_coupled

    runs = {}
    for fused in (True, False):
        sim = sim_coupled.build(1, device="cpu", use_fused=fused,
                                results_parent=tmp_path / str(fused))
        sim.cfg = dataclasses.replace(sim.cfg, forcing_hook=pnn.make_nn_forcing_hook(
            NN_MODELS["cy"], periodic=sim.domain.periodic))
        sim.phys_final_time = 3 * sim.domain.units.phys_dt
        sim.steps_per_dispatch = 1
        sim.sample_phases_at_finish = False
        assert sim.run()
        runs[fused] = sim
    k, p = runs[True], runs[False]
    assert k.coupled_kernel == "two-kernel" and p.coupled_kernel == "plain"
    assert k._ade_step.plain_calls == 3 and k._step.plain_calls >= 3
    for a, b in ((k.rho, p.rho), (k.u, p.u), (k.phi, p.phi)):
        assert float((a - b).abs().max()) < 1e-5
    sim = sim_coupled.build(1, device="cpu", use_fused=True, streaming="AA",
                            results_parent=tmp_path / "aa")
    sim.cfg = dataclasses.replace(sim.cfg, forcing_hook=pnn.make_nn_forcing_hook(NN_MODELS["cy"]))
    with pytest.raises(NotImplementedError, match="A-A"):
        sim.sim_init()
