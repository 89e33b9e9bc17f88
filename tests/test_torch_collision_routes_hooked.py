"""The forcing-hook routes under the D3Q27 collisions beyond the cumulant
pair, held against the JAX package on the CPU.

One id of each family (SRT_MODIF_FORCE, BGK_WELL, MRT_LES, CLBM_WELL,
KBC_C4) and CUM with ``eq_entropic``: the plain versions of both hooked
routes - the one-kernel NN step (B10) and the pipeline (the u* pass, the NN
force B9, the force_field step of B4 or B2/B3) - with the Carreau-Yasuda
hook on the wall duct, and the pipeline with a per-site body force, against
the JAX ``make_step`` with the same hook, A-B and A-A (even, then odd).
Bounds: |df| <= 1e-6 (KBC 1e-5, ``torch_cases.KBC_TOL_F``), |drho| <= 2e-6,
|du| <= 1e-6.  The SRT family's forcing term reads the collision's force,
which is the body force plus the NN force in both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.ops import non_newtonian as jnn
from tnl_lbm_tpu.sim import make_step as j_make_step
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.kernels.fused import step_instance
from tnl_lbm_tpu_torch.kernels.hooked import make_hooked_fused_step
from tnl_lbm_tpu_torch.ops.non_newtonian import CarreauYasuda, make_nn_forcing_hook

from test_torch_collisions import jax_side, start, within
from torch_cases import collision_spec, nn_case

NU = 0.02
FORCE = (1e-5, -2e-6, 3e-6)
MODEL = (0.1, 1.0, 2.0, 0.5)  # Carreau-Yasuda nu0, lambda, a, n
SHAPE = (6, 10, 12)
#: one id of each family, and CUM with the entropic equilibrium
ROUTE_CASES = (("SRT_MODIF_FORCE", None), ("BGK_WELL", None), ("MRT_LES", None),
               ("CLBM_WELL", None), ("KBC_C4", None), ("CUM", "EQ_ENTROPIC"))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hooked_sides(cid, eq, streaming):
    """(JAX step, port cfg, port domain, seeded f) of the wall duct with the
    Carreau-Yasuda hook wrapped as the domain, under (cid, eq)."""
    m, periodic, _, hper = nn_case("duct", SHAPE)
    s = collision_spec(cid, streaming, eq)
    jcfg, jdom = jax_side(s, m, periodic)
    jcfg = dataclasses.replace(jcfg, forcing_hook=jnn.make_nn_forcing_hook(
        jnn.CarreauYasuda(*MODEL), periodic=hper))
    cfg = dataclasses.replace(interop.config_from_spec(**s), forcing_hook=make_nn_forcing_hook(
        CarreauYasuda(*MODEL), periodic=hper))
    dom = interop.domain_from_numpy(m, periodic)
    return j_make_step(jcfg, jdom), cfg, dom, start(jcfg, m.shape)


@pytest.mark.parametrize("streaming", ("AB", "AA"))
@pytest.mark.parametrize("cid,eq", ROUTE_CASES, ids=[c + (f"-{e}" if e else "")
                                                     for c, e in ROUTE_CASES])
def test_hooked_routes_match_jax_make_step(cid, eq, streaming):
    """Both routes from the same seeded state, a homogeneous force (A-A:
    the even step, then the odd step from its output), then the pipeline
    with a per-site body force, each against the JAX hooked step."""
    jstep, cfg, dom, f0 = hooked_sides(cid, eq, streaming)
    single = make_hooked_fused_step(cfg, dom, "cpu")
    pipeline = make_hooked_fused_step(cfg, dom, "cpu", single_kernel=False)
    assert (single.route, pipeline.route) == ("single_kernel", "pipeline")
    want = step_instance(dataclasses.replace(cfg, forcing_hook=None))
    assert single.nn_single._instance == want and pipeline.base._instance == want
    parities = (0,) if streaming == "AB" else (0, 1)
    fj = jnp.asarray(f0)
    fp = {"single": torch.from_numpy(f0.copy()), "pipeline": torch.from_numpy(f0.copy())}
    for parity in parities:
        ref = jstep(fj, NU, force=jnp.asarray(FORCE, jnp.float32), parity=parity)
        for name, step in (("single", single), ("pipeline", pipeline)):
            got = step(fp[name], NU, force=FORCE, parity=parity)
            within(ref, got, cid, f"{streaming} {name} parity {parity}")
            fp[name] = got[0]
        fj = ref[0]
    # the hook moves the step far past the bounds: a route without it would fail
    plain = jax_side(collision_spec(cid, streaming, eq), *nn_case("duct", SHAPE)[:2])
    newtonian = j_make_step(*plain)(jnp.asarray(f0), NU, force=jnp.asarray(FORCE, jnp.float32))
    hooked = jstep(jnp.asarray(f0), NU, force=jnp.asarray(FORCE, jnp.float32))
    assert float(jnp.abs(newtonian[0] - hooked[0]).max()) > 1e-4
    assert single.plain_calls == len(parities) and single.nn_single.plain_calls == len(parities)
    assert pipeline.base.plain_calls == len(parities)
    # a per-site body force: the pipeline (B10 takes a homogeneous force only)
    field = (1e-5 * np.random.default_rng(9).standard_normal((3,) + SHAPE)).astype(np.float32)
    for parity in parities:
        ref = jstep(jnp.asarray(f0), NU, force=jnp.asarray(field), parity=parity)
        got = single(torch.from_numpy(f0.copy()), NU, force=torch.from_numpy(field),
                     parity=parity)
        within(ref, got, cid, f"{streaming} per-site force parity {parity}")
    assert single.base.plain_calls == len(parities)
