"""The full-set A-A pair (B1b) and pair dispatch under the D3Q27 collisions
beyond the cumulant pair, on the CPU.

B1b's plain version (one even and one odd step of the A-A set on the
unpadded state) for one id of each family (SRT_MODIF_FORCE, BGK_WELL,
MRT_LES, CLBM_WELL, KBC_C4) and CUM with ``eq_entropic`` against two JAX A-A
steps (even, then odd) with a body force and an inflow velocity, on the box
of every A-A code: |df| <= 1e-6 (KBC 1e-5), |drho| <= 2e-6, |du| <= 1e-6
after the pair; CUM with ``eq_entropic`` through the per-step kernels' plain
versions as tests/test_torch_collisions.py holds the other collisions.  ``Simulation`` under KBC_N1 with ``pair_dispatch=True``
(B1b) against the same run per step (B2/B3), bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.sim import make_step as j_make_step
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.kernels.fused import step_instance
from tnl_lbm_tpu_torch.kernels.fused_aa import (
    FusedPairAAFull,
    dispatch_pair_kind,
    make_dispatch_pair,
    make_fused_pair_aa,
)
from tnl_lbm_tpu_torch.sim.state import Simulation

from test_torch_collision_routes_hooked import ROUTE_CASES
import test_torch_collisions
from test_torch_collisions import jax_side, start, within
from torch_cases import U_IN, aa_box, collision_spec

NU = 0.02
FORCE = (1e-5, -2e-6, 3e-6)
BOX = (8, 10, 12)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cid,eq", ROUTE_CASES, ids=[c + (f"-{e}" if e else "")
                                                     for c, e in ROUTE_CASES])
def test_full_set_pair_plain_matches_two_jax_steps(cid, eq):
    m, periodic = aa_box(BOX), (False, False, True)
    s = collision_spec(cid, "AA", eq)
    jcfg, jdom = jax_side(s, m, periodic)
    cfg, dom = interop.config_from_spec(**s), interop.domain_from_numpy(m, periodic)
    pair = make_fused_pair_aa(cfg, dom, "cpu")
    assert pair._instance == step_instance(cfg) and pair._instance[0] != "cum"
    assert dispatch_pair_kind(cfg, dom) == "B1b"
    assert isinstance(make_dispatch_pair(cfg, dom, "cpu"), FusedPairAAFull)
    f0 = start(jcfg, m.shape)
    jstep = j_make_step(jcfg, jdom)
    kw = dict(u_in=jnp.asarray(U_IN, jnp.float32), force=jnp.asarray(FORCE, jnp.float32))
    ref = jstep(jstep(jnp.asarray(f0), NU, parity=0, **kw)[0], NU, parity=1, **kw)
    got = pair(torch.from_numpy(f0.copy()), NU, u_in=U_IN, force=FORCE)
    within(ref, got, cid, "B1b pair")
    assert pair.plain_calls == 1 and pair.kernel.launches == 0
    assert float(np.abs(got[0].numpy() - f0).max()) > 1e-5


def test_cum_entropic_steps_match_jax_make_step():
    """CUM with eq_entropic through the per-step kernels' plain versions
    (its family row), as tests/test_torch_collisions.py holds every other
    case: one A-B step on the box of every 3D code, one even and one odd
    step on the box of every A-A code, against the JAX make_step."""
    assert step_instance(interop.config_from_spec("CUM", "EQ_ENTROPIC", False, "AB"))[:2] == (
        "tnl_lbm_coll_clbm", 3)
    test_torch_collisions.test_plain_kernel_steps_match_jax_make_step("CUM", "EQ_ENTROPIC", None)


class Duct(Simulation):
    def body_force(self, phys_time):
        return np.array([1e-5, -2e-6, 0.0])


def test_kbc_pair_dispatch_is_bit_identical_to_per_step(tmp_path):
    """KBC_N1 on the box of every A-A code: seven steps (three pairs through
    B1b's plain version and a leftover step) against seven per-step plain
    steps; f, rho and u equal bit for bit."""
    m, periodic = aa_box(BOX), (False, False, True)
    dom = interop.domain_from_numpy(m, periodic, phys_viscosity=NU)
    cfg = interop.config_from_spec(**collision_spec("KBC_N1", "AA"))
    sims = [Duct(cfg, dom, device="cpu", sim_id=f"kbc_{p}", results_parent=tmp_path,
                 use_fused=True, pair_dispatch=p) for p in (True, False)]
    for sim in sims:
        sim.sim_init()
        sim._advance(7)
    paired, stepped = sims
    assert paired.pair_dispatch is True and stepped.pair_dispatch is False
    assert type(paired._pair) is FusedPairAAFull and paired._pair.variant == "KBC_N1"
    assert paired.iterations == stepped.iterations == 7
    for name in ("f", "rho", "u"):
        assert torch.equal(getattr(paired, name), getattr(stepped, name)), name
    assert paired._pair.plain_calls == 3 and paired._step.plain_calls == 1
    assert stepped._pair is None and stepped._step.plain_calls == 7
