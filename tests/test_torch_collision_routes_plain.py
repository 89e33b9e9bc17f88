"""The plain versions of the kernels that take the whole D3Q27 collision set
- the force_field steps (B4, B2/B3), the one-kernel NN step (B10) and the
full-set pair (B1b) - under every case of ``torch_cases.COLLISION_CASES``
and CUM with ``eq_entropic``, against the port's plain step
(``sim/step.py make_step``), which the JAX suite's compares hold to the JAX
package per id (tests/test_torch_collisions.py).  No JAX here.

- force_field: one A-B step on the box of every code, one even and one odd
  step on the box of every A-A code, a seeded per-site force plus a
  homogeneous one (``force_add``) against ``make_step`` with their sum as a
  per-site body force;
- B10: its plain version (the plain hooked step) against the pipeline's
  plain parts (the u* pass, B9, the force_field step) on the wall duct with
  the Carreau-Yasuda hook, A-B and A-A (even, then odd);
- B1b: one pair against ``make_step``'s even step, then its odd step.

Bounds |df| <= 1e-6 (KBC 1e-5), |drho| <= 2e-6, |du| <= 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.kernels.fused import make_fused_step, step_instance
from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair_aa, make_fused_step_aa
from tnl_lbm_tpu_torch.kernels.hooked import make_hooked_fused_step
from tnl_lbm_tpu_torch.ops.non_newtonian import CarreauYasuda, make_nn_forcing_hook
from tnl_lbm_tpu_torch.sim import make_step

from torch_cases import (
    COLLISION_CASES,
    U_IN,
    aa_box,
    bc_box,
    collision_spec,
    collision_state,
    collision_tol_f,
    nn_case,
)

NU = 0.02
FORCE = (1e-5, -2e-6, 3e-6)
BOX = (6, 8, 10)
BOUNDS = {"f": 1e-6, "rho": 2e-6, "u": 1e-6}
#: every case of the card's compares, and CUM with the entropic equilibrium
ALL_CASES = COLLISION_CASES + (("CUM", "EQ_ENTROPIC"),)
IDS = [c + (f"-{e}" if e else "") for c, e in ALL_CASES]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def agree(ref, got, cid, label):
    tol = {k: max(v, collision_tol_f(cid)) for k, v in BOUNDS.items()}
    d = {n: float((a.double() - b.double()).abs().max()) for n, a, b in
         zip(("f", "rho", "u"), ref, got)}
    assert all(d[k] <= tol[k] for k in d), (cid, label, d)


def sides(cid, eq, streaming, m, periodic=(False, False, True)):
    cfg = interop.config_from_spec(**collision_spec(cid, streaming, eq))
    dom = interop.domain_from_numpy(m, periodic)
    return cfg, dom, collision_state(cfg, m.shape, "cpu")


@pytest.mark.parametrize("cid,eq", ALL_CASES, ids=IDS)
def test_force_field_and_pair_plain_match_the_plain_step(cid, eq):
    field = torch.from_numpy(
        (1e-5 * np.random.default_rng(4).standard_normal((3,) + BOX)).astype(np.float32))
    total = torch.stack([FORCE[a] + field[a] for a in range(3)])
    cfg, dom, f = sides(cid, eq, "AB", bc_box(BOX))
    ff = make_fused_step(cfg, dom, "cpu", force_field=True)
    assert ff._instance == step_instance(cfg)
    agree(make_step(cfg, dom)(f, NU, u_in=U_IN, force=total),
          ff.plain(f, NU, u_in=U_IN, force=field, force_add=FORCE), cid, "B4 force_field")
    cfg, dom, f = sides(cid, eq, "AA", aa_box(BOX))
    plain = make_step(cfg, dom)
    ff = make_fused_step_aa(cfg, dom, "cpu", force_field=True)
    for parity in (0, 1):
        agree(plain(f, NU, u_in=U_IN, force=total, parity=parity),
              ff.plain(f, NU, u_in=U_IN, force=field, force_add=FORCE, parity=parity), cid,
              f"B2/B3 force_field parity {parity}")
    pair = make_fused_pair_aa(cfg, dom, "cpu")
    even = plain(f, NU, u_in=U_IN, force=FORCE, parity=0)[0]
    agree(plain(even, NU, u_in=U_IN, force=FORCE, parity=1),
          pair.plain(f, NU, u_in=U_IN, force=FORCE), cid, "B1b")


@pytest.mark.parametrize("cid,eq", ALL_CASES, ids=IDS)
def test_nn_step_plain_matches_the_pipeline_parts(cid, eq):
    m, periodic, _, hper = nn_case("duct", BOX)
    hook = make_nn_forcing_hook(CarreauYasuda(0.1, 1.0, 2.0, 0.5), periodic=hper)
    for streaming in ("AB", "AA"):
        cfg, dom, f = sides(cid, eq, streaming, m, periodic)
        cfg = dataclasses.replace(cfg, forcing_hook=hook)
        single = make_hooked_fused_step(cfg, dom, "cpu")
        pipeline = make_hooked_fused_step(cfg, dom, "cpu", single_kernel=False)
        assert single.route == "single_kernel" and single.nn_single._variant is None
        for parity in ((0,) if streaming == "AB" else (0, 1)):
            agree(single.nn_single.plain(f, NU, force=FORCE, parity=parity),
                  pipeline(f.clone(), NU, force=FORCE, parity=parity), cid,
                  f"B10 {streaming} parity {parity}")
