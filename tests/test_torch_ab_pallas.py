"""The A-B step's plain version against the JAX Pallas kernel it replaces
(``tnl_lbm_tpu/kernels/fused.py`` ``make_fused_step``), run in interpret
mode as the JAX suite runs it on the CPU, on the box that holds every code
of the 3D set.  Bounds: |df| < 1e-6, |drho| < 2e-6, |du| < 1e-6."""

import jax.numpy as jnp
import torch

from tnl_lbm_tpu.kernels.fused import make_fused_step as j_make_fused_step
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.kernels.fused import make_fused_step

from test_torch_ab import FORCE, NU, close, spec_of, start_state
from torch_cases import U_IN, channel
from test_torch_step import jax_side


def test_ab_step_plain_matches_jax_pallas_interpret():
    m, periodic = channel("box")
    s = spec_of("CUM_WELL", "AB")
    jcfg, jdom = jax_side(s, m, periodic)
    jstep = j_make_fused_step(jcfg, jdom)
    step = make_fused_step(interop.config_from_spec(**s), interop.domain_from_numpy(m, periodic),
                           "cpu")
    f0 = start_state(jcfg, m.shape)
    fj, rj, uj = jstep(jnp.asarray(f0), NU, u_in=jnp.asarray(U_IN, jnp.float32),
                       force=jnp.asarray(FORCE, jnp.float32))
    fp, rp, up = step(torch.from_numpy(f0), NU, u_in=U_IN, force=FORCE)
    assert close(fj, fp, 1e-6) and close(rj, rp, 2e-6) and close(uj, up, 1e-6)
    assert step.plain_calls == 1 and step.kernel.launches == 0
