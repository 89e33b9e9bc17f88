"""The A-A step of ``tnl_lbm_tpu_torch.kernels.fused_aa`` on the CPU.

On CPU tensors the step runs the kernels' plain versions
(``even_step_plain`` / ``odd_step_plain``), which are held against the JAX
``make_step`` (and, under ``-m slow``, the JAX Pallas kernels in interpret
mode) at the JAX kernel suite's bounds: |df| < 1e-6, |drho| < 2e-6,
|du| < 1e-6 per step.  The CUDA sources cannot run here; their direction
tables and the odd kernel's scatter rule are checked against the descriptor
and the gather definition of the push.
"""

import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.models import D3Q27
from tnl_lbm_tpu.sim import make_step as j_make_step
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.kernels.build import kernel_resources
from tnl_lbm_tpu_torch.kernels.fused import supports
from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa
from tnl_lbm_tpu_torch.ops import streaming as pstream
from tnl_lbm_tpu_torch.ops.boundary import GEO

from test_torch_step import FORCE, NU, geometry, jax_side, rand_f, spec

CSRC = Path(__file__).resolve().parents[1] / "tnl_lbm_tpu_torch" / "csrc"


def run_against(jax_step_factory, kind, n_steps=4, seed=5):
    m, periodic = geometry(kind)
    s = spec("AA")
    jcfg, jdom = jax_side(s, m, periodic)
    jstep = jax_step_factory(jcfg, jdom)
    step = make_fused_step_aa(interop.config_from_spec(**s), interop.domain_from_numpy(m, periodic),
                              "cpu")
    f0 = rand_f(jcfg, seed=seed)
    fj, fp = jnp.asarray(f0), interop.state_from_numpy(f0, "cpu")
    for it in range(n_steps):
        fj, rj, uj = jstep(fj, NU, force=jnp.asarray(FORCE, jnp.float32), parity=it % 2)
        fp, rp, up = step(fp, NU, force=FORCE, parity=it % 2)
        assert np.abs(np.asarray(fj) - fp.numpy()).max() < 1e-6, f"f, step {it}"
        assert np.abs(np.asarray(rj) - rp.numpy()).max() < 2e-6, f"rho, step {it}"
        assert np.abs(np.asarray(uj) - up.numpy()).max() < 1e-6, f"u, step {it}"
    assert step.plain_calls == n_steps and step.even.launches == step.odd.launches == 0
    return step


@pytest.mark.parametrize("kind", ["duct", "torus"])
def test_plain_aa_matches_jax_make_step(kind):
    run_against(j_make_step, kind)


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["duct", "torus"])
def test_plain_aa_matches_jax_pallas_interpret(kind):
    from tnl_lbm_tpu.kernels.fused_aa import make_fused_step_aa as j_make_fused_step_aa

    run_against(lambda c, d: j_make_fused_step_aa(c, d, tile_even=(8, 8), tile_odd=(8, 8)), kind)


def test_even_step_updates_in_place_and_odd_returns_new_state():
    m, periodic = geometry("duct")
    step = make_fused_step_aa(interop.config_from_spec(**spec("AA")),
                              interop.domain_from_numpy(m, periodic), "cpu")
    f = interop.state_from_numpy(rand_f(jax_side(spec("AA"), m, periodic)[0]), "cpu")
    before = f.clone()
    f_even, _, _ = step(f, NU, force=FORCE, parity=0)
    assert f_even is f and not torch.equal(f, before)
    f_odd, _, _ = step(f, NU, force=FORCE, parity=1)
    assert f_odd is not f and f_odd.shape == f.shape and f_odd.is_contiguous()
    # the plain version on its own leaves f alone and counts nothing
    kept = f.clone()
    f_plain, _, _ = step.plain(f, NU, force=FORCE, parity=0)
    assert torch.equal(f, kept) and not torch.equal(f_plain, kept)
    assert step.plain_calls == 2


def test_unported_variants_raise():
    m, periodic = geometry("duct")
    cfg, dom = interop.config_from_spec(**spec("AA")), interop.domain_from_numpy(m, periodic)
    for kw, suffix in (({"force_field": True}, "_force_field"),
                       ({"macro_only": True}, "_macro_only")):
        variant = make_fused_step_aa(cfg, dom, "cpu", **kw)
        assert (variant.even.name, variant.odd.name) == ("aa_even" + suffix, "aa_odd" + suffix)
    with pytest.raises(ValueError, match="exclude"):
        make_fused_step_aa(cfg, dom, "cpu", force_field=True, macro_only=True)
    with pytest.raises(ValueError):
        make_fused_step_aa(interop.config_from_spec(**spec("AB")), dom, "cpu")
    step = make_fused_step_aa(cfg, dom, "cpu")
    f = torch.zeros((27,) + m.shape)
    with pytest.raises(NotImplementedError):
        step(f, NU, force=np.zeros((3,) + m.shape), parity=0)
    with pytest.raises(NotImplementedError):
        step(f, NU, u_in=np.zeros((3, 1) + m.shape[1:]), parity=0)


def test_supports_reports_the_ported_codes():
    m, periodic = geometry("duct")
    assert supports(interop.domain_from_numpy(m, periodic), "AA")
    assert supports(interop.domain_from_numpy(m, periodic), "AA", pair=True)
    m[2, 2, 2] = GEO.INFLOW_LEFT
    # the even/odd kernels take it, the pair does not
    assert supports(interop.domain_from_numpy(m, periodic), "AA")
    assert not supports(interop.domain_from_numpy(m, periodic), "AA", pair=True)
    m[2, 2, 3] = GEO.OUTFLOW_RIGHT_INTERP  # A-B only
    assert not supports(interop.domain_from_numpy(m, periodic), "AA")
    # the A-B kernel takes the full 3D set
    assert supports(interop.domain_from_numpy(m, periodic), "AB")
    m[3, 3, 3] = GEO.FLUID_NEAR_WALL  # Bouzidi curved walls are D2Q9 only
    assert not supports(interop.domain_from_numpy(m, periodic), "AB")


def test_cuda_step_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card refusal")
    m, periodic = geometry("duct")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fused_step_aa(interop.config_from_spec(**spec("AA")),
                           interop.domain_from_numpy(m, periodic), "cuda")


def _switch_table(source, func):
    body = source[source.index(f"int {func}("):]
    body = body[: body.index("\n}\n")]
    cases = dict((int(k), int(v)) for k, v in re.findall(r"case (\d+): return (\d+);", body))
    cases[max(cases) + 1] = int(re.search(r"default: return (\d+);", body).group(1))
    return cases


def test_cuda_direction_tables_match_descriptor():
    src = (CSRC / "lbm_site.cuh").read_text()
    code = _switch_table(src, "dir_code")
    index = _switch_table(src, "dir_index")
    for q in range(27):
        cx, cy, cz = (int(v) for v in D3Q27.c[q])
        c = 9 * (cx + 1) + 3 * (cy + 1) + (cz + 1)
        assert code[q] == c, D3Q27.names[q]
        assert index[c] == q, D3Q27.names[q]
    opp = [0 if q == 0 else (q + 1 if q % 2 else q - 1) for q in range(27)]
    assert opp == [int(v) for v in D3Q27.opp]


def _push_targets(s, c, n, periodic):
    """Python transliteration of csrc/lbm_site.cuh push_targets."""
    if c == 0:
        return [s]
    if periodic:
        return [(s + c) % n]
    out = [s + c] if 0 <= s + c < n else []
    if (c > 0 and s == 0) or (c < 0 and s == n - 1):
        out.append(s)
    return out


@pytest.mark.parametrize("periodic", [(True, False, False), (False, False, False), (True, True, True)])
def test_odd_kernel_scatter_equals_padded_pull(periodic):
    """The odd kernel pushes each site's post-collision values to its
    destinations; that scatter must write every (q, x) exactly once and
    equal the JAX definition f_out = pull(pad_halo(f_post)) (sim/step.py:224)."""
    shape = (3, 4, 5)
    rng = np.random.default_rng(9)
    post = rng.standard_normal((27,) + shape).astype(np.float32)
    want = pstream.pull(D3Q27, pstream.pad_halo(torch.from_numpy(post), periodic), shape).numpy()
    got = np.full_like(post, np.nan)
    writes = np.zeros(post.shape, np.int64)
    for q in range(27):
        c = [int(v) for v in D3Q27.c[q]]
        for s in itertools.product(*(range(n) for n in shape)):
            dests = [_push_targets(s[a], c[a], shape[a], periodic[a]) for a in range(3)]
            for d in itertools.product(*dests):
                got[(q,) + d] = post[(q,) + s]
                writes[(q,) + d] += 1
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want)


def test_ptxas_report_parser():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function 'aa_even_kernel' for 'sm_90a'
ptxas info    : Function properties for aa_even_kernel
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 0 barriers
ptxas info    : Compiling entry function 'aa_odd_kernel' for 'sm_90a'
ptxas info    : Function properties for aa_odd_kernel
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 91 registers, used 0 barriers, 16 bytes smem
"""
    res = kernel_resources(log)
    assert res["aa_even_kernel"] == {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                                     "registers": 56, "smem": 0}
    assert res["aa_odd_kernel"] == {"stack": 8, "spill_stores": 4, "spill_loads": 12,
                                    "registers": 91, "smem": 16}
