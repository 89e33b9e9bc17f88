"""The A-B path of the port on the CPU, held against the JAX package.

The new ops (``pull_shift_x``, ``pull_interp_right``, ``eq_inv_cum``, the
Eichler moment inflow), the plain step with the full 3D boundary set for
both patterns, and the A-B step (B4), whose wrapper runs its plain version
on CPU tensors, go through the same seeded inputs as the JAX functions.
Per-step bounds are the JAX kernel suite's (tests/test_fused_kernel.py:65-67):
|df| < 1e-6, |drho| < 2e-6, |du| < 1e-6.  The CUDA source cannot run here:
its Eichler inflow is transliterated to Python and run on the same DFs.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.models import D3Q27
from tnl_lbm_tpu.ops import boundary as jbc
from tnl_lbm_tpu.ops import equilibrium as jeq
from tnl_lbm_tpu.ops import streaming as jstream
from tnl_lbm_tpu.sim import make_step as j_make_step
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.kernels.fused import make_fused_step, supports
from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_step_aa
from tnl_lbm_tpu_torch.ops import boundary as pbc
from tnl_lbm_tpu_torch.ops import equilibrium as peq
from tnl_lbm_tpu_torch.ops import streaming as pstream
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim import make_step
from tnl_lbm_tpu_torch.sim.state import Simulation

from test_torch_fused_aa import _switch_table
from torch_cases import AB_KINDS, AB_SPECS, U_IN, channel
from test_torch_step import jax_side

CSRC = Path(__file__).resolve().parents[1] / "tnl_lbm_tpu_torch" / "csrc"
NU = 0.02
FORCE = (1e-5, 0.0, 0.0)
#: the codes of the A-A even/odd kernels: the 3D set but the A-B-only interpolated outflow
AA_CODES = {GEO.FLUID, GEO.WALL, GEO.INFLOW, GEO.INFLOW_LEFT, GEO.OUTFLOW_EQ, GEO.OUTFLOW_RIGHT,
            GEO.PERIODIC, GEO.NOTHING, GEO.SYM_TOP, GEO.SYM_BOTTOM, GEO.SYM_LEFT, GEO.SYM_RIGHT,
            GEO.SYM_BACK, GEO.SYM_FRONT}


def seeded(shape, seed=0):
    rng = np.random.default_rng(seed)
    return ((1 + 0.01 * rng.standard_normal(shape)).astype(np.float32),
            (0.02 * rng.standard_normal((3,) + shape)).astype(np.float32))


def spec_of(name, streaming):
    cid, eq, well = AB_SPECS[name]
    return dict(collision_id=cid, eq=eq, well=well, streaming=streaming, dtype="float32")


def start_state(jcfg, shape, seed=11):
    rho, u = seeded(shape, seed)
    return np.array(jcfg.eq(D3Q27, jnp.asarray(rho), jnp.asarray(u)).astype(jnp.float32))


def close(j, p, tol):
    return np.abs(np.asarray(j) - p.numpy()).max() < tol


# ------------------------------------------------------------------- ops

def test_outflow_pulls_match_jax():
    fpad = np.random.default_rng(1).standard_normal((27, 7, 6, 5)).astype(np.float32)
    S = (5, 4, 3)
    for jf, pf in ((lambda a: jstream.pull_shift_x(D3Q27, a, S, dx=-1),
                    lambda a: pstream.pull_shift_x(D3Q27, a, S, dx=-1)),
                   (lambda a: jstream.pull_interp_right(D3Q27, a, S),
                    lambda a: pstream.pull_interp_right(D3Q27, a, S))):
        np.testing.assert_array_equal(np.asarray(jf(jnp.asarray(fpad))),
                                      pf(torch.from_numpy(fpad)).numpy())
    assert pstream.SPEED_OF_SOUND == jstream.SPEED_OF_SOUND


def test_eq_inv_cum_matches_jax():
    rho, u = seeded((4, 5, 6))
    want = jeq.eq_inv_cum(D3Q27, jnp.asarray(rho), jnp.asarray(u))
    got = peq.eq_inv_cum(D3Q27, torch.from_numpy(rho), torch.from_numpy(u))
    assert close(want, got, 1e-7)
    assert peq.EQUILIBRIA["EQ_INV_CUM"] is peq.eq_inv_cum


@pytest.mark.parametrize("well", [False, True], ids=["total", "well"])
def test_inflow_left_moment_bc_matches_jax(well):
    """On total DFs, or on deviation DFs shifted by the weights first (the
    well storage's conversion around the BC)."""
    rho, u = seeded((3, 4, 5), seed=2)
    eq = jeq.eq_well if well else jeq.eq_quadratic
    f = np.array(eq(D3Q27, jnp.asarray(rho), jnp.asarray(u)))
    if well:
        f = f + np.asarray(D3Q27.w, np.float32).reshape(27, 1, 1, 1)
    u_in = np.asarray([0.03, 0.004, -0.002], np.float32)
    fj, rj = jbc.inflow_left_moment_bc(D3Q27, jnp.asarray(f), jnp.asarray(u_in))
    fp, rp = pbc.inflow_left_moment_bc(D3Q27, torch.from_numpy(f), [float(v) for v in u_in])
    assert close(fj, fp, 1e-7) and close(rj, rp, 1e-7)


def cuda_inflow_left(f, vx, vy, vz):
    """csrc/lbm_site.cuh inflow_left_moment transliterated to Python: each
    FN("xyz") becomes the index that the CUDA code computes for it (qn, via
    the dir_index table of the source)."""
    src = (CSRC / "lbm_site.cuh").read_text()
    index = _switch_table(src, "dir_index")
    body = src[src.index("#define FN(name)"):src.index("#undef FN")].split("\n", 1)[1]
    digit = {"m": 0, "z": 1, "p": 2}
    env = {"f": list(f), "vx": vx, "vy": vy, "vz": vz}
    for stmt in " ".join(line.split("//")[0] for line in body.splitlines()).split(";"):
        stmt = stmt.strip()
        if not stmt:
            continue
        stmt = re.sub(r'FN\("([mzp]{3})"\)',
                      lambda mt: f"f[{index[sum(3 ** (2 - a) * digit[c] for a, c in enumerate(mt.group(1)))]}]",
                      stmt)
        stmt = re.sub(r"^const (?:float|real) ", "", stmt)
        stmt = re.sub(r"real\((\d+\.\d*)\)|(\d+\.\d*)f\b", r"\1\2", stmt)
        exec(stmt, {}, env)
    return np.stack(env["f"]), env["rho"]


def test_cuda_eichler_inflow_matches_the_port():
    """The CUDA names resolve to the descriptor's order, and the device
    arithmetic equals boundary.inflow_left_moment_bc."""
    index = _switch_table((CSRC / "lbm_site.cuh").read_text(), "dir_index")
    for q, name in enumerate(D3Q27.names):
        digits = [{"m": 0, "z": 1, "p": 2}[c] for c in name]
        assert index[9 * digits[0] + 3 * digits[1] + digits[2]] == q == D3Q27.idx(name)
    rho, u = seeded((3, 4, 5), seed=4)
    f = peq.eq_quadratic(D3Q27, torch.from_numpy(rho), torch.from_numpy(u))
    u_in = (0.03, 0.004, -0.002)
    want_f, want_rho = pbc.inflow_left_moment_bc(D3Q27, f, u_in)
    got_f, got_rho = cuda_inflow_left(f.numpy(), *u_in)
    np.testing.assert_allclose(got_f, want_f.numpy(), atol=1e-7)
    np.testing.assert_allclose(got_rho, want_rho.numpy(), atol=1e-7)


# ------------------------------------------------------------ the steps

def both_steps(kind, spec, streaming, steps=2):
    """Port make_step (and for A-B the A-B step's plain version) against
    JAX make_step from one seeded state; returns the last port state."""
    m, periodic = channel(kind)
    s = spec_of(spec, streaming)
    jcfg, jdom = jax_side(s, m, periodic)
    cfg, dom = interop.config_from_spec(**s), interop.domain_from_numpy(m, periodic)
    ports = [make_step(cfg, dom)]
    if streaming == "AB":
        ports.append(make_fused_step(cfg, dom, "cpu"))
    jstep = j_make_step(jcfg, jdom)
    f0 = start_state(jcfg, m.shape)
    fj = jnp.asarray(f0)
    fps = [torch.from_numpy(f0.copy()) for _ in ports]
    u_in, force = jnp.asarray(U_IN, jnp.float32), jnp.asarray(FORCE, jnp.float32)
    for it in range(steps):
        parity = it % 2 if streaming == "AA" else 0
        fj, rj, uj = jstep(fj, NU, u_in=u_in, force=force, parity=parity)
        for i, port in enumerate(ports):
            fps[i], rp, up = port(fps[i], NU, u_in=np.asarray(U_IN), force=FORCE, parity=parity)
            assert close(fj, fps[i], 1e-6), f"f, port {i}, step {it}"
            assert close(rj, rp, 2e-6), f"rho, port {i}, step {it}"
            assert close(uj, up, 1e-6), f"u, port {i}, step {it}"
    assert np.abs(fps[0].numpy() - f0).max() > 1e-5  # the steps did work
    if streaming == "AB":
        assert ports[1].plain_calls == steps and ports[1].kernel.launches == 0
    return fps[0]


@pytest.mark.parametrize("spec", ["CUM_WELL", "CUM", "CUM_INV_CUM"])
@pytest.mark.parametrize("kind", AB_KINDS)
def test_ab_steps_match_jax(kind, spec):
    both_steps(kind, spec, "AB")


@pytest.mark.parametrize("spec", ["CUM_WELL", "CUM"])
@pytest.mark.parametrize("kind", ["inflow_outflow", "eq_inflow", "sym", "periodic_code"])
def test_aa_plain_steps_match_jax(kind, spec):
    both_steps(kind, spec, "AA", steps=4)


# ------------------------------------------------------- support checks

def test_supports_per_pattern():
    for kind in AB_KINDS:
        m, periodic = channel(kind)
        dom = interop.domain_from_numpy(m, periodic)
        codes = dom.codes_present()
        assert supports(dom, "AB")
        assert supports(dom, "AA") == (codes <= AA_CODES), kind
    m, periodic = channel("interp_outflow")
    dom = interop.domain_from_numpy(m, periodic)
    cfg = interop.config_from_spec(**spec_of("CUM", "AA"))
    with pytest.raises(NotImplementedError, match="A-B pattern"):
        make_step(cfg, dom)
    with pytest.raises(NotImplementedError, match="A-B pattern"):
        make_fused_step_aa(cfg, dom, "cpu")


def test_ab_step_refuses_what_it_does_not_implement(monkeypatch):
    m, periodic = channel("box")
    dom = interop.domain_from_numpy(m, periodic)
    cfg = interop.config_from_spec(**spec_of("CUM_WELL", "AB"))
    # the haloed block of the sharded step: the cumulant steps' instances;
    # a family collision, the force_field / macro_only variants and a
    # local_shape without prepadded are refused
    assert make_fused_step(cfg, dom, "cpu", prepadded=True).kernel.name == "ab_step_halo"
    srt = interop.config_from_spec("SRT", "EQ", False, "AB")
    for c, kw in ((srt, {}), (cfg, {"force_field": True}), (cfg, {"macro_only": True})):
        with pytest.raises(NotImplementedError, match="ROADMAP A13b"):
            make_fused_step(c, dom, "cpu", prepadded=True, **kw)
    with pytest.raises(ValueError, match="prepadded"):
        make_fused_step(cfg, dom, "cpu", local_shape=m.shape)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        make_fused_step(cfg, dom, "cpu", with_macro=False)
    for kw, name in (({"force_field": True}, "ab_step_force_field"),
                     ({"macro_only": True}, "ab_step_macro_only")):
        assert make_fused_step(cfg, dom, "cpu", **kw).kernel.name == name
    with pytest.raises(ValueError, match="exclude"):
        make_fused_step(cfg, dom, "cpu", force_field=True, macro_only=True)
    with pytest.raises(ValueError):
        make_fused_step(interop.config_from_spec(**spec_of("CUM_WELL", "AA")), dom, "cpu")
    step = make_fused_step(cfg, dom, "cpu")
    f = torch.zeros((27,) + m.shape)
    # a per-site inflow profile: CUM_WELL's step has the profile instance, CUM's not
    cum = make_fused_step(interop.config_from_spec(**spec_of("CUM", "AB")), dom, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Bprof"):
        cum(f, NU, u_in=np.zeros((3,) + m.shape))
    with pytest.raises(NotImplementedError, match="force_field"):
        step(f, NU, force=np.zeros((3,) + m.shape))
    with pytest.raises(ValueError):
        step(f, NU, out=f)
    # on a card the kernel takes f32 CUM_WELL / CUM and f64 CUM_WELL only, and names the rest
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="ROADMAP Bf64"):
        make_fused_step(interop.config_from_spec(**{**spec_of("CUM", "AB"), "dtype": "float64"}),
                        dom, "cuda")
    bad = (interop.config_from_spec(**{**spec_of("CUM", "AB"), "dtype": "float64"}),
           interop.config_from_spec(**{**spec_of("CUM", "AB"), "eq": "EQ_WELL"}),
           interop.config_from_spec(**{**spec_of("CUM_WELL", "AB"), "well": False}),
           interop.config_from_spec(**{**spec_of("CUM", "AB"), "collision_id": "CUM_WELL"}))
    for c in bad:
        with pytest.raises(NotImplementedError):
            make_fused_step(c, dom, "cuda")
    entropic = dataclasses.replace(interop.config_from_spec(**spec_of("CUM", "AB")),
                                   eq=lambda lat, rho, u: None)
    with pytest.raises(NotImplementedError, match="eq_entropic"):
        make_fused_step(entropic, dom, "cuda")


def test_cuda_ab_step_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card refusal")
    m, periodic = channel("box")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fused_step(interop.config_from_spec(**spec_of("CUM_WELL", "AB")),
                        interop.domain_from_numpy(m, periodic), "cuda")


# ------------------------------------------------------------ Simulation

class Channel(Simulation):
    def update_inflow(self, phys_time):
        return np.asarray(U_IN)


def test_simulation_ab_ping_pongs_two_buffers(tmp_path):
    """A-B with the kernels on CPU tensors: the plain version every step,
    no launch, and the state alternates between two preallocated buffers."""
    m, periodic = channel("box")
    dom = interop.domain_from_numpy(m, periodic, phys_viscosity=NU)
    cfg = interop.config_from_spec(**spec_of("CUM_WELL", "AB"))
    sim = Channel(cfg, dom, device="cpu", sim_id="ab", results_parent=tmp_path,
                  phys_final_time=1e9, steps_per_dispatch=1, use_fused=True)
    sim.sim_init()
    buffers = {sim.f.data_ptr(), sim._spare.data_ptr()}
    seen = set()
    for _ in range(4):
        sim._advance(1)
        seen.add(sim.f.data_ptr())
    assert seen == buffers and sim.iterations == 4
    assert sim._step.plain_calls == 4 and sim._step.kernel.launches == 0
    assert torch.isfinite(sim.u).all() and float(sim.u[0].abs().max()) > 0
