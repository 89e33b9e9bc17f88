"""B5's resident chunk (``FusedChunk2D``) on the CPU: its plain version
against ``n`` plain steps of the D2Q9 kernel's plain version (bit for bit)
and against the JAX package's ``n``-step scan over ``make_fused_step_2d``
in interpret mode; the buffers it leaves, alone and for a golden row's
chunk in a run; the size rule, read from ``csrc/d2q9_step.cu``.  The kernel itself runs on the card
(``tests/test_torch_gpu.py``)."""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnl_lbm_tpu.kernels.fused_2d import make_fused_step_2d as j_make_fused_step_2d
from tnl_lbm_tpu.models import D2Q9 as JD2Q9
from tnl_lbm_tpu.ops import collision_2d as jcol2
from tnl_lbm_tpu.sim import Domain as JDomain
from tnl_lbm_tpu.sim import LBMConfig as JConfig
from tnl_lbm_tpu.utils import Lattice as JLattice
from tnl_lbm_tpu_torch import interop
from tnl_lbm_tpu_torch.apps import sim2d_3
from tnl_lbm_tpu_torch.kernels.fused_2d import (
    FusedChunk2D,
    make_fused_step_2d,
    resident_band,
    resident_bytes,
    resident_fits,
    resident_limits,
)

from torch_cases import FORCE_2D, case_2d, parabolic_2d, resident_route, seeded_2d

ROOT = Path(__file__).resolve().parents[1]
NU = 0.02
TOL_F, TOL_RHO, TOL_U = 1e-6, 2e-6, 1e-6
SHAPE = (24, 12)
#: (collision, a force was passed): the chunk's three kernel instances
INSTANCES = [("SRT", False), ("SRT", True), ("CLBM", False)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ring_case():
    """A 24 x 12 channel with an INFLOW column, OUTFLOW_RIGHT, walls, a WALL
    block in a Bouzidi ring (seeded thetas, -1 links) and a periodic y."""
    m, _, bz = case_2d("bouzidi", SHAPE)
    return m, (False, True), bz


def both_sides(collision):
    m, periodic, bz = ring_case()
    jcfg = JConfig(lat=JD2Q9, collision=jcol2.COLLISIONS_D2Q9[collision])
    jdom = JDomain(lat=JD2Q9, units=JLattice(SHAPE, (0, 0), 1.0, 1.0), map=m.copy(),
                   periodic=periodic, bouzidi=bz)
    cfg = interop.config_2d_from_spec(collision)
    dom = interop.domain_from_numpy(m, periodic, lat=cfg.lat, bouzidi=bz)
    return jcfg, jdom, cfg, dom


def jax_chunk(jstep, f0, n, u_in, force):
    """The JAX driver's chunk: ``n`` steps of the fused kernel as one
    ``lax.scan`` (its carry the state, its last rho and u kept)."""
    kw = {"u_in": jnp.asarray(u_in), "force": None if force is None else jnp.asarray(force)}

    def body(carry, _):
        f, _, _ = carry
        return jstep(f, NU, **kw), None

    f, rho, u = jstep(jnp.asarray(f0), NU, **kw)
    (f, rho, u), _ = jax.lax.scan(body, (f, rho, u), None, length=n - 1)
    return np.asarray(f), np.asarray(rho), np.asarray(u)


@pytest.mark.parametrize("n", [4, 5])
@pytest.mark.parametrize("collision,forced", INSTANCES, ids=["srt", "srt_force", "clbm"])
def test_chunk_plain_equals_plain_steps_and_jax_scan(collision, forced, n):
    """The chunk's CPU path and its plain version equal ``n`` plain B5 steps
    bit for bit, and the JAX scan over the Pallas kernel (interpret mode)
    within the step bounds, from a seeded state on a Bouzidi ring with an
    inflow profile, OUTFLOW_RIGHT and a periodic y."""
    jcfg, jdom, cfg, dom = both_sides(collision)
    u_in = parabolic_2d(SHAPE[1]).astype(np.float32)
    force = np.asarray(FORCE_2D, np.float32) if forced else None
    step = make_fused_step_2d(cfg, dom, "cpu")
    chunk = FusedChunk2D(step)
    f0 = seeded_2d(cfg, SHAPE, "cpu", seed=3)

    f = f0
    for _ in range(n):
        f, rho, u = step.plain(f, NU, u_in=u_in, force=force)
    got = chunk(f0, NU, n, u_in=u_in, force=force)
    plain = chunk.plain(f0, NU, n, u_in=u_in, force=force)
    for a, b in zip(got, (f, rho, u)):
        assert torch.equal(a, b)
    for a, b in zip(plain, (f, rho, u)):
        assert torch.equal(a, b)
    assert chunk.plain_calls == 1 and step.plain_calls == n and chunk.steps == 0
    assert chunk.kernel.launches == step.kernel.launches == 0

    jf, jrho, ju = jax_chunk(j_make_fused_step_2d(jcfg, jdom), f0.numpy(), n, u_in, force)
    assert np.abs(jf - f.numpy()).max() < TOL_F
    assert np.abs(jrho - rho.numpy()).max() < TOL_RHO
    assert np.abs(ju - u.numpy()).max() < TOL_U


@pytest.mark.parametrize("n", [1, 4, 5])
def test_chunk_leaves_the_state_where_the_ping_pong_does(n):
    """With ``out``: the state lands in ``out`` after an odd chunk and in f
    after an even one, as n out-of-place steps ping-ponging the two leave
    it; without ``out``, in a new tensor, f untouched."""
    _, _, cfg, dom = both_sides("CLBM")
    step = make_fused_step_2d(cfg, dom, "cpu")
    chunk = FusedChunk2D(step)
    f0 = seeded_2d(cfg, SHAPE, "cpu", seed=4)
    a, b = f0.clone(), torch.empty_like(f0)
    rho, u = torch.empty(SHAPE), torch.empty((2,) + SHAPE)
    got, r, v = chunk(a, NU, n, u_in=(0.03, 0.0), out=b, macro_out=(rho, u))
    assert got is (b if n % 2 else a) and r is rho and v is u
    want = chunk.plain(f0, NU, n, u_in=(0.03, 0.0))
    assert torch.equal(got, want[0]) and torch.equal(rho, want[1]) and torch.equal(u, want[2])
    c = f0.clone()
    new, _, _ = chunk(c, NU, n, u_in=(0.03, 0.0))
    assert torch.equal(c, f0) and torch.equal(new, want[0])


def test_chunk_refuses_what_it_does_not_take():
    _, _, cfg, dom = both_sides("SRT")
    step = make_fused_step_2d(cfg, dom, "cpu")
    chunk = FusedChunk2D(step)
    f = seeded_2d(cfg, SHAPE, "cpu")
    with pytest.raises(ValueError, match="at least one step"):
        chunk(f, NU, 0)
    with pytest.raises(NotImplementedError, match="force_field"):
        FusedChunk2D(make_fused_step_2d(cfg, dom, "cpu", force_field=True))
    big = interop.domain_from_numpy(np.zeros((512, 512), np.uint8), (True, True), lat=cfg.lat)
    with pytest.raises(ValueError, match="does not fit"):
        FusedChunk2D(make_fused_step_2d(cfg, big, "cpu"))


def test_size_rule_and_the_kernel_constants():
    """The size rule is the kernel's (csrc/d2q9_step.cu, read from the
    source: its constants and the layout they give), and it admits the
    golden sweep's 128 x 32 and sim2d_3 res 2 (256 x 64), not sim2d_3 res 64
    (8192 x 2048)."""
    src = (ROOT / "tnl_lbm_tpu_torch" / "csrc" / "d2q9_step.cu").read_text()
    lim = resident_limits()
    for name in ("CLUSTER_MAX", "CHUNK_SMEM_MAX", "CHUNK_BYTES_PER_SITE", "CHUNK_THETA_BYTES",
                 "CHUNK_THREADS"):
        assert re.search(rf"constexpr int {name} = {lim[name]};", src), name
    assert (lim["CLUSTER_MAX"], lim["CHUNK_SMEM_MAX"]) == (16, 200 * 1024)
    assert lim["CHUNK_BYTES_PER_SITE"] == 2 * 9 * 4 + 1 and lim["CHUNK_THETA_BYTES"] == 8 * 4
    assert resident_band((128, 32)) == 8 and resident_band((130, 32)) == 9
    assert resident_bytes((128, 32), thetas=True) == 26880
    assert resident_bytes((256, 64), thetas=True) == 107520
    for thetas in (False, True):
        assert resident_fits((128, 32), thetas=thetas) and resident_fits((256, 64), thetas=thetas)
        assert not resident_fits((8192, 2048), thetas=thetas)
    assert resident_fits((208, 208)) and not resident_fits((209, 209))
    assert resident_fits((176, 176), thetas=True) and not resident_fits((177, 177), thetas=True)
    assert resident_fits((16, 2800)) and not resident_fits((17, 2800))


# ------------------------------------------------- the chunk in a run

def golden_sim(tmp_path, tag, geos, **kw):
    return sim2d_3.build(1, str(geos / "1.txt"), True, final_time=0.4,
                         results_parent=tmp_path / tag, values_dir=tmp_path / tag / "values",
                         device="cpu", **kw)


@pytest.fixture(scope="module")
def geos(tmp_path_factory):
    out = tmp_path_factory.mktemp("geos")
    subprocess.run([sys.executable, str(ROOT / "scripts" / "make_golden_geometries.py"),
                    str(out)], check=True, capture_output=True)
    return out


@pytest.mark.parametrize("n", [5, 8])
def test_route_leaves_the_per_step_buffers(tmp_path, geos, n):
    """A golden row's chunk through the resident chunk (``resident_route``,
    the card's checks and timings of the kernel in a run) leaves
    ``(sim.f, sim._spare)`` as the run's per-step chunk does - swapped after
    an odd chunk, in place after an even one - with the same fields bit for
    bit: one chunk call, ``n`` plain steps."""
    runs = {}
    for resident in (True, False):
        sim = golden_sim(tmp_path, f"bufs_{resident}_{n}", geos)
        if resident:
            resident_route(sim)
        sim.sim_init()
        start = (sim.f, sim._spare)
        sim._advance(n)
        swapped = sim.f is start[1] and sim._spare is start[0]
        same = sim.f is start[0] and sim._spare is start[1]
        runs[resident] = (swapped, same, sim.f.clone(), sim.rho.clone(), sim.u.clone())
        assert sim._step.plain_calls == n
        if resident:
            assert sim.resident.plain_calls == 1
    assert runs[True][:2] == runs[False][:2] == ((True, False) if n % 2 else (False, True))
    for a, b in zip(runs[True][2:], runs[False][2:]):
        assert torch.equal(a, b)
