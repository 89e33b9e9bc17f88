"""The one-kernel A-A pair of ``tnl_lbm_tpu_torch.kernels.fused_aa`` on the CPU.

On CPU tensors the pair runs its plain version, the odd step of the even
step (``FusedPairAA.plain``).  It is held against two JAX ``make_step``
A-A steps (and, under ``-m slow``, the JAX ``make_fused_pair2_aa`` in
interpret mode) at the JAX kernel suite's bounds, |df| < 1e-6,
|drho| < 2e-6, |du| < 1e-6; with half storage against the JAX pair in
interpret mode, within one unit in the last place of the store dtype.
Then the pair dispatch of ``Simulation`` and sim_2's ``--storage``, and
the window rule of ``csrc/aa_pair.cu`` transliterated into numpy.
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
from tnl_lbm_tpu_torch.apps import sim_2
from tnl_lbm_tpu_torch.kernels.fused_aa import (
    PAIR_TILE,
    from_storage,
    make_fused_pair2_aa,
    make_fused_step_aa,
    to_storage,
)
from tnl_lbm_tpu_torch.ops import streaming as pstream
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim import make_step
from tnl_lbm_tpu_torch.sim.config import LBMConfig
from tnl_lbm_tpu_torch.sim.state import Simulation, needs_per_step_state

from tnl_lbm_tpu_torch.utils.dtypes import state_agrees

from test_torch_step import FORCE, NU, geometry, jax_side, rand_f, spec

CSRC = Path(__file__).resolve().parents[1] / "tnl_lbm_tpu_torch" / "csrc"
HALF = {"f16": (torch.float16, jnp.float16), "bf16": (torch.bfloat16, jnp.bfloat16)}


def port_pair(kind, **kw):
    m, periodic = geometry(kind)
    return make_fused_pair2_aa(interop.config_from_spec(**spec("AA")),
                               interop.domain_from_numpy(m, periodic), "cpu", **kw)


def assert_close(fj, rj, uj, fp, rp, up, what):
    assert np.abs(np.asarray(fj) - fp.numpy()).max() < 1e-6, f"f, {what}"
    assert np.abs(np.asarray(rj) - rp.numpy()).max() < 2e-6, f"rho, {what}"
    assert np.abs(np.asarray(uj) - up.numpy()).max() < 1e-6, f"u, {what}"


@pytest.mark.parametrize("kind", ["duct", "torus"])
def test_plain_pair_matches_two_jax_steps(kind):
    m, periodic = geometry(kind)
    jcfg, jdom = jax_side(spec("AA"), m, periodic)
    jstep = j_make_step(jcfg, jdom)
    pair = port_pair(kind)
    f0 = rand_f(jcfg, seed=5)
    fj, fp = jnp.asarray(f0), interop.state_from_numpy(f0, "cpu")
    for it in range(2):
        for parity in (0, 1):
            fj, rj, uj = jstep(fj, NU, force=jnp.asarray(FORCE, jnp.float32), parity=parity)
        fp, rp, up = pair(fp, NU, force=FORCE)
        assert_close(fj, rj, uj, fp, rp, up, f"pair {it}")
    assert pair.plain_calls == 2 and pair.kernel.launches == 0
    assert np.abs(fp.numpy() - f0).max() > 1e-5  # the state moved


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["duct", "torus"])
def test_plain_pair_matches_jax_pair2_interpret(kind):
    from tnl_lbm_tpu.kernels.fused_aa import from_padded_aa, to_padded_aa
    from tnl_lbm_tpu.kernels.fused_aa import make_fused_pair2_aa as j_make_pair2

    m, periodic = geometry(kind)
    jcfg, jdom = jax_side(spec("AA"), m, periodic)
    jpair = j_make_pair2(jcfg, jdom, tile=(4, 8))
    pair = port_pair(kind)
    f0 = rand_f(jcfg, seed=5)
    fj, fp = to_padded_aa(jnp.asarray(f0), periodic), interop.state_from_numpy(f0, "cpu")
    for it in range(2):
        fj, rj, uj = jpair(fj, NU, force=jnp.asarray(FORCE, jnp.float32))
        fp, rp, up = pair(fp, NU, force=FORCE)
        assert_close(from_padded_aa(fj, m.shape[-1]), rj, uj, fp, rp, up, f"pair {it}")


def _variant_case():
    """The JAX half-storage test's case (tests/test_fused_kernel.py:681):
    its 8x32x8 duct with a NOTHING site and its seed-23 state."""
    from test_fused_kernel import _variant_domain
    from test_fused_kernel import rand_f as j_rand_f
    from tnl_lbm_tpu.ops import collision as jcol
    from tnl_lbm_tpu.ops import equilibrium as jeq
    from tnl_lbm_tpu.sim import LBMConfig as JConfig

    jdom = _variant_domain()
    jcfg = JConfig(lat=D3Q27, collision=jcol.collide_cum_well, eq=jeq.eq_well, well=True,
                   streaming="AA")
    return jcfg, jdom, np.asarray(j_rand_f(jdom, jcfg, seed=23))


@pytest.mark.parametrize("store", ["f16", "bf16"])
def test_half_pair_matches_jax_pair2_interpret(store):
    from tnl_lbm_tpu.kernels.fused_aa import from_padded_aa, to_padded_aa
    from tnl_lbm_tpu.kernels.fused_aa import make_fused_pair2_aa as j_make_pair2

    tdt, jdt = HALF[store]
    jcfg, jdom, f0 = _variant_case()
    force = np.array([1e-5, 0.0, 0.0])
    jpair = j_make_pair2(jcfg, jdom, tile=(4, 8), store_dtype=jdt)
    fj, rj, uj = jpair(to_padded_aa(jnp.asarray(f0), jdom.periodic, store_dtype=jdt), 0.02,
                       force=jnp.asarray(force, jnp.float32))
    pair = make_fused_pair2_aa(interop.config_from_spec(**spec("AA")),
                               interop.domain_from_numpy(jdom.map, jdom.periodic), "cpu",
                               store_dtype=tdt)
    fp, rp, up = pair(to_storage(interop.state_from_numpy(f0, "cpu"), tdt), 0.02, force=force)
    assert fp.dtype == tdt and rp.dtype == up.dtype == torch.float32
    fj32 = torch.from_numpy(np.asarray(from_padded_aa(fj, jdom.shape[-1]), np.float32))
    assert state_agrees(fj32.to(tdt), fp, tdt)
    assert np.abs(np.asarray(rj) - rp.numpy()).max() < 2e-6
    assert np.abs(np.asarray(uj) - up.numpy()).max() < 1e-6


@pytest.mark.parametrize("store", ["f16", "bf16"])
def test_half_storage_properties(store):
    """As the JAX suite's test_pair2_half_storage_accuracy: the state stays
    narrow, rho and u stay wide, NOTHING sites keep their bits, and the
    velocity stays within the storage-rounding envelope of float32."""
    tdt, _ = HALF[store]
    _, jdom, f0 = _variant_case()
    dom = interop.domain_from_numpy(jdom.map, jdom.periodic)
    cfg = interop.config_from_spec(**spec("AA"))
    full = make_fused_pair2_aa(cfg, dom, "cpu")
    half = make_fused_pair2_aa(cfg, dom, "cpu", store_dtype=tdt)
    assert half.store_dtype == tdt and half.kernel.name == f"aa_pair_{store}"
    start = interop.state_from_numpy(f0, "cpu")
    f32, fh = start, to_storage(start, tdt)
    for _ in range(3):
        f32, _, u32 = full(f32, 0.02, force=FORCE)
        fh, rh, uh = half(fh, 0.02, force=FORCE)
    assert fh.dtype == tdt and rh.dtype == uh.dtype == torch.float32
    du = float((uh.double() - u32.double()).abs().max())
    assert torch.isfinite(uh).all() and 0 < du < {"f16": 2e-3, "bf16": 2e-2}[store]
    assert torch.equal(fh[:, 2, 2, 2], to_storage(start[:, 2, 2, 2], tdt))
    # the conditioning guard: raw (non-well) DFs refuse half storage
    raw = interop.config_from_spec("CUM", "EQ", False, "AA")
    with pytest.raises(ValueError, match="well"):
        make_fused_pair2_aa(raw, dom, "cpu", store_dtype=tdt)
    with pytest.raises(ValueError, match="well"):
        LBMConfig(lat=raw.lat, collision=raw.collision, streaming="AA", storage_dtype=tdt)


def test_storage_round_trip_rounds_to_nearest_even():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(1000).astype(np.float32) * 1e-3)
    assert to_storage(x, None) is x and from_storage(x, torch.float32) is x
    h = to_storage(x, torch.float16)
    np.testing.assert_array_equal(h.numpy(), x.numpy().astype(np.float16))
    assert from_storage(h, torch.float32).dtype == torch.float32


@pytest.mark.parametrize("store", ["f16", "bf16"])
def test_state_agrees_refuses_a_truncating_narrowing(store):
    """The half-storage bound accepts round-to-nearest-even of float32
    values that differ by 1e-9 here and there, and refuses rounding toward
    zero, which also stays within one ulp everywhere."""
    tdt, _ = HALF[store]
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.standard_normal(100_000) * 1e-3).astype(np.float32))
    noisy = x + torch.from_numpy(np.where(rng.random(x.shape) < 1e-3, 1e-9, 0.0)).float()
    rn = x.to(tdt)
    rz = torch.where(rn.float().abs() > x.abs(), torch.nextafter(rn, torch.zeros_like(rn)), rn)
    assert state_agrees(noisy.to(tdt), rn, tdt)
    assert not state_agrees(rz, rn, tdt)
    assert not state_agrees(x, x + 2e-6, torch.float32) and state_agrees(x, x + 5e-7, torch.float32)


def test_pair_writes_into_out_and_refuses_bad_calls():
    pair = port_pair("duct")
    f = interop.state_from_numpy(rand_f(jax_side(spec("AA"), *geometry("duct"))[0]), "cpu")
    out = torch.empty_like(f)
    f_new, _, _ = pair(f, NU, force=FORCE, out=out)
    assert f_new is out and not torch.equal(out, f)
    with pytest.raises(ValueError):
        pair(f, NU, out=f)
    with pytest.raises(ValueError):
        pair(f.half(), NU)
    with pytest.raises(NotImplementedError, match="A8"):
        pair(f, NU, u_in=np.zeros((3, 1, 16, 8)))
    with pytest.raises(NotImplementedError, match="A13"):
        pair(f, NU, bflags=np.ones(6))
    for kw in ({"prepadded": True}, {"local_shape": (8, 16, 8)}, {"z_halo": 2}):
        with pytest.raises(NotImplementedError, match="A13"):
            port_pair("duct", **kw)
    with pytest.raises(TypeError):
        port_pair("duct", tile=(8, 32))
    with pytest.raises(ValueError):
        make_fused_pair2_aa(interop.config_from_spec(**spec("AB")),
                            interop.domain_from_numpy(*geometry("duct")), "cpu")
    nomacro = port_pair("duct", with_macro=False)
    assert nomacro(f, NU)[1:] == (None, None)


def test_per_step_steps_refuse_half_storage():
    m, periodic = geometry("duct")
    cfg = interop.config_from_spec(**spec("AA"), storage="float16")
    assert cfg.storage_dtype == torch.float16
    dom = interop.domain_from_numpy(m, periodic)
    for build in (lambda: make_step(cfg, dom), lambda: make_fused_step_aa(cfg, dom, "cpu")):
        with pytest.raises(NotImplementedError, match="pair dispatch"):
            build()
    assert make_fused_pair2_aa(cfg, dom, "cpu", store_dtype=cfg.storage_dtype)


def test_cuda_pair_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fused_pair2_aa(interop.config_from_spec(**spec("AA")),
                            interop.domain_from_numpy(*geometry("duct")), "cuda")


# ----------------------------------------------------------- Simulation


class Duct(Simulation):
    """The test duct with a body force, counting its step hooks."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.hook_calls = [0, 0]

    def body_force(self, phys_time):
        return FORCE

    def compute_before_step(self):
        self.hook_calls[0] += 1

    def compute_after_step(self):
        self.hook_calls[1] += 1


def make_sim(tmp_path, pair_dispatch, storage=None, cls=Duct, tag="sim"):
    m, periodic = geometry("duct")
    cfg = interop.config_from_spec(**spec("AA"), storage=storage)
    dom = interop.domain_from_numpy(m, periodic, phys_viscosity=NU)
    return cls(cfg, dom, device="cpu", sim_id=tag, results_parent=tmp_path,
               use_fused=True, pair_dispatch=pair_dispatch)


@pytest.mark.parametrize("chunks", [(7,), (3, 4)], ids=["from_even", "odd_start"])
def test_pair_dispatch_is_bit_identical_to_per_step(tmp_path, chunks):
    """(7,): three pairs and a leftover step; (3, 4): a pair and a
    leftover step, then a chunk that starts at an odd iteration and so runs
    per step."""
    sims = [make_sim(tmp_path, p, tag=str(p)) for p in (True, False)]
    for sim in sims:
        sim.sim_init()
        for n in chunks:
            sim._advance(n)
    paired, stepped = sims
    assert paired.pair_dispatch is True and stepped.pair_dispatch is False
    assert paired.iterations == stepped.iterations == 7
    for name in ("f", "rho", "u"):
        assert torch.equal(getattr(paired, name), getattr(stepped, name)), name
    n_pairs = 3 if chunks == (7,) else 1
    assert paired._pair.plain_calls == n_pairs and paired._pair.kernel.launches == 0
    assert paired._step.plain_calls == 7 - 2 * n_pairs
    assert stepped._pair is None and stepped._step.plain_calls == 7


def test_hooks_run_once_per_pair(tmp_path):
    paired, stepped = make_sim(tmp_path, True, tag="p"), make_sim(tmp_path, False, tag="s")
    for sim in (paired, stepped):
        sim.sim_init()
        sim._advance(6)
    assert paired.hook_calls == [3, 3] and stepped.hook_calls == [6, 6]
    assert paired.f is not None and paired.f.dtype == torch.float32


def test_needs_per_step_state_turns_pair_dispatch_off(tmp_path):
    class ReadsF(Duct):
        @needs_per_step_state
        def compute_after_step(self):
            assert self.f is not None

    sim = make_sim(tmp_path, True, cls=ReadsF)
    sim.sim_init()
    sim._advance(4)
    assert not sim._pair_dispatch_ok() and sim._pair is None
    assert sim._step.plain_calls == 4


def test_dispatch_chunks_do_not_rescan_the_map(tmp_path):
    """The pair-dispatch decision is made once at sim_init: a chunk must not
    scan the geometry map (np.unique over 16.7M sites at 256^3 cost more
    than the pair kernel itself)."""
    sim = make_sim(tmp_path, True)
    sim.sim_init()

    def scan():
        raise AssertionError("the geometry map was scanned during a dispatch chunk")

    sim.domain.codes_present = scan
    sim._advance(4)
    assert sim._pair.plain_calls == 2


def test_half_storage_forces_pair_dispatch(tmp_path):
    for pd in ("auto", True):
        sim = make_sim(tmp_path, pd, storage="bfloat16", tag=f"h{pd}")
        sim.sim_init()
        assert sim.pair_dispatch is True and sim._pair.store_dtype == torch.bfloat16
        sim._advance(2)
        assert sim.f.dtype == torch.float32 and sim._pair.plain_calls == 1
    sim = make_sim(tmp_path, False, storage="float16", tag="off")
    with pytest.raises(ValueError, match="pair"):
        sim.sim_init()


def test_auto_resolves_to_per_step_on_the_cpu(tmp_path):
    sim = make_sim(tmp_path, "auto")
    sim.sim_init()
    assert sim.pair_dispatch is False and sim.pair_probe_ms is None and sim._pair is None


def test_sim2_storage_runs_the_pair_path(tmp_path, capsys):
    sim = sim_2.main(["1", "--device", "cpu", "--storage", "f16", "--final-time", "0.05",
                      "--results-dir", str(tmp_path)])
    assert "final l1error_phys" in capsys.readouterr().out
    assert sim.cfg.streaming == "AA" and sim.use_fused and sim.pair_dispatch is True
    assert sim.cfg.storage_dtype == torch.float16 and sim.id.endswith("_store_f16")
    assert sim._pair.plain_calls * 2 == sim.iterations >= 10 and sim._step.plain_calls == 0
    assert sim.f.dtype == torch.float32 and torch.isfinite(sim.u).all()
    assert sim.error_history and np.isfinite(sim.last_errors).all()


# ------------------------------------------ window rule of csrc/aa_pair.cu


def _tile_constants():
    src = (CSRC / "pair_window.cuh").read_text()
    m = re.search(r"constexpr int TX = (\d+), TY = (\d+), TZ = (\d+);", src)
    return tuple(int(v) for v in m.groups())


def _neighbour(s, d, n, periodic):
    """Python transliteration of csrc/lbm_site.cuh neighbour."""
    t = s + d
    if periodic:
        return t + n if t < 0 else (t - n if t >= n else t)
    return 0 if t < 0 else (n - 1 if t >= n else t)


@pytest.mark.parametrize("periodic", [(True, True, True), (True, False, False),
                                      (False, False, False)], ids=["torus", "duct", "walls"])
def test_pair_window_equals_pad_halo(periodic):
    """Each block's window (its tile + a one-site halo, wrap or clamp per
    axis: csrc/pair_window.cuh window_site) is the matching slice of
    pad_halo, which the odd step reads; the masked tiles cover every site
    once on a shape no tile divides."""
    tile = _tile_constants()
    assert tile == PAIR_TILE
    shape = (tile[0] + 3, 2 * tile[1] + 1, tile[2] + 5)
    rng = np.random.default_rng(4)
    arr = rng.standard_normal((1,) + shape).astype(np.float32)
    padded = pstream.pad_halo(torch.from_numpy(arr), periodic)[0].numpy()
    covered = np.zeros(shape, np.int64)
    for b in itertools.product(*(range(-(-n // t)) for n, t in zip(shape, tile))):
        origin = [bi * t for bi, t in zip(b, tile)]
        valid = [min(t, n - o) for t, n, o in zip(tile, shape, origin)]
        win = np.full([v + 2 for v in valid], np.nan, np.float32)
        for lw in itertools.product(*(range(v + 2) for v in valid)):
            g = [_neighbour(o - 1, l, n, p) for o, l, n, p in zip(origin, lw, shape, periodic)]
            win[lw] = arr[(0,) + tuple(g)]
        want = padded[tuple(slice(o, o + v + 2) for o, v in zip(origin, valid))]
        np.testing.assert_array_equal(win, want)
        covered[tuple(slice(o, o + v) for o, v in zip(origin, valid))] += 1
    assert (covered == 1).all()
