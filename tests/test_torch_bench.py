"""The port's benchmark entry (``python -m tnl_lbm_tpu_torch.bench``) on the
CPU, and the device rules every entry point keeps: the apps default to
``--device cuda``, ``Simulation`` requires a device, and a CUDA device
without a card raises instead of falling back to the CPU."""

import inspect
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from tnl_lbm_tpu.ops import collision as jcol
from tnl_lbm_tpu.ops import equilibrium as jeq
from tnl_lbm_tpu_torch import bench
from tnl_lbm_tpu_torch.ops import collision as pcol
from tnl_lbm_tpu_torch.ops import equilibrium as peq
from tnl_lbm_tpu_torch.sim.state import Simulation

ROOT = Path(__file__).resolve().parents[1]
FIELDS = {"metric", "value", "unit", "device", "nvidia_smi", "bound_mlups", "share_of_bound",
          "launches", "plain_calls", "calls", "seconds"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_main(capsys, *argv):
    assert bench.main(["--device", "cpu", *argv]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_bench_pair2_on_cpu_prints_one_json_line(capsys, storage):
    rec = run_main(capsys, "--storage", storage)
    assert set(rec) == FIELDS and rec["unit"] == "MLUPS" and rec["device"] == "cpu"
    assert "one-kernel pair (B1)" in rec["metric"] and f"{storage} storage" in rec["metric"]
    # MLUPS as bench.py:204-205 counts it: sites x 2 steps per call x calls / time
    assert rec["calls"] == 10
    assert rec["value"] == pytest.approx(32 ** 3 * 2 * 10 / rec["seconds"] / 1e6)
    # no card: no device bound, the plain version ran for the warm pair and each call
    assert rec["bound_mlups"] is None and rec["share_of_bound"] is None
    assert rec["nvidia_smi"] is None and "vs_baseline" not in rec
    assert rec["launches"] == {f"aa_pair_{storage}": 0} and rec["plain_calls"] == 11


def test_bench_pair_runs_the_two_kernel_pair_plain_version(capsys, monkeypatch):
    """``--kernel pair`` runs B1b, one launch per pair on the card: here its
    plain version, once per pair, with its one launch counter at 0."""
    from tnl_lbm_tpu_torch.kernels.fused_aa import FusedPairAAFull

    calls = []
    plain = FusedPairAAFull.plain
    monkeypatch.setattr(FusedPairAAFull, "plain",
                        lambda self, *a, **k: calls.append(1) or plain(self, *a, **k))
    rec = run_main(capsys, "--kernel", "pair")
    assert "full-set pair (B1b)" in rec["metric"] and len(calls) == 11
    assert rec["launches"] == {"aa_pair_full": 0}
    assert rec["plain_calls"] == 11 and rec["value"] > 0


def test_bench_pair_is_f32_only_and_cuda_needs_a_card(capsys):
    with pytest.raises(ValueError, match="f32 only"):
        bench.main(["--device", "cpu", "--kernel", "pair", "--storage", "f16"])
    with pytest.raises(SystemExit):
        bench.main(["--kernel", "pair3"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])  # --device defaults to cuda
    assert capsys.readouterr().out == ""


def test_bench_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "tnl_lbm_tpu_torch.bench", "--device", "cpu"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1 and set(json.loads(lines[0])) == FIELDS


def test_flagship_is_the_graft_entry_duct():
    """The port's flagship duct is ``__graft_entry__._flagship``'s: the same
    map, periodicity and CUM_WELL with the well-conditioned equilibrium."""
    cfg, dom = bench.flagship((6, 5, 4))
    jcfg, jdom = graft._flagship((6, 5, 4))
    assert np.array_equal(dom.map, np.asarray(jdom.map)) and dom.periodic == jdom.periodic
    assert cfg.well and jcfg.well and cfg.streaming == "AA"
    assert jcfg.collision is jcol.collide_cum_well and jcfg.eq is jeq.eq_well
    assert cfg.collision is pcol.collide_cum_well and cfg.eq is peq.eq_well


def test_entry_points_default_to_the_card():
    """Every app's ``--device`` defaults to cuda, and ``Simulation`` and
    ``IBM`` take no default device: no entry point picks the CPU on its own."""
    from tnl_lbm_tpu_torch.ibm import IBM

    apps = sorted((ROOT / "tnl_lbm_tpu_torch" / "apps").glob("sim*.py"))
    assert len(apps) == 8
    for path in apps + [ROOT / "tnl_lbm_tpu_torch" / name for name in ("bench.py",
                                                                         "ibm_tables.py")]:
        src = path.read_text()
        assert re.search(r'add_argument\("--device", default="cuda"', src), path.name
    for cls in (Simulation, IBM):
        device = inspect.signature(cls.__init__).parameters["device"]
        assert device.kind is inspect.Parameter.KEYWORD_ONLY
        assert device.default is inspect.Parameter.empty
