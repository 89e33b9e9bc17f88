"""The port imports no jax and nothing of the JAX package, its descriptors
equal the JAX package's, and its build module stays inert until called."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in (ROOT / "tnl_lbm_tpu_torch").rglob("*.py")
    if p.name != "__init__.py"
)


def test_every_port_module_is_listed():
    for name in ("tnl_lbm_tpu_torch.apps.sim_2", "tnl_lbm_tpu_torch.kernels.fused_aa",
                 "tnl_lbm_tpu_torch.kernels.build", "tnl_lbm_tpu_torch.sim.state",
                 "tnl_lbm_tpu_torch.interop", "tnl_lbm_tpu_torch.sim.coupled",
                 "tnl_lbm_tpu_torch.sim.step_ade", "tnl_lbm_tpu_torch.kernels.fused_ade",
                 "tnl_lbm_tpu_torch.kernels.fused_coupled", "tnl_lbm_tpu_torch.ops.collision_ade",
                 "tnl_lbm_tpu_torch.apps.sim_coupled", "tnl_lbm_tpu_torch.models.descriptors",
                 "tnl_lbm_tpu_torch.ops.collision_2d", "tnl_lbm_tpu_torch.io.geometry",
                 "tnl_lbm_tpu_torch.kernels.fused_2d", "tnl_lbm_tpu_torch.apps.sim2d_1",
                 "tnl_lbm_tpu_torch.apps.sim2d_2", "tnl_lbm_tpu_torch.apps.sim2d_3",
                 "tnl_lbm_tpu_torch.ops.non_newtonian", "tnl_lbm_tpu_torch.kernels.fused_nn",
                 "tnl_lbm_tpu_torch.kernels.fused_nn_step", "tnl_lbm_tpu_torch.kernels.hooked",
                 "tnl_lbm_tpu_torch.bench", "tnl_lbm_tpu_torch.kernels.probes",
                 "tnl_lbm_tpu_torch.io.native", "tnl_lbm_tpu_torch.sim.checkpoint",
                 "tnl_lbm_tpu_torch.ibm.lagrange", "tnl_lbm_tpu_torch.ibm.sparse",
                 "tnl_lbm_tpu_torch.ibm.dirac", "tnl_lbm_tpu_torch.ibm.generators",
                 "tnl_lbm_tpu_torch.apps.sim_ibm", "tnl_lbm_tpu_torch.ibm_tables",
                 "tnl_lbm_tpu_torch.parallel.sharded", "tnl_lbm_tpu_torch.parallel.halo",
                 "tnl_lbm_tpu_torch.parallel.profiling"):
        assert name in PORT_MODULES


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "ref = sorted(m for m in sys.modules if m == 'tnl_lbm_tpu' or m.startswith('tnl_lbm_tpu.'))\n"
        "assert not ref, ref\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("name", ["D3Q27", "D2Q9", "D3Q7"])
def test_port_descriptors_equal_jax(name):
    """Field by field: the direction order, c, w (bit for bit), opp,
    1/cs^2 and the mirrors; ``interop.port_lattice`` maps the JAX
    descriptor to the port's own."""
    import numpy as np

    from tnl_lbm_tpu import models as jmodels
    from tnl_lbm_tpu_torch import interop, models

    mine, ref = getattr(models, name), getattr(jmodels, name)
    assert mine is not ref and mine.name == ref.name
    assert (mine.D, mine.Q, mine.names, mine.i_cs2) == (ref.D, ref.Q, ref.names, ref.i_cs2)
    for field in ("c", "w", "opp"):
        got, want = getattr(mine, field), getattr(ref, field)
        assert got.dtype == want.dtype and np.array_equal(got, want), field
        assert not got.flags.writeable
    for axis in range(mine.D):
        assert np.array_equal(mine.mirror(axis), ref.mirror(axis))
    assert all(mine.idx(n) == ref.idx(n) for n in ref.names)
    assert interop.port_lattice(ref) is mine and interop.port_lattice(mine) is mine
    dom = interop.domain_from_numpy(np.zeros((2,) * mine.D, np.uint8), (False,) * mine.D, lat=ref)
    assert dom.lat is mine


def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    """chip_smoke.py exits non-zero and prints no result with no card, and
    when copied alone into a directory without the repository."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusals")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
