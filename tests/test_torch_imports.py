"""The port imports no jax, and its build module stays inert until called."""

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
                 "tnl_lbm_tpu_torch.interop"):
        assert name in PORT_MODULES


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


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
