"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` - one process per source, all
started together - and linked into one shared library with a plain C
interface, loaded with ``ctypes``: seconds per build, against minutes for a
source that includes PyTorch's headers.  The library is built at first use
into ``build/torch_kernels/`` under the repository root, named by a hash of
the sources and flags, so an edited source never loads a stale build.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("aa_even.cu", "aa_odd.cu", "aa_pair.cu", "aa_pair_pad.cu", "ab_step.cu",
           "ab_step_sitemajor.cu", "ade_step.cu", "coupled_ab.cu", "coupled_aa.cu",
           "d2q9_step.cu", "nn_force.cu", "nn_step.cu", "probes.cu")
HEADERS = ("lbm_site.cuh", "pair_window.cuh", "ade_site.cuh", "nn_site.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBRARY: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin (needs the CUDA toolkit)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_library() -> tuple[Path, str]:
    """Compile the kernels if this source state has no build yet.

    Returns the library path and the compiler's ``-Xptxas -v`` report (read
    back from the log of the build that produced the library).
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _digest()
    lib = BUILD_DIR / f"libtnl_lbm_kernels_{tag}.so"
    log = BUILD_DIR / f"libtnl_lbm_kernels_{tag}.log"
    if not lib.exists():
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            objs = [os.path.join(tmpdir, src + ".o") for src in SOURCES]
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
                     for src, obj in zip(SOURCES, objs)]
            report = []
            for src, proc in zip(SOURCES, procs):
                out, _ = proc.communicate()
                report.append((src, proc.returncode, out))
            failed = [f"{src} ({rc}):\n{out}" for src, rc, out in report if rc != 0]
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
            tmp = os.path.join(tmpdir, lib.name)
            link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True,
                                  text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                                   f"{link.stdout}{link.stderr}")
            log.write_text("".join(out for _, _, out in report))
            os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib, log.read_text() if log.exists() else ""


def load_library() -> ctypes.CDLL:
    """The loaded kernel library with its C entry points typed."""
    lib = _LIBRARY.get("lib")
    if lib is not None:
        return lib
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.tnl_lbm_aa_even.argtypes = [p] * 5 + [i] * 5 + [f] * 7 + [i, p]
    lib.tnl_lbm_aa_odd.argtypes = [p] * 6 + [i] * 7 + [f] * 7 + [i, p]
    lib.tnl_lbm_aa_pair.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, f, f, f, i, p]
    lib.tnl_lbm_aa_pair_pad_even.argtypes = [p] * 3 + [i] * 5 + [f] * 7 + [i, p]
    lib.tnl_lbm_aa_pair_pad_odd.argtypes = [p] * 5 + [i] * 6 + [f] * 7 + [i, p]
    lib.tnl_lbm_ab_step.argtypes = [p] * 6 + [i] * 6 + [f] * 7 + [i, p]
    lib.tnl_lbm_ab_step_sitemajor.argtypes = [p] * 5 + [i] * 5 + [f] * 7 + [i, p]
    lib.tnl_lbm_ade_step.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, f, f, f, p]
    lib.tnl_lbm_coupled_ab.argtypes = [p] * 11 + [i] * 7 + [f] * 7 + [i] + [f] * 3 + [p]
    lib.tnl_lbm_coupled_aa.argtypes = [p] * 10 + [i] * 10 + [f] * 7 + [i] + [f] * 2 + [p]
    lib.tnl_lbm_d2q9_step.argtypes = [p] * 6 + [ll] * 3 + [p, p] + [i] * 4 + [f] * 5 + [p]
    lib.tnl_lbm_nn_force.argtypes = [p] * 4 + [i] * 5 + [f] * 7 + [p]
    lib.tnl_lbm_nn_step.argtypes = [p] * 5 + [i] * 8 + [f] * 7 + [i, i] + [f] * 6 + [p]
    lib.tnl_lbm_nn_step_smem_bytes.argtypes = []
    lib.tnl_lbm_copy_permute.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.tnl_lbm_pair_pipeline.argtypes = [p, p, i, i, i, i, i, p]
    lib.tnl_lbm_pair_compute_only.argtypes = [p, p, i, i, i, i, p]
    lib.tnl_lbm_aa_pair_smem_bytes.argtypes = []
    lib.tnl_lbm_element_pipeline.argtypes = [p, p] + [i] * 7 + [p]
    lib.tnl_lbm_window_copy.argtypes = [p, p] + [i] * 7 + [p]
    for fn in (lib.tnl_lbm_aa_even, lib.tnl_lbm_aa_odd, lib.tnl_lbm_aa_pair,
               lib.tnl_lbm_aa_pair_pad_even, lib.tnl_lbm_aa_pair_pad_odd, lib.tnl_lbm_ab_step,
               lib.tnl_lbm_ab_step_sitemajor, lib.tnl_lbm_element_pipeline,
               lib.tnl_lbm_window_copy,
               lib.tnl_lbm_ade_step, lib.tnl_lbm_coupled_ab, lib.tnl_lbm_coupled_aa,
               lib.tnl_lbm_d2q9_step, lib.tnl_lbm_nn_force, lib.tnl_lbm_nn_step,
               lib.tnl_lbm_nn_step_smem_bytes, lib.tnl_lbm_copy_permute,
               lib.tnl_lbm_pair_pipeline, lib.tnl_lbm_pair_compute_only,
               lib.tnl_lbm_aa_pair_smem_bytes):
        fn.restype = i
    _LIBRARY["lib"] = lib
    return lib


def kernel_resources(ptxas_log: str) -> dict:
    """Registers, spill bytes and shared memory per kernel from ``-Xptxas -v``."""
    out: dict = {}
    current = None
    for line in ptxas_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([A-Za-z_]\w*)'?", line)
        if m:
            current = out.setdefault(m.group(1), {"smem": 0})  # ptxas omits a zero smem
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            current["smem"] = int(m.group(1))
    return out
