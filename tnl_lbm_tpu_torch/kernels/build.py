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
SOURCES = ("aa_even.cu", "aa_odd.cu", "aa_pair.cu", "aa_pair_full.cu", "ab_step.cu",
           "ab_step_sitemajor.cu", "ade_step.cu", "coll_clbm.cu", "coll_kbc.cu", "coll_srt.cu",
           "coupled_ab.cu", "coupled_aa.cu", "d2q9_step.cu", "f64_aa.cu", "f64_ab.cu",
           "f64_pair.cu", "halo_step.cu", "nn_coll_clbm.cu", "nn_coll_kbc.cu", "nn_coll_srt.cu",
           "nn_force.cu", "nn_step.cu", "nn_step_halo.cu", "pair_coll_clbm.cu",
           "pair_coll_kbc.cu", "pair_coll_srt.cu", "probes.cu")
HEADERS = ("lbm_site.cuh", "pair_march.cuh", "ade_site.cuh", "nn_site.cuh", "collisions.cuh",
           "coll_step.cuh", "nn_coll.cuh", "pair_coll.cuh")
#: the C entries of the collision families, per kernel: the per-step kernels
#: (B4, B2, B3; ``coll_step.cuh``), the one-kernel NN step (B10; ``nn_coll.cuh``)
#: and the full-set pair (B1b; ``pair_coll.cuh``)
FAMILIES = ("srt", "clbm", "kbc")
COLL_ENTRIES = tuple(f"tnl_lbm_coll_{fam}" for fam in FAMILIES)
NN_COLL_ENTRIES = tuple(f"tnl_lbm_nn_coll_{fam}" for fam in FAMILIES)
PAIR_COLL_ENTRIES = tuple(f"tnl_lbm_pair_coll_{fam}" for fam in FAMILIES)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: flags of one source beside NVCC_FLAGS: the D2Q9 step and its resident
#: chunk share one site update, compiled without multiply-add contraction so
#: that both round every product and sum alike (bit-equal chunks)
SOURCE_FLAGS = {"d2q9_step.cu": ("-fmad=false",)}

_LIBRARY: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin (needs the CUDA toolkit)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
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
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src, ()), "-c", "-o",
                                       obj, str(CSRC / src)],
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
    d = ctypes.c_double
    lib.tnl_lbm_aa_even.argtypes = [p] * 5 + [i] * 5 + [f] * 7 + [i, p]
    lib.tnl_lbm_aa_odd.argtypes = [p] * 6 + [i] * 7 + [f] * 7 + [i, p]
    lib.tnl_lbm_aa_pair.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, f, f, f, i, p]
    lib.tnl_lbm_aa_pair_segmented.argtypes = [p] * 5 + [i] * 7 + [f] * 4 + [i, i, p]
    lib.tnl_lbm_aa_pair_info.argtypes = [i, i, i, i, p]
    lib.tnl_lbm_aa_pair_full.argtypes = [p] * 5 + [i] * 7 + [f] * 7 + [i, i, p]
    lib.tnl_lbm_aa_pair_full_info.argtypes = [i, i, i, i, p]
    lib.tnl_lbm_ab_step.argtypes = [p] * 6 + [i] * 6 + [f] * 7 + [i, p]
    lib.tnl_lbm_ab_step_sitemajor.argtypes = [p] * 5 + [i] * 5 + [f] * 7 + [i, p]
    lib.tnl_lbm_ab_step_well.argtypes = [p] * 5 + [i] * 4 + [f] * 7 + [p] + [ll] * 4 + [i, p]
    # the float64 instances (f64_*.cu): every real argument a C double
    lib.tnl_lbm_ab_step_f64.argtypes = [p] * 5 + [i] * 4 + [d] * 7 + [p] + [ll] * 4 + [i, p]
    lib.tnl_lbm_aa_even_f64.argtypes = [p] * 4 + [i] * 3 + [d] * 7 + [i, p]
    lib.tnl_lbm_aa_odd_f64.argtypes = [p] * 5 + [i] * 6 + [d] * 7 + [i, p]
    lib.tnl_lbm_aa_pair_f64.argtypes = [p] * 5 + [i] * 6 + [d] * 4 + [i, i, p]
    lib.tnl_lbm_aa_pair_f64_info.argtypes = [i, i, i, p]
    # the sharded lattice's haloed steps (halo_step.cu; f64_ab.cu's float64 one)
    lib.tnl_lbm_ab_step_halo.argtypes = [p] * 6 + [i] * 6 + [f] * 7 + [i, p]
    lib.tnl_lbm_aa_odd_halo.argtypes = [p] * 6 + [i] * 8 + [f] * 7 + [i, p]
    lib.tnl_lbm_ab_step_f64_halo.argtypes = [p] * 5 + [i] * 4 + [d] * 7 + [i, p]
    lib.tnl_lbm_aa_odd_halo_f64.argtypes = [p] * 5 + [i] * 7 + [d] * 7 + [i, p]
    lib.tnl_lbm_aa_pair_halo.argtypes = [p] * 5 + [i] * 8 + [f] * 4 + [i, i, p]
    lib.tnl_lbm_aa_pair_f64_halo.argtypes = [p] * 5 + [i] * 7 + [d] * 4 + [i, i, p]
    lib.tnl_lbm_aa_pair_full_halo.argtypes = [p] * 5 + [i] * 8 + [f] * 7 + [i, i, p]
    families = ((COLL_ENTRIES, [i] * 5 + [p] * 6 + [i] * 5 + [f] * 7 + [i, p]),
                (NN_COLL_ENTRIES, [i] * 4 + [p] * 5 + [i] * 6 + [f] * 7 + [i, i] + [f] * 6 + [p]),
                (PAIR_COLL_ENTRIES, [i] * 3 + [p] * 5 + [i] * 6 + [f] * 7 + [i, i, p]))
    for names, argtypes in families:
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = i
    lib.tnl_lbm_ade_step.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, f, f, f, p]
    lib.tnl_lbm_ade_step_halo.argtypes = [p] * 7 + [i] * 5 + [f] * 3 + [p]
    lib.tnl_lbm_coupled_ab.argtypes = [p] * 11 + [i] * 7 + [f] * 7 + [i] + [f] * 3 + [p]
    lib.tnl_lbm_coupled_aa.argtypes = [p] * 10 + [i] * 10 + [f] * 7 + [i] + [f] * 2 + [p]
    lib.tnl_lbm_d2q9_step.argtypes = [p] * 6 + [ll] * 3 + [p, p] + [i] * 4 + [f] * 5 + [p]
    lib.tnl_lbm_d2q9_step_halo.argtypes = [p] * 6 + [ll] * 3 + [p, p] + [i] * 3 + [f] * 5 + [p]
    lib.tnl_lbm_d2q9_chunk.argtypes = [p] * 5 + [ll] * 3 + [p, p] + [i] * 4 + [f] * 5 + [i, p]
    lib.tnl_lbm_d2q9_chunk_info.argtypes = [i, i, i, p]
    lib.tnl_lbm_nn_force.argtypes = [p] * 4 + [i] * 5 + [f] * 7 + [p]
    lib.tnl_lbm_nn_step.argtypes = [p] * 5 + [i] * 8 + [f] * 7 + [i, i] + [f] * 6 + [p]
    lib.tnl_lbm_nn_info.argtypes = [i, i, i, i, p]
    # the sharded lattice's NN kernels (nn_force.cu's B9 halo, nn_step_halo.cu's B10 halo)
    lib.tnl_lbm_nn_force_halo.argtypes = [p] * 4 + [i] * 6 + [f] * 7 + [p]
    lib.tnl_lbm_nn_step_halo.argtypes = [p] * 5 + [i] * 9 + [f] * 7 + [i, i] + [f] * 6 + [p]
    lib.tnl_lbm_copy_permute.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.tnl_lbm_pair_pipeline.argtypes = [p, p] + [i] * 6 + [p]
    lib.tnl_lbm_pair_pipeline_info.argtypes = [i, i, i, i, p]
    lib.tnl_lbm_pair_compute_only.argtypes = [p, p, i, i, i, i, p]
    lib.tnl_lbm_pair_compute_only_info.argtypes = [i, i, i, p]
    lib.tnl_lbm_aa_pair_smem_bytes.argtypes = []
    lib.tnl_lbm_element_pipeline.argtypes = [p, p] + [i] * 8 + [p]
    lib.tnl_lbm_window_copy.argtypes = [p, p] + [i] * 7 + [p]
    lib.tnl_lbm_window_copy_stages.argtypes = [i, i, i]
    for fn in (lib.tnl_lbm_aa_even, lib.tnl_lbm_aa_odd, lib.tnl_lbm_aa_pair,
               lib.tnl_lbm_aa_pair_segmented, lib.tnl_lbm_aa_pair_info,
               lib.tnl_lbm_window_copy_stages,
               lib.tnl_lbm_aa_pair_full, lib.tnl_lbm_aa_pair_full_info, lib.tnl_lbm_ab_step,
               lib.tnl_lbm_ab_step_sitemajor, lib.tnl_lbm_ab_step_well,
               lib.tnl_lbm_ab_step_f64, lib.tnl_lbm_aa_even_f64, lib.tnl_lbm_aa_odd_f64,
               lib.tnl_lbm_aa_pair_f64, lib.tnl_lbm_aa_pair_f64_info, lib.tnl_lbm_element_pipeline,
               lib.tnl_lbm_ab_step_halo, lib.tnl_lbm_aa_odd_halo, lib.tnl_lbm_ab_step_f64_halo,
               lib.tnl_lbm_window_copy,
               lib.tnl_lbm_ade_step, lib.tnl_lbm_ade_step_halo, lib.tnl_lbm_coupled_ab,
               lib.tnl_lbm_coupled_aa, lib.tnl_lbm_d2q9_step, lib.tnl_lbm_d2q9_step_halo,
               lib.tnl_lbm_d2q9_chunk, lib.tnl_lbm_d2q9_chunk_info,
               lib.tnl_lbm_nn_force, lib.tnl_lbm_nn_step,
               lib.tnl_lbm_nn_info, lib.tnl_lbm_nn_force_halo, lib.tnl_lbm_nn_step_halo,
               lib.tnl_lbm_copy_permute,
               lib.tnl_lbm_pair_pipeline, lib.tnl_lbm_pair_pipeline_info,
               lib.tnl_lbm_pair_compute_only, lib.tnl_lbm_pair_compute_only_info,
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
