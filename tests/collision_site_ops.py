"""The FP32 work one fluid site of the per-step kernels does under each
collision id of ``csrc/coll_*.cu``, for the operations bound of
``chip_smoke.py``.

The family kernels (``coll_step.cuh``) carry the whole boundary switch,
built once per equilibrium kind (``EQ_DYN``), and KBC's four shear-part
branches, chosen at run time; their SASS counts every branch once.  The
work a FLUID site does under one id is less: its moments and its
collision, with the id's KBC bits fixed.  ``source`` writes one kernel per
id of that work alone (``site_ops_<id>_kernel``: the 27 DFs read, the
moments as ``moments_local`` takes them, the collision of the id's family
kernel with ``CollParams::kbc`` a constant, the DFs and moments written),
``start`` compiles it to a cubin beside the kernel library (one ``nvcc``
with the library's flags), ``finish`` returns its ``cuobjdump -sass``
listing.  Needs nvcc; ``source`` runs anywhere.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from tnl_lbm_tpu_torch.kernels.build import CSRC, NVCC_FLAGS, _nvcc  # noqa: E402
from tnl_lbm_tpu_torch.kernels.fused import COLLISION_INSTANCES  # noqa: E402

#: the family sources and their COLL_KERNELS(tag, collision type, WELL) lines
FAMILY_SOURCES = ("coll_srt.cu", "coll_clbm.cu", "coll_kbc.cu")
_COLL_KERNELS = re.compile(r"^COLL_KERNELS\((\w+),\s*(.+?),\s*(true|false)\)", re.M)


def tag(cid: str) -> str:
    """The family kernels' name tag of a collision id (``ab_step_<tag>_kernel``)."""
    return "kbc" if cid.startswith("KBC") else cid.lower()


def family_types() -> dict:
    """tag -> (C++ collision type, WELL) as the family sources instantiate them."""
    out = {}
    for src in FAMILY_SOURCES:
        for t, ctype, well in _COLL_KERNELS.findall((CSRC / src).read_text()):
            out[t] = (ctype, well == "true")
    return out


def kernel_name(cid: str) -> str:
    return f"site_ops_{cid.lower()}_kernel"


def source(neumaier: bool = False) -> str:
    """One kernel per id of ``COLLISION_INSTANCES``: a FLUID site's moments
    (the compensated sum where ``neumaier``) and collision."""
    types = family_types()
    lines = [
        '#include "collisions.cuh"',
        "",
        "template <bool WELL, int KBC, class C>",
        "__device__ __forceinline__ void fluid_site(const float* __restrict__ f,",
        "    float* __restrict__ fout, float* __restrict__ rho, float* __restrict__ u,",
        "    lbm::CollParams p) {",
        "  const int64_t N = (int64_t)gridDim.x * blockDim.x;",
        "  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;",
        "  float v[lbm::Q];",
        "#pragma unroll",
        "  for (int q = 0; q < lbm::Q; ++q) v[q] = f[q * N + s];",
        "  p.kbc = KBC;",
        "  float r, ux, uy, uz;",
        f"  lbm::moments_local<WELL>(v, p.fx, p.fy, p.fz, {str(neumaier).lower()}, r, ux, uy, uz);",
        "  C::collide(v, r == 0.0f ? 1.0f : r, ux, uy, uz, p);",
        "#pragma unroll",
        "  for (int q = 0; q < lbm::Q; ++q) fout[q * N + s] = v[q];",
        "  rho[s] = r;",
        "  u[s] = ux;",
        "  u[N + s] = uy;",
        "  u[2 * N + s] = uz;",
        "}",
    ]
    for cid, (_, _, kbc) in COLLISION_INSTANCES.items():
        ctype, well = types[tag(cid)]
        lines += ["",
                  f'extern "C" __global__ void {kernel_name(cid)}(const float* f, float* fout,',
                  "    float* rho, float* u, lbm::CollParams p) {",
                  f"  fluid_site<{str(well).lower()}, {kbc}, {ctype}>(f, fout, rho, u, p);",
                  "}"]
    return "\n".join(lines) + "\n"


def start(out: Path, neumaier: bool = False) -> tuple:
    """Write ``source`` into ``out`` and start its nvcc: (cubin, process)."""
    out.mkdir(parents=True, exist_ok=True)
    src, cubin = out / "site_ops.cu", out / "site_ops.cubin"
    src.write_text(source(neumaier))
    flags = [f for f in NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    proc = subprocess.Popen([_nvcc(), *flags, "-I", str(CSRC), "-cubin", "-o", str(cubin),
                             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return cubin, proc


def finish(started: tuple) -> str:
    """Wait for ``start``'s nvcc: the cubin's ``cuobjdump -sass`` listing."""
    import os

    cubin, proc = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {cubin.with_suffix('.cu')}:\n{log}")
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    exe = shutil.which("cuobjdump") or os.path.join(cuda_home, "bin", "cuobjdump")
    return subprocess.run([exe, "-sass", str(cubin)], capture_output=True, text=True,
                          check=True).stdout
