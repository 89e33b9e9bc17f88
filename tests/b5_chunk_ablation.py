"""Where B5's resident chunk (``csrc/d2q9_step.cu``, ``FusedChunk2D``) spends
its time on small lattices.

    python tests/b5_chunk_ablation.py [--out DIR]

Builds variants of ``csrc/d2q9_step.cu`` by text substitution on this
checkout's source (one ``nvcc`` each, all started together, into
``build/b5_chunk_ablation/`` or ``--out``) and times each on CUDA events,
every variant in the same process, on sim2d_3's channel at resolution 1
(128 x 32, geometry 1's disk in a Bouzidi ring, the inflow profile; the
golden sweep's lattice) and 2 (256 x 64), at resolution 1 without the
thetas and as a box periodic in x and y (``tests/torch_cases.py``
``resident_case_2d``), CLBM, in chunks of 20 and 200 steps (ms per step):

- the kernel;
- ``sync_floor``: the site update taken out (each step copies the site's
  DFs from one buffer to the other): the band loaded, the cluster
  barriers, the state stored;
- ``cluster_8``, ``cluster_4``: clusters of 8 and 4 blocks in place of 16
  (each block's band twice or four times as deep);
- ``full_barrier``: one ``cluster.sync()`` after each whole step, in place
  of the arrival after the edge rows and the wait after the interior rows;
- ``no_dsmem``: every row read from the block's own shared memory (the
  neighbouring bands' rows are not read remotely);
- ``block_sync``: no DSMEM and no cluster barrier in the steps (only the
  block's own ``__syncthreads()``): the site work alone;
- ``no_collision``: the site update without its collision;
- ``no_bouzidi``: the ring sites without their interpolation (and thetas);
- ``theta_const``: the interpolation with a constant theta in place of the
  thetas read (from shared memory in the chunk, global memory per step);
- ``fmad``: the source compiled with multiply-add contraction.

Variants that drop work compute wrong values and are timed only.  Prints
the card's name and power limit first, then one JSON line per variant and
lattice.  Needs one CUDA card and nvcc.  ``chip_smoke.py`` builds the
sync floor and the cluster sizes with ``start`` and ``finish`` and times
them through ``using``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parent)]

from tnl_lbm_tpu_torch.kernels.build import (  # noqa: E402
    BUILD_DIR,
    CSRC,
    NVCC_FLAGS,
    SOURCE_FLAGS,
    _nvcc,
    kernel_resources,
)

SOURCE = "d2q9_step.cu"
REMOTE_ROW = "src.row[d + 1] = peers[o] + cur + (xx - o * R) * Y;"
ARRIVE = 'asm volatile("barrier.cluster.arrive;\\n" ::: "memory");'
WAIT = 'asm volatile("barrier.cluster.wait;\\n" ::: "memory");'
RING = "const bool ring = m == GEO_FLUID_NEAR_WALL && p.bz != nullptr;"
THETA = "th[q] = src.theta(q);"
COLLISION = "if (m == GEO_FLUID || m == GEO_OUTFLOW_RIGHT || m == GEO_FLUID_NEAR_WALL) {"
SITE_UPDATE = "update<COLL, FORCE>(src, smap[j], x, y, X, Y, N, base + j, p, v, rho, ux, uy);"
CLUSTER = "constexpr int CLUSTER_MAX = 16;"
FMAD = ("-fmad=false",)
#: (tests/torch_cases.py RESIDENT_KINDS case, resolution)
CASES = (("ring", 1), ("ring", 2), ("ring_plain", 1), ("periodic", 1))


def _swap(src: str, *pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"the source no longer holds {old!r}: update the ablation")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    """name -> (source text, extra nvcc flags)."""
    local = (REMOTE_ROW, "src.row[d + 1] = buf + cur + (xx - o * R) * Y;")
    flags = SOURCE_FLAGS.get(SOURCE, ())
    copy = ("#pragma unroll\n    for (int q = 0; q < Q; ++q) v[q] = src.here(q);\n"
            "    rho = 1.0f;\n    ux = uy = 0.0f;")
    return {
        "kernel": (src, flags),
        "sync_floor": (_swap(src, (SITE_UPDATE, copy)), flags),
        **{f"cluster_{c}": (_swap(src, (CLUSTER, f"constexpr int CLUSTER_MAX = {c};")), flags)
           for c in (8, 4)},
        "full_barrier": (_swap(src, (ARRIVE, ""), (WAIT, "cluster.sync();")), flags),
        "no_dsmem": (_swap(src, local), flags),
        "block_sync": (_swap(src, local, (ARRIVE, ""), (WAIT, "")), flags),
        "no_collision": (_swap(src, (COLLISION, "if (false) {")), flags),
        "no_bouzidi": (_swap(src, (RING, "const bool ring = false;")), flags),
        "theta_const": (_swap(src, (THETA, "th[q] = 0.3f + 0.01f * q;")), flags),
        "fmad": (src, tuple(f for f in flags if f not in FMAD)),
    }


def cluster_of(name: str) -> int:
    """The cluster size a variant's library launches."""
    return int(name.split("_")[1]) if name.startswith("cluster_") else 16


def start(out: Path, names=None) -> dict:
    """Start one nvcc for each variant (all of them, or ``names``) into
    ``out``: name -> (directory, process)."""
    procs = {}
    for name, (text, flags) in variants((CSRC / SOURCE).read_text()).items():
        if names is not None and name not in names:
            continue
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        (d / SOURCE).write_text(text)
        procs[name] = (d, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *flags, "-shared", "-o", str(d / "lib.so"), str(d / SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish(procs: dict) -> dict:
    """Wait for ``start``'s builds: name -> (library, ptxas resources)."""
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.tnl_lbm_d2q9_chunk.argtypes = ([p] * 5 + [ll] * 3 + [p, p] + [i] * 4 + [f] * 5
                                           + [i, p])
        lib.tnl_lbm_d2q9_chunk_info.argtypes = [i, i, i, p]
        libs[name] = (lib, kernel_resources(log))
    return libs


@contextlib.contextmanager
def using(lib):
    """``FusedChunk2D`` launches from the variant library ``lib`` meanwhile."""
    from tnl_lbm_tpu_torch.kernels import fused_2d

    real = fused_2d.load_library
    fused_2d.load_library = lambda: lib
    try:
        yield
    finally:
        fused_2d.load_library = real


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    import torch

    from tnl_lbm_tpu_torch import bench, interop
    from tnl_lbm_tpu_torch.kernels import fused_2d
    from torch_cases import resident_case_2d, resident_inflow, seeded_2d

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=BUILD_DIR.parent / "b5_chunk_ablation")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    args.out.mkdir(parents=True, exist_ok=True)
    print(bench.card(), flush=True)
    libs = finish(start(args.out))
    cfg = interop.config_2d_from_spec("CLBM")
    for kind, res in CASES:
        m, periodic, bz = resident_case_2d(kind, res)
        dom = interop.domain_from_numpy(m, periodic, lat=cfg.lat, bouzidi=bz)
        chunk = fused_2d.FusedChunk2D(fused_2d.make_fused_step_2d(cfg, dom, "cuda"))
        u_in = resident_inflow(kind, m.shape[1], "cuda")
        f = seeded_2d(cfg, m.shape, "cuda", seed=2)
        out = torch.empty_like(f)
        for name, (lib, res_) in libs.items():
            line = {"variant": name, "case": kind, "shape": f"{m.shape[0]}x{m.shape[1]}",
                    "cluster": cluster_of(name),
                    "registers": res_.get("d2q9_chunk_clbm_kernel", {}).get("registers")}
            with using(lib):
                for n in (20, 200):
                    line[f"ms_per_step_{n}"] = time_ms(
                        lambda: chunk(f, 0.02, n, u_in=u_in, out=out), 4000 // n) / n
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
