"""Where the one-kernel A-A pair (B1) and the P4 window copy spend their time.

    python tests/pair_ablation.py [--out DIR]

Builds variants of ``csrc/aa_pair.cu`` and ``csrc/probes.cu`` by text
substitution on the sources of this checkout (one ``nvcc`` each, all
started together, into ``build/pair_ablation/`` or ``--out``) and times
each at 256^3 on CUDA events, every variant in the same process, so that
they compare on one card:

- B1 (f32, f16): the kernel; without the collisions (a site's moments stand
  in); without the odd warps' 27 pushes a site; without both; the even
  warps alone (the odd warps only hand their planes back); the stage copies
  alone; without staging (the even warps read global memory); the kernel
  at x segments of 8, 16 and 64 planes against its own 32.
- B1 on sim_2's resolution-2 duct (32 x 64 x 64, f32, NOTHING sites on its
  faces): the variants above at the kernel's own x segment (4 planes there),
  and the kernel at x segments of 1, 2, 4, 8, 16 and 32 planes.
- P4 (wy = 48 and 36, each load path): the ring of up to 4 plane buffers
  with one block per SM; 2 plane buffers each for two blocks per SM; every
  block walking its planes forwards; beside ``interior(fpad).contiguous()``.

Variants that drop work compute wrong values and are timed only.  Prints
one JSON line per variant and the card's name and power limit first.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tnl_lbm_tpu_torch.kernels.build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc, kernel_resources

COLLIDE = "stream_bc_collide(v, m, p, rho, ux, uy, uz);"
MOMENTS = "rho = v[0]; ux = v[1]; uy = v[2]; uz = v[3];"
PUSHES = ("fs[cx(q) * sx32 + cy(q) * sy32 + cz(q)] = narrow<S>(v[q]);",  # straight lines
          "fs[d + fz.delta(cz(q))] = val;", "fs[d] = val;",  # a z face
          "fs[dx + dy + dz] = val;", "fs[(r & 1 ? 0 : dx)")  # an x or y face
EVEN_WORK = "      if (on) {\n        // same-site read, opposite-slot result"
ODD_WORK = "    if (mine) {\n      // neighbour pull, collide, push"
STAGED = "const int staged = Z % VEC == 0"
RING_BUDGET = "WINDOW_SMEM_MAX / std::max(plane, 1)"
BACKWARDS = "const bool backwards = i & 1;"


def _swap(src: str, *pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"the source no longer holds {old!r}: update the ablation")
        src = src.replace(old, new)
    return src


def pair_variants(src: str) -> dict:
    no_collide = (COLLIDE, MOMENTS)
    no_push = [(push, "if (v[q] == 12345.0f) " + push) for push in PUSHES]
    return {
        "kernel": src,
        "no_collisions": _swap(src, no_collide),
        "no_pushes": _swap(src, *no_push),
        "no_pushes_no_collisions": _swap(src, no_collide, *no_push),
        "even_warps_only": _swap(src, (ODD_WORK, ODD_WORK.replace("(mine)", "(false && mine)"))),
        "stage_copies_only": _swap(src, (ODD_WORK, ODD_WORK.replace("(mine)", "(false && mine)")),
                                   (EVEN_WORK, EVEN_WORK.replace("(on)", "(false && on)"))),
        "unstaged": _swap(src, (STAGED, "const int staged = 0 && Z % VEC == 0")),
    }


def window_variants(src: str) -> dict:
    return {"ring_one_block": src,
            "ring_2_two_blocks": _swap(src, (RING_BUDGET, RING_BUDGET.replace(
                "WINDOW_SMEM_MAX", "113 * 1024"))),
            "forwards": _swap(src, (BACKWARDS, "const bool backwards = false;"))}


def build(out: Path, source: str, variants: dict) -> dict:
    """name -> (library, ptxas resources) of every variant of ``source``."""
    procs = {}
    for name, text in variants.items():
        d = out / f"{Path(source).stem}_{name}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        (d / source).write_text(text)
        procs[name] = (d, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"), str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} {name}:\n{log}")
        libs[name] = (ctypes.CDLL(str(d / "lib.so")), kernel_resources(log))
    return libs


def time_ms(fn, reps: int = 20) -> float:
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
    import numpy as np
    import torch

    from tnl_lbm_tpu_torch import bench
    from tnl_lbm_tpu_torch.kernels import probes
    from tnl_lbm_tpu_torch.kernels.fused import _periodic_bits
    from tnl_lbm_tpu_torch.kernels.fused_aa import _STORE_CODES, to_storage

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=BUILD_DIR.parent / "pair_ablation")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    args.out.mkdir(parents=True, exist_ok=True)
    print(bench.card(), flush=True)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    pair_libs = build(args.out, "aa_pair.cu", pair_variants((CSRC / "aa_pair.cu").read_text()))
    window_libs = build(args.out, "probes.cu", window_variants((CSRC / "probes.cu").read_text()))
    for lib, _ in pair_libs.values():
        lib.tnl_lbm_aa_pair_segmented.argtypes = [p] * 5 + [i] * 7 + [f] * 4 + [i, i, p]
    for lib, _ in window_libs.values():
        lib.tnl_lbm_window_copy.argtypes = [p, p] + [i] * 7 + [p]

    dev = torch.device("cuda")
    shape = (256, 256, 256)
    X, Y, Z = shape
    cfg, dom = bench.flagship(shape)
    rng = np.random.default_rng(7)
    rho = torch.from_numpy((1 + 0.01 * rng.standard_normal(shape)).astype(np.float32)).to(dev)
    u = torch.from_numpy((0.02 * rng.standard_normal((3,) + shape)).astype(np.float32)).to(dev)
    f32 = cfg.eq(cfg.lat, rho, u).float().contiguous()
    del rho, u
    geo = torch.as_tensor(np.ascontiguousarray(dom.map, np.uint8), device=dev)
    r_out, u_out = torch.empty(shape, device=dev), torch.empty((3,) + shape, device=dev)
    for dtype in (torch.float32, torch.float16):
        state = to_storage(f32, dtype)
        out = torch.empty_like(state)
        code, tag = _STORE_CODES[dtype]
        runs = [(name, 0) for name in pair_libs] + [("kernel", seg) for seg in (8, 16, 64)]
        for name, seg in runs:
            lib, res = pair_libs[name]
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

            def call(lib=lib, seg=seg, stream=stream):
                rc = lib.tnl_lbm_aa_pair_segmented(
                    state.data_ptr(), out.data_ptr(), geo.data_ptr(), r_out.data_ptr(),
                    u_out.data_ptr(), X, Y, Z, _periodic_bits(dom.periodic), 0, 1, code, 0.02,
                    1e-6, 0.0, 0.0, 0, seg, stream)
                if rc != 0:
                    raise RuntimeError(f"aa_pair {name}: CUDA error {rc}")

            kernel = res[f"aa_pair_{tag}_kernel"]
            print(json.dumps({"kernel": f"aa_pair_{tag}", "variant": name, "seg_len": seg or "auto",
                              "ms": time_ms(call), "registers": kernel["registers"],
                              "spill_stores": kernel.get("spill_stores", 0)}), flush=True)
        del state, out
        torch.cuda.empty_cache()
    del f32, r_out, u_out
    torch.cuda.empty_cache()

    from tnl_lbm_tpu_torch.apps import sim_2
    from tnl_lbm_tpu_torch.kernels.fused_aa import make_fused_pair2_aa

    small = sim_2.build(2, device=dev, streaming="AA", use_fused=True,
                        results_parent=args.out / "sim_2")
    rng = np.random.default_rng(7)
    sshape = small.domain.shape
    rho = torch.from_numpy((1 + 0.01 * rng.standard_normal(sshape)).astype(np.float32)).to(dev)
    u = torch.from_numpy((0.02 * rng.standard_normal((3,) + sshape)).astype(np.float32)).to(dev)
    fs = small.cfg.eq(small.cfg.lat, rho, u).float().contiguous()
    out = torch.empty_like(fs)
    geo = torch.as_tensor(np.ascontiguousarray(small.domain.map, np.uint8), device=dev)
    r_out, u_out = torch.empty(sshape, device=dev), torch.empty((3,) + sshape, device=dev)
    for name, (lib, _) in pair_libs.items():
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def call(lib=lib, stream=stream):
            rc = lib.tnl_lbm_aa_pair_segmented(
                fs.data_ptr(), out.data_ptr(), geo.data_ptr(), r_out.data_ptr(), u_out.data_ptr(),
                *sshape, _periodic_bits(small.domain.periodic), 1, 1, 0, 0.02, 1e-6, 0.0, 0.0, 0,
                0, stream)
            if rc != 0:
                raise RuntimeError(f"aa_pair {name}: CUDA error {rc}")

        print(json.dumps({"kernel": "aa_pair_f32", "shape": list(sshape), "variant": name,
                          "seg_len": "auto", "ms": time_ms(call, reps=50)}), flush=True)
    for seg in (1, 2, 4, 8, 16, 32):
        pair = make_fused_pair2_aa(small.cfg, small.domain, dev, seg_len=seg)
        print(json.dumps({"kernel": "aa_pair_f32", "shape": list(sshape), "seg_len": seg,
                          "ms": time_ms(lambda: pair(fs, 0.02, out=out), reps=50),
                          "blocks": pair.geometry()["columns"] * pair.geometry()["segments"]}),
              flush=True)
    del fs, out

    fpad = torch.randn((27, X + 4, Y + 16, Z), device=dev,
                       generator=torch.Generator(dev).manual_seed(4))
    wout = torch.empty((27, X, Y, Z), device=dev)
    for y_off, wy, dst_off in ((0, 48, 0), (6, 36, 0)):
        line = {"wy": wy, "library_ms": time_ms(lambda: probes.interior(fpad).contiguous())}
        for name, (lib, _) in window_libs.items():
            for load, (code, _) in probes.LOADS.items():
                stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

                def call(lib=lib, code=code, stream=stream):
                    rc = lib.tnl_lbm_window_copy(fpad.data_ptr(), wout.data_ptr(), X, Y, Z, y_off,
                                                 wy, dst_off, code, stream)
                    if rc != 0:
                        raise RuntimeError(f"window_copy {name} {load}: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                if not torch.equal(wout, probes.interior(fpad)):
                    raise RuntimeError(f"window_copy {name} {load} is not the interior")
                line[f"{name}_{load}_ms"] = time_ms(call)
        line["library_after_ms"] = time_ms(lambda: probes.interior(fpad).contiguous())
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
