"""Where the one-kernel A-A pair (B1), P2a and the P4 window copy spend their time.

    python tests/pair_ablation.py [--out DIR] [--only pair,p2a,window]

Builds variants of ``csrc/aa_pair.cu`` (with the march it instantiates,
``csrc/pair_march.cuh``) and ``csrc/probes.cu`` by text substitution on
the sources of this checkout (one ``nvcc`` each, all
started together, into ``build/pair_ablation/`` or ``--out``) and times
each at 256^3 on CUDA events, every variant in the same process, so that
they compare on one card:

- B1 (f32, f16): the kernel; without the collisions (a site's moments stand
  in); without the odd warps' 27 pushes a site; without both; the even
  warps alone (the odd warps only hand their planes back); the stage copies
  alone; without staging (the even warps read global memory); a float32
  row away from the z faces staged as one 160-byte bulk copy with its halo
  words (wide rows: the low halo lands 12 bytes off, so the values are
  wrong, timed only); the kernel at x segments of 8, 16 and 64 planes
  against its own 32.
- B1 on sim_2's resolution-2 duct (32 x 64 x 64, f32, NOTHING sites on its
  faces): the variants above at the kernel's own x segment (4 planes there),
  and the kernel at x segments of 1, 2, 4, 8, 16 and 32 planes.
- P2a (each load path, 0 and 20 passes): the march's windows without their
  y-halo rows, without their z-halo words, without the segments' two
  x-halo planes, without all three (the tiles' own bytes), the ring with
  every column as staged rows (no tensor boxes), and wide rows (as B1's).  The tile warps read
  only tile sites of interior planes, so every variant keeps P2a's
  function and is held to the plain version bit for bit.
- P4 (wy = 48 and 36, each load path): the ring of up to 4 plane buffers
  with one block per SM; 2 plane buffers each for two blocks per SM; every
  block walking its planes forwards; beside ``interior(fpad).contiguous()``.

Variants of B1 and P4 that drop work compute wrong values and are timed only.  Prints
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
P2A_COPIER = "const bool copier = t < Q * M::WY && t % M::WY <= ny + 1;"
P2A_ON = "const bool on = t < M::WSITES && lyw <= ny + 1 && lzw <= nz + 1;"
STAGE_HALOS = "  cp_async4(dst + lo_byte, lo);\n  cp_async4(dst + hi_halo_byte<S>(), hi);\n"
P2A_STAGE_COPY = "        if (copier) {\n          asm volatile"
P2A_DIRECT_LOAD = "        if (on) {\n          const float* src = f + neighbour(xs - 1, j, X, px)"
P2A_BOXED = "const bool boxed = LOAD == LOAD_RING && ny"
STAGE_ROW = "  bulk_copy(dst + 16, src + z0, nz * (uint32_t)sizeof(S), bar);\n"
#: a float32 row away from the z faces as one 160-byte bulk copy from z0 - 4
#: (its halo words inside it, the low one at byte 12)
WIDE_ROW = ("  if (sizeof(S) == 4 && nz == TZ && z0 >= 4 && zlo == z0 - 1 && zhi == z0 + nz) {\n"
            "    bulk_copy(dst, src + z0 - 4, 160, bar);\n    return;\n  }\n")


def _swap(files: dict, *pairs) -> dict:
    """``files`` (name -> text) with each (old, new) replaced in the one
    file that holds ``old``."""
    files = dict(files)
    for old, new in pairs:
        holders = [name for name, text in files.items() if old in text]
        if len(holders) != 1:
            raise RuntimeError(f"{len(holders)} sources hold {old!r}: update the ablation")
        files[holders[0]] = files[holders[0]].replace(old, new)
    return files


def pair_variants(files: dict) -> dict:
    no_collide = (COLLIDE, MOMENTS)
    no_push = [(push, "if (v[q] == 12345.0f) " + push) for push in PUSHES]
    return {
        "kernel": files,
        "no_collisions": _swap(files, no_collide),
        "no_pushes": _swap(files, *no_push),
        "no_pushes_no_collisions": _swap(files, no_collide, *no_push),
        "even_warps_only": _swap(files, (ODD_WORK, ODD_WORK.replace("(mine)", "(false && mine)"))),
        "stage_copies_only": _swap(files,
                                   (ODD_WORK, ODD_WORK.replace("(mine)", "(false && mine)")),
                                   (EVEN_WORK, EVEN_WORK.replace("(on)", "(false && on)"))),
        "unstaged": _swap(files, (STAGED, "const int staged = 0 && Z % VEC == 0")),
        "wide_rows": _swap(files, (STAGE_ROW, WIDE_ROW + STAGE_ROW)),
    }


def window_variants(files: dict) -> dict:
    return {"ring_one_block": files,
            "ring_2_two_blocks": _swap(files, (RING_BUDGET, RING_BUDGET.replace(
                "WINDOW_SMEM_MAX", "113 * 1024"))),
            "forwards": _swap(files, (BACKWARDS, "const bool backwards = false;"))}


def pipeline_variants(files: dict) -> dict:
    rows = (P2A_COPIER, P2A_COPIER.replace("t % M::WY <= ny + 1",
                                           "t % M::WY >= 1 && t % M::WY <= ny"))
    sites = (P2A_ON, P2A_ON.replace("lyw <= ny + 1 && lzw <= nz + 1",
                                    "lyw >= 1 && lyw <= ny && lzw >= 1 && lzw <= nz"))
    halos = (STAGE_HALOS, "")
    planes = [(P2A_STAGE_COPY, P2A_STAGE_COPY.replace("(copier)",
                                                      "(copier && j >= 1 && j + 1 < planes)")),
              (P2A_DIRECT_LOAD, P2A_DIRECT_LOAD.replace("(on)", "(on && j >= 1 && j + 1 < planes)"))]
    return {"kernel": files,
            "no_y_halo_rows": _swap(files, rows),
            "no_z_halo_words": _swap(files, halos),
            "no_x_halo_planes": _swap(files, *planes),
            "tiles_only": _swap(files, rows, sites, halos, *planes),
            "ring_rows_only": _swap(files, (P2A_BOXED, "const bool boxed = false && LOAD == "
                                                       "LOAD_RING && ny")),
            "wide_rows": _swap(files, (STAGE_ROW, WIDE_ROW + STAGE_ROW))}


def sources(*names) -> dict:
    return {name: (CSRC / name).read_text() for name in names}


def build(out: Path, source: str, variants: dict) -> dict:
    """name -> (library, ptxas resources) of every variant (name -> the
    texts of the files it changes) of ``source``."""
    procs = {}
    for name, files in variants.items():
        d = out / f"{Path(source).stem}_{name}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        for fname, text in files.items():
            (d / fname).write_text(text)
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
    ap.add_argument("--only", default="pair,p2a,window",
                    help="comma-separated parts: pair (B1), p2a, window (P4)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    args.out.mkdir(parents=True, exist_ok=True)
    print(bench.card(), flush=True)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    parts = set(args.only.split(","))
    dev = torch.device("cuda")
    shape = (256, 256, 256)
    X, Y, Z = shape
    if "pair" in parts:
        pair_libs = build(args.out, "aa_pair.cu",
                          pair_variants(sources("aa_pair.cu", "pair_march.cuh")))
        for lib, _ in pair_libs.values():
            lib.tnl_lbm_aa_pair_segmented.argtypes = [p] * 5 + [i] * 7 + [f] * 4 + [i, i, p]
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

    if "p2a" in parts:
        p2a_libs = build(args.out, "probes.cu",
                         pipeline_variants(sources("probes.cu", "pair_march.cuh")))
        g = torch.randn((27,) + shape, device=dev, generator=torch.Generator(dev).manual_seed(3))
        gout = torch.empty_like(g)
        want = {n: probes.pair_pipeline_plain(g, n) for n in (0, 20)}
        for name, (lib, res) in p2a_libs.items():
            lib.tnl_lbm_pair_pipeline.argtypes = [p, p] + [i] * 6 + [p]
            for load, (code, _) in probes.PIPELINE_LOADS.items():
                line = {"kernel": "pair_pipeline", "variant": name, "load": load}
                for passes in (0, 20):
                    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

                    def call(lib=lib, code=code, passes=passes, stream=stream):
                        rc = lib.tnl_lbm_pair_pipeline(g.data_ptr(), gout.data_ptr(), X, Y, Z,
                                                       probes._BENCH_PERIODIC_BITS, passes, code,
                                                       stream)
                        if rc != 0:
                            raise RuntimeError(f"pair_pipeline {name} {load}: CUDA error {rc}")

                    call()
                    torch.cuda.synchronize()
                    if not torch.equal(gout, want[passes]):
                        raise RuntimeError(f"pair_pipeline {name} {load} is not its plain version")
                    line[f"ms_{passes}"] = time_ms(call)
                print(json.dumps(line), flush=True)
        del g, gout, want
        torch.cuda.empty_cache()
    if "window" in parts:
        window_libs = build(args.out, "probes.cu", window_variants(sources("probes.cu")))
        for lib, _ in window_libs.values():
            lib.tnl_lbm_window_copy.argtypes = [p, p] + [i] * 7 + [p]
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
