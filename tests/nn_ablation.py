"""Where the non-Newtonian kernels (B10, the one-kernel NN step, and B9, the
NN force) spend their time, and which x segment they should march.

    python tests/nn_ablation.py [--out DIR]

Builds variants of ``csrc/nn_step.cu`` and ``csrc/nn_force.cu`` with their
shared header ``csrc/nn_site.cuh`` by text substitution on the sources of
this checkout (the CUM_WELL instances of B10 only; one ``nvcc`` per
variant, all started together, into ``build/nn_ablation/`` or ``--out``)
and times each on CUDA events, every variant in the same process, so that
they compare on one card.  The launches are queued behind a sleep kernel,
so that the host's dispatch is off the clock on the small shapes.

At 256^3 on the hooked bench duct:

- B10 (A-B, A-A even, A-A odd): the kernel (16 x 32 column tiles, one
  block of 512 threads per SM); 8 x 32 tiles at two blocks of 256 threads
  per SM; 12 x 32 tiles (one block of 384 threads, up to 168 registers a
  thread); 8 x 32 tiles at three blocks per SM and 12 x 32 at two (up to 85
  registers a thread, 24 warps); u* of a thread's two u slots unrolled (both
  slots' pulls in flight); x segments of 16 and 64 planes against its own
  32; without the site update (u*, S and F alone) and the site update
  alone (no u*, no S, F = 0).
- B9: the kernel (8 x 32 tiles, three blocks per SM); 16 x 32 tiles (one
  block per SM); x segments of 8, 16 and 64; the loads and stores alone
  (no S, no F).

On smaller shapes, B10's three modes and B9 at x segments of 1, 2, 4 and 8
planes against the kernel's own rule (nn_site.cuh ``launch``): the 4 x 4 x
21 blunted-profile channel, the 12 x 20 x 40 wall duct of the card's
compares, sim_coupled res 2's 128 x 64 x 64 map and the 64^3 duct, each
with CUM_WELL and the Carreau-Yasuda hook wrapped as its domain.  A
segment variant sets the header's SEG_MAX to its length and drops the
rule.

Every variant that keeps the function is first checked bit-equal to the
committed kernel (the package's build); variants that drop work compute
wrong values and are timed only.  The hooked pipeline (u* pass, B9,
force_field step) is timed on the same state per mode at 256^3, the
yardstick of the one-kernel route.  Prints the card's name and power limit
first, then one JSON line per variant.  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tnl_lbm_tpu_torch.kernels.build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc, kernel_resources

# anchors in the sources (edit them together with the kernels)
FORCE_TY = "#define NN_TY 8 "
STEP_TY = "#define NN_TY 16 "
STEP_BLOCKS = "constexpr int STEP_BLOCKS_PER_SM = 1;"
FORCE_BLOCKS = "constexpr int FORCE_BLOCKS_PER_SM = 3;"
U_LOOP = "#pragma unroll 1\n      for (int k = 0; k < nn::U_PER_THREAD; ++k) {"
USTAR_PASS = "    if (j < L + 4) {\n      const int x = nn::plane_x(mr, j);"
STRAIN_STEP = "    if (q >= 1 && q <= L + 2) nn::strain_plane(mr, q);"
AB_SITE = ("        ab_site<WELL, EQ, false, C>(f, fout, map, rho_out, u_out, x, y, z, X, Y, Z,"
           " P.pbits, ps,\n                                    ux, uy, uz);")
ODD_SITE = ("        aa_odd_site<WELL, EQ, false, false, C>(f, fout, map, rho_out, u_out, x, y, z,"
            " X, Y, Z,\n                                               P.pbits, P.has_nothing !="
            " 0, ps, ux, uy, uz);")
EVEN_SITE = "        if (m == GEO_NOTHING) {"
FORCE_STEP = "      float F[3];\n      nn::force_at("
STRAIN_FORCE = "    if (q >= 1 && q <= L + 2) nn::strain_plane(m, q);"
FORCE_B9 = "      nn::force_at(m, r, p, m.xs + p - 2, ly, lz, rho_s, out);"
#: what stands in for a site update that is dropped: F kept alive
NO_SITE = "        rho_out[((int64_t)x * Y + y) * Z + z] = ps.fx + ps.fy + ps.fz;"
SEG_MAX = "constexpr int SEG_MAX = 32;"
SEG_RULE = "  const int seg = std::min(SEG_MAX, (X + segs - 1) / segs);"
SEG_FIXED = "  const int seg = std::min(SEG_MAX, X);"
#: the x segments timed against the kernel's own: at 256^3 and on the small shapes
SEGS_256 = {"nn_step": (16, 64), "nn_force": (8, 16, 64)}
SEGS_SMALL = (1, 2, 4, 8)


def _swap(src: str, *pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"the source no longer holds {old!r}: update the ablation")
        src = src.replace(old, new)
    return src


def segments_of(site: str, n: int) -> str:
    """nn_site.cuh with every block marching x segments of n planes (X where
    it is shorter) in place of the launch rule's."""
    return _swap(site, (SEG_MAX, SEG_MAX.replace("32", str(n))), (SEG_RULE, SEG_FIXED))


def well_only(step_src: str) -> str:
    """nn_step.cu with the CUM and inverse-cumulant instances dropped (the
    table's entries point at the CUM_WELL ones): a third of the build."""
    src = re.sub(r"^NN_STEP_KERNEL\(nn_step_\w+_cum_(quad|invcum)_kernel.*\n", "", step_src,
                 flags=re.M)
    return re.sub(r"nn_step_(ab|even|odd)_cum_(quad|invcum)_kernel", r"nn_step_\1_cum_well_kernel",
                  src)


def variants(site: str, step: str, force: str) -> dict:
    """name -> (nn_site.cuh, nn_step.cu, nn_force.cu, what it keeps: "same"
    or "dropped work")."""
    step = well_only(step)
    off = lambda anchor, cond: (anchor, anchor.replace(cond, "false && " + cond, 1))  # noqa: E731
    segs = sorted({*SEGS_SMALL, *SEGS_256["nn_step"], *SEGS_256["nn_force"]})
    no_update = _swap(step, (AB_SITE, NO_SITE), (ODD_SITE, NO_SITE),
                      (EVEN_SITE, "        if (true) {\n"
                                  "          fout[site] = ps.fx + ps.fy + ps.fz;\n"
                                  "        } else if (m == GEO_NOTHING) {"))
    return {
        "kernel": (site, step, force, "same"),
        "tile_8x32": (_swap(site, (STEP_BLOCKS, STEP_BLOCKS.replace("1", "2"))),
                      _swap(step, (STEP_TY, STEP_TY.replace("16", "8"))), force, "same"),
        "tile_12x32": (site, _swap(step, (STEP_TY, STEP_TY.replace("16", "12"))), force, "same"),
        "tile_8x32_3_blocks": (_swap(site, (STEP_BLOCKS, STEP_BLOCKS.replace("1", "3"))),
                               _swap(step, (STEP_TY, STEP_TY.replace("16", "8"))), force, "same"),
        "tile_12x32_2_blocks": (_swap(site, (STEP_BLOCKS, STEP_BLOCKS.replace("1", "2"))),
                                _swap(step, (STEP_TY, STEP_TY.replace("16", "12"))), force,
                                "same"),
        "u_unrolled": (site, _swap(step, (U_LOOP, U_LOOP.replace("unroll 1", "unroll"))), force,
                       "same"),
        "no_update": (site, no_update, force, "dropped work"),
        "update_only": (site, _swap(step, off(USTAR_PASS, "j < L + 4"),
                                    off(STRAIN_STEP, "q >= 1"),
                                    (FORCE_STEP, "      float F[3] = {0.0f, 0.0f, 0.0f};\n"
                                                 "      if (false) nn::force_at(")),
                        force, "dropped work"),
        "b9_tile_16x32": (_swap(site, (FORCE_BLOCKS, FORCE_BLOCKS.replace("3", "1"))), step,
                          _swap(force, (FORCE_TY, FORCE_TY.replace("8", "16"))), "same"),
        "b9_memory_only": (site, step, _swap(force, off(STRAIN_FORCE, "q >= 1"),
                                             (FORCE_B9, "      out[0] = rho_s;\n"
                                                        "      out[1] = out[2] = 0.0f;")),
                           "dropped work"),
        **{f"seg_{n}": (segments_of(site, n), step, force, "same") for n in segs},
    }


# the variants timed at 256^3: B10's in its three modes, B9's
B10_VARIANTS = ("kernel", "tile_8x32", "tile_12x32", "tile_8x32_3_blocks", "tile_12x32_2_blocks",
                "u_unrolled", "no_update", "update_only",
                *(f"seg_{n}" for n in SEGS_256["nn_step"]))
B9_VARIANTS = ("kernel", "b9_tile_16x32", "b9_memory_only",
               *(f"seg_{n}" for n in SEGS_256["nn_force"]))


def build(out: Path, table: dict) -> dict:
    """name -> (library, ptxas resources, kind) of every variant that builds;
    a variant that does not is reported and left out."""
    procs = {}
    for name, (site, step, force, kind) in table.items():
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        (d / "nn_site.cuh").write_text(site)
        (d / "nn_step.cu").write_text(step)
        (d / "nn_force.cu").write_text(force)
        procs[name] = (d, kind, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"), str(d / "nn_step.cu"),
             str(d / "nn_force.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (d, kind, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(json.dumps({"variant": name, "build": "failed", "log": log[-2000:]}), flush=True)
            continue
        libs[name] = (ctypes.CDLL(str(d / "lib.so")), kernel_resources(log), kind)
    return libs


def time_ms(fn, reps: int = 20) -> float:
    """ms per call of ``fn`` on CUDA events, the calls queued behind a sleep
    kernel so that the host's dispatch is off the clock."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms: longer than queueing the calls
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class Case:
    """Seeded inputs of B10 and B9 on one shape: an equilibrium state of a
    seeded rho and u, and the launches of a variant's library."""

    def __init__(self, cfg, dom, model, nu, force, dev):
        import numpy as np
        import torch

        from tnl_lbm_tpu_torch.kernels import fused_nn_step
        from tnl_lbm_tpu_torch.kernels.fused import _periodic_bits
        from tnl_lbm_tpu_torch.kernels.fused_nn import nn_bits, rheology_args
        from tnl_lbm_tpu_torch.ops.boundary import GEO

        self.shape = dom.shape
        rng = np.random.default_rng(21)
        self.rho = torch.from_numpy(
            (1 + 0.01 * rng.standard_normal(self.shape)).astype(np.float32)).to(dev)
        self.u = torch.from_numpy(
            (0.02 * rng.standard_normal((3,) + self.shape)).astype(np.float32)).to(dev)
        self.f0 = cfg.eq(cfg.lat, self.rho, self.u).float().contiguous()
        self.geo = torch.as_tensor(np.ascontiguousarray(dom.map, np.uint8), device=dev)
        self.fout, self.r_out = torch.empty_like(self.f0), torch.empty_like(self.rho)
        self.u_out, self.F = torch.empty_like(self.u), torch.empty_like(self.u)
        kind, self.nu32, *self.consts = rheology_args(model, nu)
        self.kind = kind
        step = fused_nn_step.make_fused_nn_step(cfg, dom, model, dom.periodic, dev)
        self.variant, self.has_nothing = step._variant, int(GEO.NOTHING in step.codes)
        self.pbits, self.nn_bits = _periodic_bits(dom.periodic), nn_bits(dom.periodic)
        self.force, self.neumaier = force, int(cfg.high_precision_rho)

    def b10(self, lib, mode):
        import torch

        rc = lib.tnl_lbm_nn_step(
            self.f0.data_ptr(), self.fout.data_ptr(), self.geo.data_ptr(),
            self.r_out.data_ptr(), self.u_out.data_ptr(), *self.shape, self.pbits, self.nn_bits,
            self.has_nothing, self.variant, mode, self.nu32, *self.force, 0.0, 0.0, 0.0,
            self.neumaier, self.kind, *self.consts,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"nn_step: CUDA error {rc}")

    def b9(self, lib):
        import torch

        rc = lib.tnl_lbm_nn_force(self.rho.data_ptr(), self.u.data_ptr(), self.geo.data_ptr(),
                                  self.F.data_ptr(), *self.shape, self.nn_bits, self.kind,
                                  self.nu32, *self.consts,
                                  ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"nn_force: CUDA error {rc}")

    def time_variants(self, libs, b10_names, b9_names, reps, **tags):
        """One JSON line per (variant, kernel): B10's modes for
        ``b10_names``, B9 for ``b9_names``; a variant that keeps the function
        must match the committed kernel bit for bit."""
        import torch

        from tnl_lbm_tpu_torch.kernels.build import load_library

        modes = ("ab", "even", "odd")
        runs = [(name, f"nn_step_{modes[mode]}", mode) for name in b10_names
                for mode in range(3)]
        runs += [(name, "nn_force", None) for name in b9_names]
        ref = {}
        for _, kernel, mode in runs:
            if kernel not in ref:
                self.launch(load_library(), mode)
                ref[kernel] = [t.clone() for t in self.outputs(mode)]
        for name, kernel, mode in runs:
            if name not in libs:
                continue
            lib, res, what = libs[name]
            self.launch(lib, mode)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(self.outputs(mode), ref[kernel]))
            if what == "same" and not same:
                raise RuntimeError(f"{kernel} {name} at {self.shape} is not bit-equal")
            r = res[f"{kernel}_cum_well_kernel" if mode is not None else "nn_force_kernel"]
            print(json.dumps({**tags, "kernel": kernel, "variant": name, "bit_equal": same,
                              "ms": time_ms(lambda: self.launch(lib, mode), reps=reps),
                              "registers": r["registers"],
                              "spill_stores": r.get("spill_stores", 0)}), flush=True)

    def launch(self, lib, mode):
        return self.b9(lib) if mode is None else self.b10(lib, mode)

    def outputs(self, mode):
        return (self.F,) if mode is None else (self.fout, self.r_out, self.u_out)


def main(argv=None) -> int:
    import dataclasses

    import torch

    from tnl_lbm_tpu_torch import bench, interop
    from tnl_lbm_tpu_torch.apps import sim_coupled
    from tnl_lbm_tpu_torch.kernels.build import load_library
    from tnl_lbm_tpu_torch.kernels.fused_nn import nn_geometry
    from tnl_lbm_tpu_torch.kernels.hooked import make_hooked_fused_step
    from tnl_lbm_tpu_torch.ops.non_newtonian import CarreauYasuda, make_nn_forcing_hook
    from torch_cases import blunt_channel, nn_case

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=BUILD_DIR.parent / "nn_ablation")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    args.out.mkdir(parents=True, exist_ok=True)
    print(bench.card(), flush=True)
    load_library()  # the committed kernels, the reference of the bit-equal checks
    libs = build(args.out, variants((CSRC / "nn_site.cuh").read_text(),
                                    (CSRC / "nn_step.cu").read_text(),
                                    (CSRC / "nn_force.cu").read_text()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for lib, _, _ in libs.values():
        lib.tnl_lbm_nn_step.argtypes = [p] * 5 + [i] * 8 + [f] * 7 + [i, i] + [f] * 6 + [p]
        lib.tnl_lbm_nn_force.argtypes = [p] * 4 + [i] * 5 + [f] * 7 + [p]

    dev = torch.device("cuda")
    model = CarreauYasuda(0.1, 1.0, 2.0, 0.5)  # the hooked bench duct's (scripts/bench_hooked.py)
    nu, force = 0.02, (1e-6, 0.0, 0.0)

    def hooked(cfg, dom):
        return dataclasses.replace(cfg, forcing_hook=make_nn_forcing_hook(
            model, periodic=dom.periodic))

    cfg, dom = bench.flagship((256, 256, 256))
    cfg = hooked(cfg, dom)
    # the pipeline's step on the same state (u* pass, B9, force_field step),
    # the one-kernel route's yardstick
    case = Case(cfg, dom, model, nu, force, dev)
    modes = ("ab", "even", "odd")
    for streaming, parity in (("AB", 0), ("AA", 0), ("AA", 1)):
        pcfg = dataclasses.replace(cfg, streaming=streaming)
        pipe = make_hooked_fused_step(pcfg, dom, dev, single_kernel=False)
        work = case.f0.clone()
        out = torch.empty_like(case.f0) if streaming == "AB" else None
        ms = time_ms(lambda: pipe(work, nu, force=force, parity=parity, out=out))
        print(json.dumps({"shape": "256^3", "kernel": "pipeline",
                          "mode": modes[parity + (streaming == "AA")], "ms": ms}), flush=True)
        del pipe, work, out
    torch.cuda.empty_cache()
    case.time_variants(libs, B10_VARIANTS, B9_VARIANTS, reps=20, shape="256^3")
    del case
    torch.cuda.empty_cache()

    # the segment rule on smaller shapes
    well = interop.config_from_spec("CUM_WELL", "EQ_WELL", True, "AA")
    m, per = blunt_channel()
    small = {"blunt_4x4x21": interop.domain_from_numpy(m, per),
             "duct_12x20x40": interop.domain_from_numpy(*nn_case("duct")[:2]),
             "sim_coupled_res2": sim_coupled.build(2, device="cpu",
                                                   results_parent=args.out).domain,
             "duct_64^3": bench.flagship((64, 64, 64))[1]}
    seg_names = ["kernel"] + [f"seg_{n}" for n in SEGS_SMALL]
    for name, dom in small.items():
        segs = {k: nn_geometry(kind, dom.shape)["seg_len"]
                for kind, k in ((0, "nn_force"), (1, "nn_step"))}
        case = Case(hooked(well, dom), dom, model, nu, force, dev)
        case.time_variants(libs, seg_names, seg_names, reps=200, shape=name,
                           kernel_seg_len=segs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
