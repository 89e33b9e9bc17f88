"""How far a collision's kernel run drifts from its plain run on the card.

    python tests/collision_drift.py [id ...]

On the 256^3 bench duct from ``chip_smoke.route_profile`` (a duct profile
at rest density), 100 A-B steps of each kernel route - the one-kernel NN
step (B10) and the pipeline with the Carreau-Yasuda hook of
``chip_smoke.py``, and the A-B step (B4) without a hook - beside the plain
step of the same config from the same start.  Prints, every 10 steps, the
largest |df|, |drho| and |du| between the two runs and each run's mean rho
- 1, and at steps 0, 50 and 99 one step of each from the kernel run's state
(the step's own agreement).  The ids default to KBC_N1, KBC_C4 and MRT_LES.
Needs a CUDA device; imports no JAX.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tnl_lbm_tpu_torch import interop  # noqa: E402
from tnl_lbm_tpu_torch.kernels.fused import make_fused_step  # noqa: E402
from tnl_lbm_tpu_torch.kernels.hooked import make_hooked_fused_step  # noqa: E402
from tnl_lbm_tpu_torch.sim import make_step  # noqa: E402
from torch_cases import collision_spec  # noqa: E402

NU, FORCE, STEPS = 0.02, (1e-6, 0.0, 0.0), 100


def gap(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def drift(cid: str, route: str) -> None:
    _, dom = cs.flagship(cs.BENCH_SHAPE, streaming="AB")
    cfg = interop.config_from_spec(**collision_spec(cid, "AB"))
    if route == "B4":
        step = make_fused_step(cfg, dom, cs.DEVICE)
    else:
        cfg = cs.hooked_cfg(cfg, cs.NN_BENCH_MODEL, dom.periodic)
        step = make_hooked_fused_step(cfg, dom, cs.DEVICE, single_kernel=route == "B10")
    plain = make_step(cfg, dom)
    fk = cs.route_profile(cfg, dom.shape)
    fp = fk.clone()
    for it in range(STEPS):
        if it in (0, STEPS // 2, STEPS - 1):
            k, p = step(fk.clone(), NU, force=FORCE), plain(fk, NU, force=FORCE)
            print(f"ONE {cid} {route} step {it}: df {gap(k[0], p[0]):.3e} "
                  f"drho {gap(k[1], p[1]):.3e} du {gap(k[2], p[2]):.3e}", flush=True)
        fk, rk, uk = step(fk, NU, force=FORCE)
        fp, rp, up = plain(fp, NU, force=FORCE)
        if (it + 1) % 10 == 0:
            print(f"RUN {cid} {route} after {it + 1}: df {gap(fk, fp):.3e} "
                  f"drho {gap(rk, rp):.3e} du {gap(uk, up):.3e} "
                  f"mean_rho_minus_1 kernel {float(rk.double().mean() - 1):.3e} "
                  f"plain {float(rp.double().mean() - 1):.3e}", flush=True)


def main(ids) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for cid in ids:
        for route in ("B10", "pipeline", "B4"):
            drift(cid, route)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ("KBC_N1", "KBC_C4", "MRT_LES")))
