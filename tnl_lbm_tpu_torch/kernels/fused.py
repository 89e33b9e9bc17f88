"""Per-site logic of the fused kernels, in plain PyTorch.

Counterpart of the layout-independent half of ``tnl_lbm_tpu/kernels/fused.py``:
the code analysis of ``_prep``, ``_moments_local``, ``_eq_local``,
``_pull_transform`` and ``_stream_bc_collide``.  The same logic, per site,
is the CUDA device code in ``csrc/lbm_site.cuh`` (``moments_local``,
``pull_transform``, ``stream_bc_collide``); the functions here are its
plain versions, run on whole arrays by ``kernels/fused_aa.py`` for CPU
tensors and used as the oracle the CUDA kernels are held against.

``shifted(q, (ox, oy, oz))`` returns DF component q read at the given site
offsets - the only layout-dependent piece, supplied by the caller.
"""

from __future__ import annotations

import numpy as np
import torch

from tnl_lbm_tpu_torch.ops import boundary as bc
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig
from tnl_lbm_tpu_torch.sim.step import SUPPORTED_CODES, check_supported


def supports(domain: Domain, streaming: str = "AB") -> bool:
    """True when the domain holds only GEO codes the kernels handle."""
    del streaming  # every supported code works with both patterns
    return domain.codes_present() <= SUPPORTED_CODES


def _moments_local(lat, f_in, force, well, high_precision=False):
    """rho and u (with the half force) as sequential sums over q - the
    order the CUDA ``moments_local`` adds in.  ``force`` holds 3 scalars."""
    if high_precision:
        s = f_in[0]
        comp = torch.zeros_like(s)
        for q in range(1, lat.Q):
            x = f_in[q]
            t = s + x
            comp = comp + torch.where(torch.abs(s) >= torch.abs(x), (s - t) + x, (x - t) + s)
            s = t
        rho = s + comp
    else:
        rho = f_in[0]
        for q in range(1, lat.Q):
            rho = rho + f_in[q]
    if well:
        rho = rho + 1
    j = []
    for a in range(3):
        acc = None
        for q in range(lat.Q):
            c = int(lat.c[q][a])
            if c == 0:
                continue
            term = f_in[q] if c > 0 else -f_in[q]
            acc = term if acc is None else acc + term
        j.append(acc)
    u = torch.stack([(j[a] + 0.5 * force[a]) / rho for a in range(3)])
    return rho, u


def _eq_local(lat, rho, u, kind):
    """Quadratic ("quad") or well-conditioned ("well") equilibrium with
    per-q scalar weights."""
    uu = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
    rows = []
    for q in range(lat.Q):
        cx, cy, cz = (int(v) for v in lat.c[q])
        cu = cx * u[0] + cy * u[1] + cz * u[2]
        w = float(lat.w[q])
        feq = rho * (1 + 3 * cu + 4.5 * cu * cu - 1.5 * uu)
        rows.append(w * (feq - 1) if kind == "well" else w * feq)
    return torch.stack(rows)


def _prep(cfg: LBMConfig, domain: Domain, pair: bool = False):
    """Static code analysis shared by the kernels: the lattice, the GEO
    codes present and the codes on which the collision runs (``pair``:
    see ``check_supported``)."""
    check_supported(cfg, domain, pair=pair)
    lat = cfg.lat
    if lat.D != 3:
        raise NotImplementedError("the fused kernels are for the 3D lattices")
    codes = domain.codes_present()
    do_coll_codes = sorted(int(c) for c in (bc.collision_mask_codes(3) & codes))
    return lat, codes, do_coll_codes


def _pull_transform(lat, codes, shifted, masks):
    """Streaming-stage reads + pull-side BC transforms: the pull of the 27
    components and the WALL bounce-back swap."""
    opp = np.asarray(lat.opp)
    f_in = torch.stack([shifted(q, tuple(-int(v) for v in lat.c[q])) for q in range(lat.Q)])
    if GEO.WALL in codes:
        f_swapped = torch.stack([f_in[int(opp[q])] for q in range(lat.Q)])
        f_in = torch.where(masks[GEO.WALL], f_swapped, f_in)
    return f_in


def _stream_bc_collide(lat, cfg, codes, do_coll_codes, shifted, m, nu, force,
                       out_perm=None, defer_nothing=False):
    """Pull-stream + BC mask-selects + collision on whole arrays.

    ``m`` is the int map of the sites computed, ``force`` 3 scalars.
    ``out_perm`` permutes the output components before the NOTHING restore
    (the A-A even step writes opposite-direction, streaming_AA.h:16-45);
    ``defer_nothing=True`` skips the restore - the A-A odd step applies it
    at the destination site, after the push.
    """
    masks = {c: (m == int(c)) for c in codes}
    f_in = _pull_transform(lat, codes, shifted, masks)
    rho, u = _moments_local(lat, f_in, force, cfg.well, high_precision=cfg.high_precision_rho)

    one = torch.ones((), dtype=f_in.dtype, device=f_in.device)
    rho_safe = torch.where(rho == 0, one, rho)
    f_post = cfg.collision(lat, f_in, rho_safe, u, nu)
    do_coll = torch.zeros_like(m, dtype=torch.bool)
    for code in do_coll_codes:
        do_coll = do_coll | (m == code)
    f_post = torch.where(do_coll, f_post, f_in)

    if out_perm is not None:
        f_post = torch.stack([f_post[int(out_perm[q])] for q in range(lat.Q)])
    if GEO.NOTHING in codes and not defer_nothing:
        center = torch.stack([shifted(q, (0, 0, 0)) for q in range(lat.Q)])
        f_post = torch.where(masks[GEO.NOTHING], center, f_post)

    rho_out, u_out = rho, u
    for c in (GEO.WALL, GEO.NOTHING):
        if c in codes:
            rho_out = torch.where(masks[c], one, rho_out)
            u_out = torch.where(masks[c], torch.zeros_like(u), u_out)
    return f_post, rho_out, u_out
