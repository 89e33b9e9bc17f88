"""The collide-and-stream step in plain PyTorch (counterpart of
``tnl_lbm_tpu/sim/step.py``).

One call advances the lattice one time step, per site: pull streaming ->
boundary handling -> collision -> write -> macro output (reference
kernels.h:60-100).  All branching is mask-select over GEO codes.  This is
the port's CPU path and its test oracle; on CUDA tensors it runs as plain
PyTorch (``Simulation(use_fused=False)``), never as a stand-in for the
CUDA kernels of ``kernels/``.

A-A pattern parity (reference d3q27/streaming_AA.h):
- even step: read same-site same-direction, write same-site opposite;
- odd step: read neighbor opposite-direction, write neighbor same-direction.
"""

from __future__ import annotations

import numpy as np
import torch

from tnl_lbm_tpu_torch.ops import boundary as bc
from tnl_lbm_tpu_torch.ops import moments as mom
from tnl_lbm_tpu_torch.ops import streaming as stream
from tnl_lbm_tpu_torch.ops.boundary import GEO
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig

#: GEO codes of the 3D BC set (reference d3q27/bc.h): everything but the
#: Bouzidi and transfer tags; OUTFLOW_RIGHT_INTERP is A-B only
SUPPORTED_CODES = {
    GEO.FLUID, GEO.WALL, GEO.INFLOW, GEO.INFLOW_LEFT, GEO.OUTFLOW_EQ, GEO.OUTFLOW_RIGHT,
    GEO.OUTFLOW_RIGHT_INTERP, GEO.PERIODIC, GEO.NOTHING,
    GEO.SYM_TOP, GEO.SYM_BOTTOM, GEO.SYM_LEFT, GEO.SYM_RIGHT, GEO.SYM_BACK, GEO.SYM_FRONT,
}


def check_supported(cfg: LBMConfig, domain: Domain, pair: bool = False, codes=None) -> None:
    """Raise NotImplementedError for what the port does not handle yet.

    ``codes`` is the set of GEO codes present (scanned from the map when
    None).  ``pair=True`` is the check of the one-kernel A-A pair, the only
    step that takes ``cfg.storage_dtype`` (half storage).
    """
    codes = domain.codes_present() if codes is None else codes
    unsupported = codes - SUPPORTED_CODES
    if unsupported:
        names = ", ".join(sorted(c.name for c in unsupported))
        raise NotImplementedError(
            f"GEO codes {names} are not ported yet (ROADMAP A8/A9: Bouzidi and transfer tags)")
    if cfg.streaming == "AA" and GEO.OUTFLOW_RIGHT_INTERP in codes:
        raise NotImplementedError("OUTFLOW_RIGHT_INTERP requires the A-B pattern")
    if domain.bouzidi is not None:
        raise NotImplementedError("Bouzidi curved walls are not ported yet (ROADMAP A9)")
    if cfg.forcing_hook is not None:
        raise NotImplementedError("forcing hooks are not ported yet (ROADMAP A11)")
    if cfg.storage_dtype is not None and not pair:
        raise NotImplementedError(
            "cfg.storage_dtype (half storage) needs pair dispatch: the one-kernel A-A "
            "pair (make_fused_pair2_aa) is the only step that stores the state narrow")


def as_vector(lat, arr, dtype, device) -> torch.Tensor:
    """A [D] (or already [D, *S]) input as a tensor broadcastable to [D, *S]."""
    a = torch.as_tensor(np.asarray(arr) if not torch.is_tensor(arr) else arr,
                        dtype=dtype, device=device)
    if a.ndim == 1:
        a = a.reshape((lat.D,) + (1,) * lat.D)
    return a


def make_step(cfg: LBMConfig, domain: Domain):
    """Build the per-step function for (cfg, domain).

    Returns ``step(f, nu, u_in=None, force=None, parity=0) -> (f_new, rho, u)``
    with ``parity`` the A-A parity (ignored for A-B).  ``u_in`` (a [D]
    vector) feeds the INFLOW and INFLOW_LEFT codes, ``force`` is the
    homogeneous body force.
    """
    check_supported(cfg, domain)
    lat = cfg.lat
    D = lat.D
    S = domain.shape
    dtype = cfg.compute_dtype
    codes = domain.codes_present()
    opp = np.asarray(lat.opp)
    do_coll_codes = sorted(int(c) for c in (bc.collision_mask_codes(D) & codes))
    sym_codes = [c for c in codes if c in bc.sym_table(D)]
    maps = {}

    def _map(device):
        m = maps.get(device)
        if m is None:
            m = maps[device] = torch.as_tensor(domain.map.astype(np.int64), device=device)
        return m

    def _stream_in(f, parity, masks):
        """Post-streaming DFs at every site, with the outflow pull rules."""
        if cfg.streaming == "AA" and parity == 0:
            return f  # even step: same site, same direction
        fpad = stream.pad_halo(f, domain.periodic)
        if cfg.streaming == "AA":
            f_in = stream.pull_from(lat, fpad, S, opp)
        else:
            f_in = stream.pull(lat, fpad, S)
        if GEO.OUTFLOW_RIGHT in codes:
            # pull every direction from x-1 (reference bc.h:64-65)
            src = opp if cfg.streaming == "AA" else None
            f_in = torch.where(masks[GEO.OUTFLOW_RIGHT],
                               stream.pull_shift_x(lat, fpad, S, dx=-1, src_perm=src), f_in)
        if GEO.OUTFLOW_RIGHT_INTERP in codes:
            f_in = torch.where(masks[GEO.OUTFLOW_RIGHT_INTERP],
                               stream.pull_interp_right(lat, fpad, S), f_in)
        return f_in

    def step(f, nu, u_in=None, force=None, parity: int = 0):
        map_arr = _map(f.device)
        masks = {c: map_arr == int(c) for c in codes}
        do_coll = torch.isin(map_arr, torch.as_tensor(do_coll_codes, device=f.device))

        f_in = _stream_in(f, parity, masks)
        u_in_b = as_vector(lat, u_in, dtype, f.device) if u_in is not None else None
        force_b = as_vector(lat, force, dtype, f.device) if force is not None else None

        # pure f transforms
        if GEO.WALL in codes:
            f_in = bc.apply_bounce_back(lat, f_in, masks[GEO.WALL])
        for c in sym_codes:
            axis, sign = bc.sym_table(D)[c]
            f_in = bc.apply_symmetry(lat, f_in, masks[c], axis, sign)

        rho, u = mom.density_velocity(lat, f_in, force=force_b, well=cfg.well,
                                      high_precision=cfg.high_precision_rho)

        f_in, rho, u = bc.apply_moment_bcs(lat, codes, masks, f_in, rho, u, u_in_b,
                                           lambda r, v: cfg.eq(lat, r, v).to(dtype), cfg.well)

        one = torch.ones((), dtype=dtype, device=f.device)
        rho_safe = torch.where(rho == 0, one, rho)
        f_post = cfg.collision(lat, f_in, rho_safe, u, nu, force=force_b)
        f_post = torch.where(do_coll, f_post, f_in)

        if cfg.streaming == "AA":
            if parity == 0:
                f_out = f_post[torch.tensor(opp.tolist(), dtype=torch.long, device=f.device)]
            else:
                # push = pull of the edge/wrap-padded post-collision field
                f_out = stream.pull(lat, stream.pad_halo(f_post, domain.periodic), S)
        else:
            f_out = f_post

        # inert ghost sites keep their previous DFs (reference bc.h:54-61,254-257)
        if GEO.NOTHING in codes:
            f_out = torch.where(masks[GEO.NOTHING], f, f_out)

        rho_out, u_out = rho, u
        for c in (GEO.WALL, GEO.NOTHING):
            if c in codes:
                rho_out = torch.where(masks[c], one, rho_out)
                u_out = torch.where(masks[c], torch.zeros_like(u), u_out)
        return f_out.contiguous(), rho_out, u_out

    return step
