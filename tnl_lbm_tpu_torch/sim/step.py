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
#: GEO codes of the D2Q9 BC set (reference d2q9/bc.h:6-214): the 3D set but
#: the Eichler moment inflow and the y-facing symmetry planes, with the
#: Bouzidi curved walls (FLUID_NEAR_WALL)
SUPPORTED_CODES_D2Q9 = (SUPPORTED_CODES - {GEO.INFLOW_LEFT, GEO.SYM_BACK, GEO.SYM_FRONT}
                        | {GEO.FLUID_NEAR_WALL})


def supported_codes(lat) -> set:
    """The GEO codes the plain step handles on lattice ``lat``."""
    return SUPPORTED_CODES_D2Q9 if lat.name == "D2Q9" else SUPPORTED_CODES


def check_supported(cfg: LBMConfig, domain: Domain, pair: bool = False, codes=None) -> None:
    """Raise NotImplementedError for what the port does not handle yet.

    ``codes`` is the set of GEO codes present (scanned from the map when
    None).  ``pair=True`` is the check of the one-kernel A-A pair, the only
    step that takes ``cfg.storage_dtype`` (half storage).
    """
    codes = domain.codes_present() if codes is None else codes
    unsupported = codes - supported_codes(cfg.lat)
    if unsupported:
        names = ", ".join(sorted(c.name for c in unsupported))
        raise NotImplementedError(
            f"GEO codes {names} are not handled on a {cfg.lat.name} lattice (Bouzidi curved "
            f"walls are D2Q9 only; the transfer tags belong to the ADE lattice: ROADMAP A8)")
    if cfg.streaming == "AA" and GEO.OUTFLOW_RIGHT_INTERP in codes:
        raise NotImplementedError("OUTFLOW_RIGHT_INTERP requires the A-B pattern")
    if cfg.storage_dtype is not None and not pair:
        raise NotImplementedError(
            "cfg.storage_dtype (half storage) needs pair dispatch: the one-kernel A-A "
            "pair (make_fused_pair2_aa) is the only step that stores the state narrow")


def as_vector(lat, arr, dtype, device) -> torch.Tensor:
    """A [D] vector, or a [D, ...] field broadcastable to [D, *S] (a per-site
    inflow profile), as a tensor broadcastable to [D, *S]."""
    a = torch.as_tensor(np.asarray(arr) if not torch.is_tensor(arr) else arr,
                        dtype=dtype, device=device)
    if a.ndim == 1:
        a = a.reshape((lat.D,) + (1,) * lat.D)
    return a


def make_step(cfg: LBMConfig, domain: Domain, local_shape=None):
    """Build the per-step function for (cfg, domain).

    Returns ``step(f, nu, u_in=None, force=None, parity=0, hook_consts=None,
    map_arr=None, bouzidi_arr=None) -> (f_new, rho, u)`` with ``parity``
    the A-A parity (ignored for A-B).
    ``u_in`` (a [D] vector or a per-site profile broadcastable to [D, *S])
    feeds the INFLOW and INFLOW_LEFT codes, ``force`` is the body force (a
    [D] vector or a [D, *S] field).  On a D2Q9 lattice FLUID_NEAR_WALL
    sites take the Bouzidi pull with ``domain.bouzidi``'s thetas (none
    given: they stream plainly).

    With ``cfg.forcing_hook`` (a non-Newtonian or IBM force) the step
    evaluates ``hook(lat, rho0, u0, nu, fluid[, consts=hook_consts])`` on
    the u* moments - the streamed, wall/symmetry-transformed moments with
    the body force - and adds its output to the body force of the final
    moments and the collision.  ``step.ustar(f, force=None, parity=0) ->
    (rho0, u0, fluid)`` is that u* pass alone (reference kernels.h:178-218),
    the first phase of ``kernels/hooked.py``'s pipeline.

    The sharded step (``parallel/sharded.py make_sharded_step``) runs it on
    every shard's block in two stages, with a halo exchange before each:
    ``step.collide(f, ..., fpad=None) -> (f_post, rho, u, masks)`` and
    ``step.stream_out(f, f_post, masks, parity, post_pad=None) -> f_new``.
    ``local_shape`` is the block's shape; ``fpad`` is f with its 1-wide
    halo and ``post_pad`` the A-A odd step's f_post with its halo (by
    default the edge/wrap pad of the whole lattice); ``step.pull_comps``
    tells a direction-subset exchange which components the pull reads
    ("own", "opp" for the A-A odd read, "all" where Bouzidi reads others;
    the push reads "own"); ``map_arr`` / ``bouzidi_arr`` are the block's
    map and thetas at each call.
    """
    check_supported(cfg, domain)
    lat = cfg.lat
    D = lat.D
    S = tuple(local_shape) if local_shape is not None else domain.shape
    dtype = cfg.compute_dtype
    codes = domain.codes_present()
    opp = np.asarray(lat.opp)
    do_coll_codes = sorted(int(c) for c in (bc.collision_mask_codes(D) & codes))
    sym_codes = [c for c in codes if c in bc.sym_table(D)]
    bouzidi = GEO.FLUID_NEAR_WALL in codes and domain.bouzidi is not None
    # the components each pull reads off the halo (JAX make_step's subset hint)
    comps_pull = "all" if GEO.FLUID_NEAR_WALL in codes else "own"
    comps_pull_aa = "all" if GEO.FLUID_NEAR_WALL in codes else "opp"
    maps = {}

    def _map(device, map_arr=None, bouzidi_arr=None):
        """(map, thetas) on ``device``, made once, or the call's own."""
        if map_arr is not None:
            return map_arr, bouzidi_arr if bouzidi else None
        m = maps.get(device)
        if m is None:
            bz = (torch.as_tensor(np.asarray(domain.bouzidi), dtype=dtype, device=device)
                  if bouzidi else None)
            m = maps[device] = (torch.as_tensor(domain.map.astype(np.int64), device=device), bz)
        return m

    def _stream_in(f, parity, masks, thetas, fpad=None):
        """Post-streaming DFs at every site, with the outflow and Bouzidi
        pull rules; ``fpad``: f with its halo, by default the lattice's pad."""
        if cfg.streaming == "AA" and parity == 0:
            return f  # even step: same site, same direction
        if fpad is None:
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
        if thetas is not None:
            def shifted(q, offs):
                return stream._shift_slices(fpad[q], offs, S)

            f_in = torch.where(masks[GEO.FLUID_NEAR_WALL],
                               stream.bouzidi(lat, shifted, f_in, thetas), f_in)
        return f_in

    def _transformed(f, parity, masks, thetas, fpad=None):
        """The pulled DFs after the pure f transforms (WALL swap, symmetry mirrors)."""
        f_in = _stream_in(f, parity, masks, thetas, fpad)
        if GEO.WALL in codes:
            f_in = bc.apply_bounce_back(lat, f_in, masks[GEO.WALL])
        for c in sym_codes:
            axis, sign = bc.sym_table(D)[c]
            f_in = bc.apply_symmetry(lat, f_in, masks[c], axis, sign)
        return f_in

    def _fluid(masks, device):
        m = masks.get(GEO.FLUID)
        return m if m is not None else torch.zeros(S, dtype=torch.bool, device=device)

    def collide(f, nu, u_in=None, force=None, parity: int = 0, hook_consts=None, map_arr=None,
                bouzidi_arr=None, fpad=None):
        """The step up to the collision: (f_post, rho, u, masks)."""
        map_arr, thetas = _map(f.device, map_arr, bouzidi_arr)
        masks = {c: map_arr == int(c) for c in codes}
        do_coll = torch.isin(map_arr, torch.as_tensor(do_coll_codes, device=f.device))

        f_in = _transformed(f, parity, masks, thetas, fpad)
        u_in_b = as_vector(lat, u_in, dtype, f.device) if u_in is not None else None
        force_b = as_vector(lat, force, dtype, f.device) if force is not None else None

        # the forcing hook (e.g. the non-Newtonian div(S) force), evaluated on
        # the u* moments and folded into the total force of the final moments
        # and the collision
        hook = cfg.forcing_hook
        if hook is not None:
            rho0, u0 = mom.density_velocity(lat, f_in, force=force_b, well=cfg.well,
                                            high_precision=cfg.high_precision_rho)
            kw = {"consts": hook_consts} if getattr(hook, "consts", None) is not None else {}
            extra = hook(lat, rho0, u0, nu, _fluid(masks, f.device), **kw)
            force_b = extra if force_b is None else force_b + extra

        rho, u = mom.density_velocity(lat, f_in, force=force_b, well=cfg.well,
                                      high_precision=cfg.high_precision_rho)

        f_in, rho, u = bc.apply_moment_bcs(lat, codes, masks, f_in, rho, u, u_in_b,
                                           lambda r, v: cfg.eq(lat, r, v).to(dtype), cfg.well)

        one = torch.ones((), dtype=dtype, device=f.device)
        rho_safe = torch.where(rho == 0, one, rho)
        f_post = cfg.collision(lat, f_in, rho_safe, u, nu, force=force_b)
        f_post = torch.where(do_coll, f_post, f_in)

        rho_out, u_out = rho, u
        for c in (GEO.WALL, GEO.NOTHING):
            if c in codes:
                rho_out = torch.where(masks[c], one, rho_out)
                u_out = torch.where(masks[c], torch.zeros_like(u), u_out)
        return f_post, rho_out, u_out, masks

    def stream_out(f, f_post, masks, parity: int = 0, post_pad=None):
        """The new state from ``collide``'s f_post: the A-A push (its odd
        step from ``post_pad``, by default the lattice's pad of f_post)."""
        if cfg.streaming == "AA":
            if parity == 0:
                f_out = f_post[torch.tensor(opp.tolist(), dtype=torch.long, device=f.device)]
            else:
                # push = pull of the edge/wrap-padded post-collision field
                if post_pad is None:
                    post_pad = stream.pad_halo(f_post, domain.periodic)
                f_out = stream.pull(lat, post_pad, S)
        else:
            f_out = f_post

        # inert ghost sites keep their previous DFs (reference bc.h:54-61,254-257)
        if GEO.NOTHING in codes:
            f_out = torch.where(masks[GEO.NOTHING], f, f_out)
        return f_out.contiguous()

    def step(f, nu, u_in=None, force=None, parity: int = 0, hook_consts=None, map_arr=None,
             bouzidi_arr=None):
        f_post, rho, u, masks = collide(f, nu, u_in, force, parity, hook_consts, map_arr,
                                        bouzidi_arr)
        return stream_out(f, f_post, masks, parity), rho, u

    def ustar(f, force=None, parity: int = 0, map_arr=None, bouzidi_arr=None):
        """The u* pass: (rho0, u0, fluid) - the moments with the body force
        of the pulled, wall/symmetry-transformed DFs, before the
        inflow/outflow macro overrides (the hook's input in ``step``)."""
        map_arr, thetas = _map(f.device, map_arr, bouzidi_arr)
        masks = {c: map_arr == int(c) for c in codes}
        f_in = _transformed(f, parity, masks, thetas)
        force_b = as_vector(lat, force, dtype, f.device) if force is not None else None
        rho0, u0 = mom.density_velocity(lat, f_in, force=force_b, well=cfg.well,
                                        high_precision=cfg.high_precision_rho)
        return rho0, u0, _fluid(masks, f.device)

    step.ustar = ustar
    step.collide, step.stream_out = collide, stream_out
    step.pull_comps = comps_pull_aa if cfg.streaming == "AA" else comps_pull
    return step
