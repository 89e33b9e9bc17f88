"""The D3Q7 advection-diffusion (ADE) step in plain PyTorch (counterpart of
``tnl_lbm_tpu/sim/step_ade.py``; reference kernels.h:153-176 with d3q7/bc.h).

The advecting velocity comes from the NSE lattice.  The boundary set holds
conjugate heat/mass transfer between the fluid and solid phases
(TRANSFER_FS/SF/SW with per-direction interface flags and a transfer
coefficient, reference d3q7/bc.h:142-189), anti-bounce-back walls with the
site's own concentration (WALL_BODY, Krueger sect. 8.5.2.1; reference
d3q7/bc.h:101-115) and the Peclet-extrapolation outflow (OUTFLOW_PE,
reference d3q7/bc.h:85-89).  The diffusion coefficient may be a per-site
field (reference lbm_data.h:133-165 ADE_Data).

This is the port's CPU path and its test oracle; the per-site form of the
same rules is ``csrc/ade_site.cuh``.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from tnl_lbm_tpu_torch.ops import moments as mom
from tnl_lbm_tpu_torch.ops import streaming as stream
from tnl_lbm_tpu_torch.sim.config import Domain, LBMConfig


class ADEGEO(enum.IntEnum):
    """Geometry codes for the ADE lattice (reference d3q7/bc.h:17-37)."""

    FLUID = 0
    WALL = 1
    WALL_BODY = 2
    SOLID = 3
    TRANSFER_FS = 4
    TRANSFER_SF = 5
    TRANSFER_SW = 6
    INFLOW = 7
    OUTFLOW_RIGHT = 8
    PERIODIC = 9
    NOTHING = 10
    OUTFLOW_PE = 11
    SYM_TOP = 12
    SYM_BOTTOM = 13
    SYM_LEFT = 14
    SYM_RIGHT = 15
    SYM_BACK = 16
    SYM_FRONT = 17


#: codes belonging to the solid phase (reference d3q7/bc.h:59-62)
SOLID_PHASE = {ADEGEO.SOLID, ADEGEO.TRANSFER_SF, ADEGEO.TRANSFER_SW}

#: codes on which the collision runs
_COLLIDING = {
    ADEGEO.FLUID, ADEGEO.PERIODIC, ADEGEO.SOLID,
    ADEGEO.TRANSFER_FS, ADEGEO.TRANSFER_SF, ADEGEO.TRANSFER_SW,
    ADEGEO.OUTFLOW_RIGHT,
}

#: SYM code -> (axis, sign of the replaced components); D3Q7 mirrors one face DF
_SYM = {
    ADEGEO.SYM_TOP: (2, -1),
    ADEGEO.SYM_BOTTOM: (2, +1),
    ADEGEO.SYM_LEFT: (0, +1),
    ADEGEO.SYM_RIGHT: (0, -1),
    ADEGEO.SYM_BACK: (1, +1),
    ADEGEO.SYM_FRONT: (1, -1),
}

#: the conjugate-transfer codes
TRANSFER_CODES = {ADEGEO.TRANSFER_FS, ADEGEO.TRANSFER_SF, ADEGEO.TRANSFER_SW}


def pad_edge_or_wrap(g: torch.Tensor, periodic, widths) -> torch.Tensor:
    """Pad the spatial axes of ``g [Q, *S]`` by ``widths[a]`` on both sides:
    wrapped on periodic axes, edge-replicated otherwise."""
    for axis, (w, per) in enumerate(zip(widths, periodic)):
        if w == 0:
            continue
        dim = axis + 1
        n = g.shape[dim]
        if per:
            lo, hi = g.narrow(dim, n - w, w), g.narrow(dim, 0, w)
        else:
            lo = g.narrow(dim, 0, 1).expand_as(g.narrow(dim, 0, w))
            hi = g.narrow(dim, n - 1, 1).expand_as(g.narrow(dim, 0, w))
        g = torch.cat([lo, g, hi], dim=dim)
    return g


def _pull_offset(lat, g, periodic, shape, extra_dx):
    """Standard pull with every x offset shifted by ``extra_dx``.

    The x offsets reach ``-1 + extra_dx`` (= -2 for the Peclet outflow), so
    this pads its own 2-wide x halo.
    """
    widths = (2,) + (1,) * (len(shape) - 1)
    gpad = pad_edge_or_wrap(g, periodic, widths)
    out = []
    for q in range(lat.Q):
        off = [-int(c) for c in lat.c[q]]
        off[0] += extra_dx
        index = tuple(slice(w + o, w + o + n) for w, o, n in zip(widths, off, shape))
        out.append(gpad[(q,) + index])
    return torch.stack(out)


def make_ade_step(cfg: LBMConfig, domain: Domain, pad_halo=None, local_shape=None):
    """Build ``step(g, u, nu, phi_in=None, transfer_dirs=None,
    transfer_coeff=0, parity=0, map_arr=None) -> (g_new, phi)``.

    ``u`` is the advecting velocity field [3, *S] (from the NSE lattice);
    ``transfer_dirs`` is a bool field [Q-1, *S] (per non-rest direction,
    ordered like lat.names[1:]) marking links that cross the phase
    interface.  ``phi_in=None`` leaves the INFLOW sites as streamed.  The
    sharded knobs ``pad_halo`` and ``local_shape`` are not ported yet
    (ROADMAP A13b).
    """
    if pad_halo is not None or local_shape is not None:
        raise NotImplementedError("pad_halo / local_shape (the sharded ADE step) are not "
                                  "ported yet (ROADMAP A13b)")
    lat = cfg.lat
    S = domain.shape
    dtype = cfg.compute_dtype
    codes = domain.codes_present()
    opp = np.asarray(lat.opp)
    sym_codes = sorted(c for c in codes if c in _SYM)
    do_coll_codes = sorted(int(c) for c in (_COLLIDING & codes))
    if cfg.streaming == "AA" and ADEGEO.OUTFLOW_PE in codes:
        raise NotImplementedError("OUTFLOW_PE requires the A-B pattern")
    periodic = domain.periodic

    def halo(f):
        return stream.pad_halo(f, periodic)

    def step(g, u, nu, phi_in=None, transfer_dirs=None, transfer_coeff=0.0,
             parity: int = 0, map_arr=None):
        if map_arr is None:
            map_arr = torch.as_tensor(domain.map.astype(np.int64), device=g.device)
        masks = {c: map_arr == int(c) for c in codes}
        do_coll = torch.isin(map_arr, torch.as_tensor(do_coll_codes, device=g.device,
                                                      dtype=map_arr.dtype))
        g_old = g

        # streaming (A-B pull or A-A parity, like the NSE step)
        if cfg.streaming == "AA" and parity == 0:
            f_in = g
        else:
            gpad = halo(g)
            if cfg.streaming == "AA":
                f_in = stream.pull_from(lat, gpad, S, opp)
            else:
                f_in = stream.pull(lat, gpad, S)
            if ADEGEO.OUTFLOW_RIGHT in codes:
                # every direction from x-1, from the slot the pattern reads (A-A
                # odd: the opposite one, as the NSE step and B8 read it; the JAX
                # plain ADE step reads the site's own slot there)
                src = opp if cfg.streaming == "AA" else None
                f_in = torch.where(masks[ADEGEO.OUTFLOW_RIGHT],
                                   stream.pull_shift_x(lat, gpad, S, dx=-1, src_perm=src), f_in)
            if ADEGEO.OUTFLOW_PE in codes:
                f_in = torch.where(masks[ADEGEO.OUTFLOW_PE],
                                   _pull_offset(lat, g, periodic, S, -1), f_in)

        # wall bounce-back (swap all opposite pairs)
        opp_t = torch.as_tensor(opp.tolist(), dtype=torch.long, device=g.device)
        for wall_code in (ADEGEO.WALL, ADEGEO.WALL_BODY):
            if wall_code in codes:
                f_in = torch.where(masks[wall_code], f_in[opp_t], f_in)
        if ADEGEO.WALL_BODY in codes:
            # anti-bounce-back with the site's pre-streaming phi
            # (reference d3q7/bc.h:101-115)
            w = torch.tensor(np.asarray(lat.w).tolist(), dtype=dtype,
                             device=g.device).reshape((lat.Q,) + (1,) * len(S))
            phi_prev = mom.density(lat, g_old)
            f_in = torch.where(masks[ADEGEO.WALL_BODY], -f_in + 2 * w * phi_prev, f_in)

        for c in sym_codes:
            axis, sign = _SYM[c]
            mirror = torch.as_tensor(np.asarray(lat.mirror(axis)).tolist(), dtype=torch.long,
                                     device=g.device)
            qsel = torch.as_tensor(lat.c[:, axis] == sign,
                                   device=g.device).reshape((lat.Q,) + (1,) * len(S))
            f_in = torch.where(masks[c] & qsel, f_in[mirror], f_in)

        # conjugate transfer BCs (reference d3q7/bc.h:142-189)
        if codes & TRANSFER_CODES and transfer_dirs is not None:
            phi_tot = mom.density(lat, g_old)  # per-site scalar, pre-streaming
            phipad = halo(phi_tot[None])[0]
            rows = [f_in[0]]
            for q in range(1, lat.Q):
                qo = int(opp[q])
                # f_in[q] was pulled from x - c_q; the link flag is stored for
                # the outgoing direction opp(q)
                flag = transfer_dirs[qo - 1]
                nb_phi = stream._shift_slices(phipad, [-int(c) for c in lat.c[q]], S)
                reflected = g_old[qo]
                fs_sf = reflected + transfer_coeff * (nb_phi - phi_tot)
                row = f_in[q]
                for code, repl in ((ADEGEO.TRANSFER_FS, fs_sf), (ADEGEO.TRANSFER_SF, fs_sf),
                                   (ADEGEO.TRANSFER_SW, reflected)):
                    if code in codes:
                        row = torch.where(masks[code] & flag, repl, row)
                rows.append(row)
            f_in = torch.stack(rows)

        phi = mom.density(lat, f_in)

        if ADEGEO.INFLOW in codes and phi_in is not None:
            m = masks[ADEGEO.INFLOW]
            phi_b = torch.as_tensor(phi_in, dtype=dtype, device=g.device)
            feq_in = cfg.eq(lat, phi_b, u).to(dtype)
            f_in = torch.where(m, feq_in, f_in)
            phi = torch.where(m, phi_b.expand_as(phi), phi)
        if ADEGEO.OUTFLOW_PE in codes:
            f_in = torch.where(masks[ADEGEO.OUTFLOW_PE], cfg.eq(lat, phi, u), f_in)

        f_post = cfg.collision(lat, f_in, phi, u, nu)
        f_post = torch.where(do_coll, f_post, f_in)

        if cfg.streaming == "AA":
            if parity == 0:
                g_out = f_post[opp_t]
            else:
                g_out = stream.pull(lat, halo(f_post), S)
        else:
            g_out = f_post

        if ADEGEO.NOTHING in codes:
            g_out = torch.where(masks[ADEGEO.NOTHING], g_old, g_out)
            phi = torch.where(masks[ADEGEO.NOTHING], torch.zeros_like(phi), phi)
        return g_out.contiguous(), phi

    return step


def transfer_direction_flags(lat, map_arr: np.ndarray) -> np.ndarray:
    """The per-direction interface flags of the transfer BCs.

    Flag[q-1, x] is True when the link from site x in direction q crosses
    the fluid/solid phase boundary (reference lbm_block helper that fills
    ADE_Data::phiTransferDirection).
    """
    solid = np.isin(map_arr, [int(c) for c in SOLID_PHASE])
    flags = np.zeros((lat.Q - 1,) + map_arr.shape, dtype=bool)
    for q in range(1, lat.Q):
        shifted = solid
        for a, c in enumerate(lat.c[q]):
            shifted = np.roll(shifted, -int(c), axis=a)
        flags[q - 1] = shifted != solid
    return flags
