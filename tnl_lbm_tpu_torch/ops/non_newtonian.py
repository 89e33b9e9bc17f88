"""Non-Newtonian rheology: strain-rate tensor, effective viscosity, forcing
(counterpart of ``tnl_lbm_tpu/ops/non_newtonian.py``).

Analog of the reference nonNewtonian.h: a strain-rate tensor S from velocity
differences with wall-aware one-sided/central stencils (reference
nonNewtonian.h:274-391), an effective viscosity from the Carreau-Yasuda
(USE_CYMODEL) or Casson (USE_CASSON) model, and the body force
F = 2 (nu_eff - nu) rho div(S) (MacroNonNewtonianDefault::computeForcing,
reference nonNewtonian.h:690-788).

The force is a *forcing hook* (``LBMConfig.forcing_hook``): the plain step
evaluates it on the u* moments (the streamed, wall-transformed moments with
the homogeneous force) and adds it to the force of the final moments and
the collision.  ``make_nn_forcing_hook`` is also the plain version of the
NN force kernel (B9, ``kernels/fused_nn.py``): every neighbour read goes to
the neighbour coordinate under the hook's own periodicity - wrapped on a
periodic axis, clamped to the edge otherwise - for u, the fluid mask and S.
"""

from __future__ import annotations

import dataclasses

import torch

from tnl_lbm_tpu_torch.models import LatticeDescriptor


@dataclasses.dataclass(frozen=True)
class CarreauYasuda:
    """nu_eff = nu + (nu0 - nu) (1 + (gamma lambda)^a)^((n-1)/a)
    (reference nonNewtonian.h:770-772)."""

    nu0: float
    lam: float
    a: float
    n: float

    def __call__(self, nu, gamma):
        return nu + (self.nu0 - nu) * (1 + (gamma * self.lam) ** self.a) ** ((self.n - 1) / self.a)


@dataclasses.dataclass(frozen=True)
class Casson:
    """nu_eff = (k0 + k1 sqrt(gamma))^2 / sqrt(gamma), guarded at rest
    (reference nonNewtonian.h:773-780)."""

    k0: float
    k1: float

    def __call__(self, nu, gamma):
        sg = torch.sqrt(gamma)
        safe = torch.clamp_min(sg, 1e-10)
        nu_c = (self.k0 + self.k1 * sg) ** 2 / safe
        return torch.where(sg > 1e-10, nu_c, nu if torch.is_tensor(nu) else
                           torch.full_like(nu_c, nu))


def _pad1(field: torch.Tensor, D: int, periodic=None) -> torch.Tensor:
    """1-halo pad on the D spatial axes of [*S] or [C, *S]: edge-replicate,
    wrapped on the axes flagged periodic (the reference's MPI halo
    semantics, nonNewtonian.h:216-391)."""
    per = tuple(periodic) if periodic is not None else (False,) * D
    for a in range(D):
        dim = field.ndim - D + a
        n = field.shape[dim]
        if per[a]:
            lo, hi = field.narrow(dim, n - 1, 1), field.narrow(dim, 0, 1)
        else:
            lo, hi = field.narrow(dim, 0, 1), field.narrow(dim, n - 1, 1)
        field = torch.cat([lo, field, hi], dim=dim)
    return field


def _neighbor(fieldpad: torch.Tensor, D: int, axis: int, shift: int, shape) -> torch.Tensor:
    index = [slice(None)] * (fieldpad.ndim - D) + [slice(1, 1 + n) for n in shape]
    index[fieldpad.ndim - D + axis] = slice(1 + shift, 1 + shift + shape[axis])
    return fieldpad[tuple(index)]


def _wall_aware_derivative(gpad, fluid_p, fluid_m, D, axis, shape, center):
    """d/d(axis) with one-sided differences at walls (reference
    nonNewtonian.h:326-391 neighbour-fluidity switch)."""
    gp = _neighbor(gpad, D, axis, +1, shape)
    gm = _neighbor(gpad, D, axis, -1, shape)
    fwd = gp - center
    bwd = center - gm
    cen = 0.5 * (gp - gm)
    both = fluid_p & fluid_m
    onlyp = fluid_p & ~fluid_m
    onlym = ~fluid_p & fluid_m
    zero = torch.zeros_like(center)
    return torch.where(both, cen, torch.where(onlyp, fwd, torch.where(onlym, bwd, zero)))


def _fluid_neighbours(fluid_mask, D, periodic, shape) -> dict:
    fpad = _pad1(fluid_mask, D, periodic)
    return {(a, s): _neighbor(fpad, D, a, s, shape) for a in range(D) for s in (+1, -1)}


def strain_rate_tensor(u: torch.Tensor, fluid_mask: torch.Tensor, D: int = 3, periodic=None):
    """Symmetric strain-rate components from velocity differences.

    Returns a dict keyed (a, b), a <= b.  Components are zero where the
    required neighbours are not fluid, matching the reference's stencil;
    ``periodic`` wraps the flagged axes (see ``_pad1``).
    """
    shape = tuple(u.shape[1:])
    upad = _pad1(u, D, periodic)
    fl = _fluid_neighbours(fluid_mask, D, periodic, shape)
    grad = {}
    for a in range(D):       # derivative axis
        for b in range(D):   # velocity component
            grad[(a, b)] = _wall_aware_derivative(upad[b], fl[(a, +1)], fl[(a, -1)], D, a,
                                                  shape, u[b])
    S = {}
    for a in range(D):
        for b in range(a, D):
            S[(a, b)] = 0.5 * (grad[(a, b)] + grad[(b, a)]) if a != b else grad[(a, a)]
    return S


def shear_rate_magnitude(S: dict, D: int = 3) -> torch.Tensor:
    """gamma = sqrt(S11^2 + S22^2 + S33^2 + 2 (S12^2 + S13^2 + S23^2))
    (reference nonNewtonian.h:762)."""
    diag = sum(S[(a, a)] ** 2 for a in range(D))
    off = sum(S[(a, b)] ** 2 for a in range(D) for b in range(a + 1, D))
    return torch.sqrt(diag + 2 * off)


def make_nn_forcing_hook(model, nu: float | None = None, periodic=None):
    """Build the forcing hook: F = 2 (nu_eff - nu) rho div(S).

    ``periodic`` (e.g. ``domain.periodic``) wraps the stencils across the
    flagged axes; without it the seams edge-replicate (wrong for periodic
    domains - pass it whenever the domain has periodic axes).  ``model`` is
    a CarreauYasuda or Casson instance.  Use as
    ``LBMConfig(..., forcing_hook=make_nn_forcing_hook(model))``.

    The hook carries ``nn_model`` and ``nn_periodic``: the kernel routes
    (``kernels/hooked.py``) dispatch on them to the NN force kernel (B9)
    and the one-kernel NN step (B10), which compute this hook in CUDA.
    """
    del nu  # the lattice viscosity is the hook's argument, as in the JAX package

    def hook(lat: LatticeDescriptor, rho, u, nu_lattice, fluid_mask):
        D = lat.D
        shape = tuple(u.shape[1:])
        S = strain_rate_tensor(u, fluid_mask, D, periodic)
        gamma = shear_rate_magnitude(S, D)
        nu_eff = model(nu_lattice, gamma)
        fl = _fluid_neighbours(fluid_mask, D, periodic, shape)
        rows = []
        zero = torch.zeros_like(rho)
        for b in range(D):  # force component
            div_b = 0.0
            for a in range(D):  # derivative axis
                s_ab = S[(min(a, b), max(a, b))]
                div_b = div_b + _wall_aware_derivative(_pad1(s_ab, D, periodic), fl[(a, +1)],
                                                       fl[(a, -1)], D, a, shape, s_ab)
            rows.append(torch.where(fluid_mask, 2 * (nu_eff - nu_lattice) * div_b * rho, zero))
        return torch.stack(rows)

    hook.nn_model = model
    hook.nn_periodic = periodic
    return hook


def _clamp_closed(t: torch.Tensor, closed, off: int, lead: int) -> torch.Tensor:
    """``t`` (x/y at dims lead, lead + 1; the block ``off`` layers from each
    side) with the layers beyond each closed face (x low, x high, y low, y
    high) replaced by the face's edge layer: the coordinate clamped."""
    t = t.clone()
    for i, c in enumerate(closed):
        if not c or off == 0:
            continue
        d = lead + i // 2
        n = t.shape[d]
        if i % 2 == 0:
            t.narrow(d, 0, off).copy_(t.narrow(d, off, 1).expand_as(t.narrow(d, 0, off)))
        else:
            t.narrow(d, n - off, off).copy_(
                t.narrow(d, n - off - 1, 1).expand_as(t.narrow(d, n - off, off)))
    return t


def _pad_z(t: torch.Tensor, periodic_z: bool) -> torch.Tensor:
    """A 1-layer pad of the last axis (z): wrapped, or the edge replicated."""
    n = t.shape[-1]
    lo, hi = ((t.narrow(-1, n - 1, 1), t.narrow(-1, 0, 1)) if periodic_z
              else (t.narrow(-1, 0, 1), t.narrow(-1, n - 1, 1)))
    return torch.cat([lo, t, hi], dim=-1)


def nn_force_haloed(model, rho, u, nu_lattice, fluid_mask, closed, periodic_z=False,
                    ring: int = 0):
    """The forcing hook of ``make_nn_forcing_hook`` on a shard's block and its
    ``ring``-site x/y ring (the plain version of the NN kernels' haloed mode):
    ``u`` [3, ...] and ``fluid_mask`` hold that region with a 2-wide x/y halo
    of the neighbour shards' values, ``rho`` the region itself.  On a closed
    face (``closed``: x low, x high, y low, y high; a face of the domain the
    hook does not wrap) u, the mask and S take the edge layer's values, the
    hook's edge replication; z is padded by the hook's own rule.  The sums
    and products are the hook's, site by site."""
    D = 3
    E = ring + 2  # the block's offset in u and the mask
    u = _clamp_closed(u, closed, E, 1)
    fl = _clamp_closed(fluid_mask, closed, E, 0)
    shape_s = (u.shape[1] - 2, u.shape[2] - 2, u.shape[3])
    upz, flz = _pad_z(u, periodic_z), _pad_z(fl, periodic_z)
    fl_s = {(a, s): _neighbor(flz, D, a, s, shape_s) for a in range(D) for s in (+1, -1)}
    center = u[:, 1:-1, 1:-1]
    grad = {(a, b): _wall_aware_derivative(upz[b], fl_s[(a, +1)], fl_s[(a, -1)], D, a, shape_s,
                                           center[b])
            for a in range(D) for b in range(D)}
    S = {}
    for a in range(D):
        for b in range(a, D):
            S[(a, b)] = 0.5 * (grad[(a, b)] + grad[(b, a)]) if a != b else grad[(a, a)]
    S = {k: _clamp_closed(v, closed, E - 1, 0) for k, v in S.items()}
    S_c = {k: v[1:-1, 1:-1] for k, v in S.items()}
    gamma = shear_rate_magnitude(S_c, D)
    nu_eff = model(nu_lattice, gamma)
    shape_f = tuple(rho.shape)
    fl_f = {(a, s): _neighbor(_pad_z(fl[1:-1, 1:-1], periodic_z), D, a, s, shape_f)
            for a in range(D) for s in (+1, -1)}
    fluid_c = fl[2:-2, 2:-2]
    rows = []
    zero = torch.zeros_like(rho)
    for b in range(D):
        div_b = 0.0
        for a in range(D):
            k = (min(a, b), max(a, b))
            div_b = div_b + _wall_aware_derivative(_pad_z(S[k], periodic_z), fl_f[(a, +1)],
                                                   fl_f[(a, -1)], D, a, shape_f, S_c[k])
        rows.append(torch.where(fluid_c, 2 * (nu_eff - nu_lattice) * div_b * rho, zero))
    return torch.stack(rows)
