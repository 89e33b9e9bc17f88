"""Wu-Shu velocity-correction IBM (counterpart of ``tnl_lbm_tpu/ibm/lagrange.py``).

Analog of the reference ``Lagrange3D<LBM>`` (reference: lagrange_3D.h:39-153,
lagrange_3D.hpp): Lagrangian points immersed in the Eulerian lattice; each
step solves for boundary forces such that the interpolated fluid velocity at
the points matches the target (zero or prescribed) velocity, then spreads
those forces back to the lattice.

The design is the JAX package's:

- All sparse STRUCTURE is built once (the cloud is static): the stencils
  and their weights on the host, the neighbour lists, the pair values and
  the node-space Gram on the solver's device (``ibm/sparse.py``), then kept
  there as tensors (the ``hook_consts`` dict).
- The per-step solve runs in the SMALLER of point space and node space.
  With W the [m, u] interpolation matrix over the u unique stencil nodes,
  the physics consumes only y = W^T x of the solution of (W W^T) x = b,
  and y = (W^T W)^+ W^T b exactly (Moore-Penrose).  Points denser than
  the lattice solve with the dense node-space Gram B = W^T W; sparse
  clouds solve in point space with the "modified" hat-kernel A or the
  "original" Gram G = W W^T as ELLPACK matrices, or matrix-free.
- CG is Jacobi-preconditioned (reference lagrange_3D.hpp:899-906).

The dense products (B's build and B v) run in full float32, as the JAX
package's ``Precision.HIGHEST``: under ``full_fp32_matmul`` whatever the
caller set for TF32.  The CG loop reads its condition on the host before
every iteration, as the JAX ``while_loop`` tests it.  On the card the
loop is bound by the host's launches (about 40 small kernels an
iteration), not by that read: a loop that masked its updates with the
condition on the device and read it every 2, 4 or 8 iterations ran more
kernels and took longer on an H100 (PERF.md §6).  A hook that reads
the host cannot be captured in a CUDA graph: the hook of ``forcing_hook``
says so (``reads_host``), and the driver runs a chunk of its steps eagerly
(``sim/state.py``).

The sharded methods (JAX ``lagrange.py:628-740``: ``sharded_hook``,
``compute_forces_sharded``, ``interpolate_sharded``, ``spread_sharded``) keep
the cloud and the compact solve on the solver's device and partition the
Eulerian work by node ownership: a stencil node belongs to the one shard
whose block holds it, each shard samples and spreads its own nodes, and the
JAX ``psum`` over the mesh is a sum of the shards' partial sums on the plan's
first device, in shard order (so a sharded run adds in another order than
the unsharded one: equal to float tolerance, not bit for bit).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from tnl_lbm_tpu_torch.ibm.dirac import SUPPORT, dirac_delta, dirac_delta_3d, dirac_support
from tnl_lbm_tpu_torch.ibm.sparse import neighbor_pairs, pack_ellpack, unique_nodes
from tnl_lbm_tpu_torch.sim.state import resolve_device
from tnl_lbm_tpu_torch.utils.logging_utils import get_logger

@contextlib.contextmanager
def full_fp32_matmul():
    """float32 matmuls in full float32 (no TF32) inside the block, whatever
    the caller set; the caller's setting is restored after it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


class IBM:
    """Immersed boundary solver for a static Lagrangian point cloud."""

    #: "auto" method threshold: "modified" up to here, "original" beyond.
    #: The JAX package's value: the two methods solve different systems, so
    #: "auto" picks the JAX package's operator for the same cloud.
    DENSE_A_MAX_POINTS = 32768

    #: largest node count for which the node-space Gram B = W^T W is
    #: materialized densely ([u, u] f32; 32768 -> 4.3 GB); the JAX value,
    #: for the same reason.
    NODE_DENSE_CAP = 32768

    def __init__(
        self,
        units,
        points_phys: np.ndarray,
        dirac: str = "phi2",
        method: str = "auto",
        max_iters: int = 10000,
        tol: float = 3e-4,
        use_ll_velocity: bool = False,
        dirac_ll: str = "phi3",
        *,
        device,
    ):
        """Args:
        units: Lattice unit system (phys <-> lattice transforms).  Its
          ``global_size`` is the production grid: the compact (unique-node)
          operators are built for it; calls on other shapes take the
          generic gather/scatter path.
        points_phys: [m, 3] Lagrangian points in physical coordinates.
        dirac: kernel name phi1..phi4 (reference lagrange_3D.h:114-115).
        method: "auto" | "modified" | "original" (reference
          lagrange_3D.hpp:265-331); "auto" is "modified" up to
          ``DENSE_A_MAX_POINTS`` points and "original" beyond.
        max_iters/tol: CG parameters (reference lagrange_3D.hpp:899-906
          uses maxIter 10000, residue 3e-4).
        dirac_ll: kernel for the POINT-POINT matrix of the "modified"
          method, the hat by default (reference ``diracDeltaTypeLL = 1``,
          lagrange_3D.h:115): positive definite at sub-grid point spacing,
          where the wide kernels give an indefinite A.
        device: where the operators live and the solve runs; ``cuda``
          without a card raises.
        """
        self.units = units
        self.dirac = dirac
        self.dirac_ll = dirac_ll
        self.method = method
        self.max_iters = max_iters
        self.tol = tol
        self.use_ll_velocity = use_ll_velocity
        self.device = resolve_device(device)
        self.log = get_logger("ibm")
        self.grid_shape = tuple(int(x) for x in units.global_size)
        self.last_cg_iters = None
        self.last_cg_residual = None

        pts = np.asarray(points_phys, np.float64).reshape(-1, 3)
        self.points_phys = pts
        # lattice coordinates (reference lagrange_3D.hpp:102-119)
        self.ll_lat = np.stack([units.phys2lbm_x(pts[:, a], a) for a in range(3)], axis=-1)
        self.m = len(pts)
        self.prescribed_velocity = np.zeros((self.m, 3))

        t0 = time.perf_counter()
        self._build_stencils()
        self._build_operators()
        self.log.info(
            '{"ibm": "constructMatrices", "points": %d, "dirac": "%s", "method": "%s", '
            '"space": "%s", "unique_nodes": %d, "wall_s": %.4f}',
            self.m, dirac, self.method, self.space, self.u,
            time.perf_counter() - t0,
        )

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------- geometry
    def _build_stencils(self):
        s = dirac_support(self.dirac)
        base = np.floor(self.ll_lat - (s / 2 - 1)).astype(np.int64)  # lowest stencil node
        offs = np.stack(np.meshgrid(*([np.arange(s)] * 3), indexing="ij"), axis=-1).reshape(-1, 3)
        nodes = base[:, None, :] + offs[None, :, :]  # [m, s^3, 3]
        d = self.ll_lat[:, None, :] - nodes  # distances in lattice units
        # each axis in float32 on the host, the product in float32 (the JAX
        # package's x64-off evaluation); the same weights on every device
        d32 = torch.as_tensor(d, dtype=torch.float32)
        w = (dirac_delta(self.dirac, d32[..., 0]) * dirac_delta(self.dirac, d32[..., 1])
             * dirac_delta(self.dirac, d32[..., 2])).numpy()
        self.stencil_nodes = nodes  # [m, s^3, 3] int lattice indices
        self._w_np = w
        self.weights = self._tensor(w, torch.float32)  # [m, s^3]
        self.nodes = self._tensor(nodes, torch.int64)

        # compact (unique-node) structure for the production grid shape
        uflat_np, uid_np = unique_nodes(nodes, self.grid_shape)
        # prune numerically-empty nodes: a unique node whose total squared
        # weight is ~0 (points exactly at the support boundary) carries no
        # physics but puts a ~1e-24 entry on diag(B), exploding the Jacobi
        # preconditioner in f32.  Slots of pruned nodes keep their (tiny)
        # weights and remap to node 0 - error bounded by the threshold.
        colnorm = np.zeros(len(uflat_np), np.float64)
        np.add.at(colnorm, uid_np.reshape(-1), (w.reshape(-1) ** 2))
        keep = colnorm > 1e-16 * max(colnorm.max(initial=0.0), 1e-300)
        if not keep.all():
            remap = np.zeros(len(uflat_np), np.int64)
            remap[keep] = np.arange(int(keep.sum()))
            uflat_np = uflat_np[keep]
            uid_np = remap[uid_np].astype(np.int32)
        self.u = len(uflat_np)
        self._uflat_np = uflat_np
        self._uid_np = uid_np
        self.uflat = self._tensor(uflat_np, torch.int64)
        self.uid = self._tensor(uid_np, torch.int64)
        self.unodes = self._tensor(
            np.stack(np.unravel_index(uflat_np.astype(np.int64), self.grid_shape), axis=-1),
            torch.int64)
        lo, hi = nodes.min(axis=(0, 1)), nodes.max(axis=(0, 1))
        self._clipped = bool((lo < 0).any() or (hi >= np.asarray(self.grid_shape)).any())

    # ------------------------------------------------------------ operators
    def _build_operators(self):
        if self.method == "auto":
            self.method = "modified" if self.m <= self.DENSE_A_MAX_POINTS else "original"
            self.log.info("IBM: method 'auto' -> '%s' for %d points", self.method, self.m)

        self.B = None          # node-space Gram W^T W  [u, u]
        self.E_idx = None      # point-space ELLPACK (A or G)
        self.E_val = None
        self.diag = None       # Jacobi preconditioner of the active system

        if self.method == "modified":
            # A[k,l] = 3D dirac of point pairs with the LL kernel (hat by
            # default; reference lagrange_3D.hpp:265-295 + diracDeltaTypeLL)
            # as a neighbour list + ELLPACK
            self.space = "point"
            ks, ls = neighbor_pairs(self.ll_lat, float(SUPPORT[self.dirac_ll]),
                                    device=self.device)
            vals = self._pair_dirac_ll(ks, ls)
            idx, val = pack_ellpack(ks, ls, vals, self.m)
            self.E_idx = self._tensor(idx, torch.int64)
            self.E_val = self._tensor(val, torch.float32)
            self.diag = self._tensor(self._ell_diag(ks, ls, vals), torch.float32)
        elif self.u <= min(self.m, self.NODE_DENSE_CAP):
            # original, dense cloud: node-space dense Gram.  B = W^T W is
            # SEMI-definite when shell-edge columns of W are nearly
            # dependent, and in node space the solution y IS the physics,
            # so null-space drift cannot be projected out downstream.
            # Hence UNPRECONDITIONED CG (diag None): its Krylov space stays
            # inside range(B) and is the W^T-image of the point-space
            # iteration's (a Jacobi preconditioner rotates out of range(B)
            # and blows the null-space forces up at sub-grid spacing).
            self.space = "node"
            self.B = self._gram_node()
        else:
            # original, sparse cloud: point-space Gram G = W W^T as ELLPACK
            self.space = "point"
            if self._clipped:
                # stencils clipped at the domain edge can make arbitrarily
                # distant points overlap on a boundary node - no finite
                # neighbour radius is safe, keep the matrix-free operator
                self.log.info("IBM: clipped stencils -> matrix-free Gram")
                self.diag = self._tensor(self._gram_diag_np(), torch.float32)
                return
            try:
                ks, ls = neighbor_pairs(self.ll_lat, 2.0 * float(SUPPORT[self.dirac]),
                                        device=self.device)
            except MemoryError:
                # cloud denser than the lattice: an explicit point-space
                # Gram is near-quadratic - solve matrix-free through the
                # compact node space instead (exact, same Krylov space)
                self.log.info(
                    "IBM: point cloud too dense for an explicit Gram "
                    "(m=%d, u=%d) -> matrix-free node-space operator", self.m, self.u)
                self.diag = self._tensor(self._gram_diag_np(), torch.float32)
                return
            vals = self._pair_gram(ks, ls)
            idx, val = pack_ellpack(ks, ls, vals, self.m, drop_below=0.0)
            self.E_idx = self._tensor(idx, torch.int64)
            self.E_val = self._tensor(val, torch.float32)
            self.diag = self._tensor(self._ell_diag(ks, ls, vals), torch.float32)

    def _ell_diag(self, ks, ls, vals):
        dsel = ks == ls
        diag = np.zeros(self.m, np.float32)
        np.add.at(diag, ks[dsel], vals[dsel].astype(np.float32))
        return diag

    def _gram_diag_np(self) -> np.ndarray:
        """diag(W W^T) including duplicate-clipped stencil slots."""
        diag = np.zeros(self.m, np.float64)
        for i in range(0, self.m, 4096):
            uid = self._uid_np[i : i + 4096]
            w = self._w_np[i : i + 4096].astype(np.float64)
            match = uid[:, :, None] == uid[:, None, :]
            diag[i : i + 4096] = (w[:, :, None] * w[:, None, :] * match).sum(axis=(1, 2))
        return diag

    def _pair_dirac_ll(self, ks, ls, chunk: int = 1 << 22) -> np.ndarray:
        """phi_ll(x_k - x_l) for pair lists, on the device in chunks."""
        ll = self._tensor(self.ll_lat, torch.float32)

        def ev(a, b):
            d = ll[a] - ll[b]
            return dirac_delta_3d(self.dirac_ll, d[:, 0], d[:, 1], d[:, 2])

        return self._chunked_pairs(ev, ks, ls, chunk)

    def _pair_gram(self, ks, ls, chunk: int = 1 << 14) -> np.ndarray:
        """(W W^T)[k,l] = sum_{s,t} w_k[s] w_l[t] [uid_k[s] == uid_l[t]].

        Exact including duplicate-clipped stencil slots (the uid match is
        over CLIPPED unique nodes, the same convention interpolate/spread
        use)."""
        uid, w = self.uid, self.weights

        def ev(a, b):
            match = uid[a][:, :, None] == uid[b][:, None, :]  # [C, s3, s3]
            return (w[a][:, :, None] * w[b][:, None, :] * match).sum(dim=(1, 2))

        return self._chunked_pairs(ev, ks, ls, chunk)

    def _chunked_pairs(self, ev, ks, ls, chunk) -> np.ndarray:
        out = np.empty(len(ks), np.float32)
        for i in range(0, len(ks), chunk):
            a = self._tensor(ks[i : i + chunk], torch.int64)
            b = self._tensor(ls[i : i + chunk], torch.int64)
            out[i : i + len(a)] = ev(a, b).cpu().numpy()
        return out

    def _gram_node(self, chunk: int = 2048) -> torch.Tensor:
        """B = W^T W [u, u] via chunked dense-W products in full float32."""
        u = self.u
        B = torch.zeros((u, u), dtype=torch.float32, device=self.device)
        rows = torch.arange(chunk, device=self.device)[:, None]
        with full_fp32_matmul():
            for i in range(0, self.m, chunk):
                uid_c, w_c = self.uid[i : i + chunk], self.weights[i : i + chunk]
                Wc = torch.zeros((len(uid_c), u), dtype=torch.float32, device=self.device)
                Wc.index_put_((rows[: len(uid_c)].expand_as(uid_c), uid_c), w_c, accumulate=True)
                B += Wc.T @ Wc
        return B

    def _spread_compact_np(self, x_pts: np.ndarray) -> np.ndarray:
        """Host W^T x: [m, C] point values -> [u, C] node values."""
        C = x_pts.shape[1]
        out = np.zeros((self.u, C), np.float64)
        contrib = self._w_np[..., None] * np.asarray(x_pts)[:, None, :]
        np.add.at(out, self._uid_np.reshape(-1), contrib.reshape(-1, C))
        return out

    def dense_A(self) -> np.ndarray:
        """Densify the point-point operator (diagnostics/tests only)."""
        if self.E_idx is None:
            raise ValueError("no ELLPACK operator (node-space solver)")
        A = np.zeros((self.m, self.m), np.float64)
        idx = self.E_idx.cpu().numpy()
        val = self.E_val.cpu().numpy().astype(np.float64)
        np.add.at(A, (np.arange(self.m)[:, None], idx), val)
        return A

    # ------------------------------------------------------------- operators
    #
    # ``consts`` protocol: every operator takes an optional dict (see
    # ``hook_consts``) overriding the solver's own tensors; the driver hands
    # the hook's dict to every step (``Simulation._hook_kwargs``), and a
    # test can hand in another build's (``interop.ibm_consts_from_numpy``).

    def hook_consts(self) -> dict:
        """The operator tensors a step receives as its ``hook_consts``."""
        # W^T v_p for the node-space prescribed-velocity RHS, computed HERE
        # (not at build) so callers that set prescribed_velocity after
        # construction get the value in effect when the hook is made
        wt_vp = None
        if self.use_ll_velocity and self.space == "node":
            wt_vp = self._tensor(self._spread_compact_np(self.prescribed_velocity),
                                 torch.float32)
        return {
            "w": self.weights, "nodes": self.nodes,
            "uflat": self.uflat, "uid": self.uid, "unodes": self.unodes,
            "B": self.B, "E_idx": self.E_idx, "E_val": self.E_val,
            "diag": self.diag, "Wt_vp": wt_vp,
        }

    def _cw(self, consts):
        consts = consts or {}
        return consts.get("w", self.weights), consts.get("nodes", self.nodes)

    def interpolate(self, field: torch.Tensor, consts=None) -> torch.Tensor:
        """M u: sample an Eulerian field [C, X, Y, Z] at the points -> [m, C]."""
        w, n = self._cw(consts)
        nx, ny, nz = field.shape[1:]
        ix = torch.clamp(n[..., 0], 0, nx - 1)
        iy = torch.clamp(n[..., 1], 0, ny - 1)
        iz = torch.clamp(n[..., 2], 0, nz - 1)
        vals = field[:, ix, iy, iz]  # [C, m, s^3]
        return torch.sum(vals * w.to(field.dtype)[None], dim=-1).T

    def spread(self, vals: torch.Tensor, shape, consts=None) -> torch.Tensor:
        """M^T x: spread point values [m, C] to an Eulerian field [C, *shape]."""
        w, n = self._cw(consts)
        nx, ny, nz = shape
        ix = torch.clamp(n[..., 0], 0, nx - 1)
        iy = torch.clamp(n[..., 1], 0, ny - 1)
        iz = torch.clamp(n[..., 2], 0, nz - 1)
        flat = (ix * ny + iy) * nz + iz  # [m, s^3]
        contrib = w.to(vals.dtype)[..., None] * vals[:, None, :]  # [m, s^3, C]
        C = vals.shape[1]
        out = torch.zeros((nx * ny * nz, C), dtype=vals.dtype, device=vals.device)
        out.index_add_(0, flat.reshape(-1), contrib.reshape(-1, C))
        return out.T.reshape((C,) + tuple(shape))

    def _ell_matvec(self, x, consts):
        idx = consts["E_idx"] if consts and consts.get("E_idx") is not None else self.E_idx
        val = consts["E_val"] if consts and consts.get("E_val") is not None else self.E_val
        return torch.sum(val.to(x.dtype)[..., None] * x[idx], dim=1)

    def _matvec(self, x, shape, consts=None):
        """A x for the generic-shape CG solve; x: [m, C]."""
        if self.method == "modified":
            return self._ell_matvec(x, consts)
        return self.interpolate(self.spread(x, shape, consts), consts=consts)

    def _cg(self, matvec, b, diag=None):
        """Batched Jacobi-preconditioned CG over the C right-hand sides with
        iteration/residual reporting (the reference logs both per solve,
        defaults to maxIter 10000 / residue 3e-4, and preconditions with the
        diagonal - lagrange_3D.hpp:661-668, 899-906).

        The JAX loop's condition ``k < max_iters & any(~dead & rr/bb >
        tol^2)`` is read on the host before every iteration, so x, k and the
        residual equal the JAX loop's; like it, a converged column keeps
        updating while another runs.  On the card the loop is bound by the
        host's launches, not by the read (module docstring).

        Returns (x, iters, rel_residual): rel is the max over columns of
        ||r||/||b|| (unpreconditioned norms), a tensor."""
        bb = torch.sum(b * b, dim=0)  # [C]
        bb_safe = torch.where(bb == 0, 1.0, bb)
        diverged = 4.0 * bb_safe
        tol2 = torch.tensor(self.tol, dtype=b.dtype) ** 2
        if diag is None:
            inv = None
        else:
            # clamped Jacobi: a near-zero diagonal entry must not produce
            # an astronomically large (f32-overflowing) scaling
            floor = torch.clamp_min(1e-9 * torch.max(diag), 1e-30)
            inv = (1.0 / torch.maximum(diag, floor)).to(b.dtype)[:, None]

        def prec(r):
            return r if inv is None else inv * r

        # null-direction breakdown guard: f32 rounding leaks into the null
        # space of a SEMI-definite Gram where p^T A p ~ 0; a column whose
        # search direction goes numerically null, or whose residual clearly
        # diverges, is frozen (its solution stops improving, exactly like a
        # breakdown-terminated solver)
        x = torch.zeros_like(b)
        r = b
        p = prec(b)
        rz = torch.sum(b * p, dim=0)
        rr = bb
        dead = torch.zeros(b.shape[1:], dtype=torch.bool, device=b.device)
        k = 0
        while k < self.max_iters and bool(torch.any(~dead & (rr / bb_safe > tol2))):
            ap = matvec(p)
            pap = torch.sum(p * ap, dim=0)
            dead = dead | (pap <= 0) | (rr > diverged)
            alpha = torch.where(dead, 0.0, rz / torch.where(pap == 0, 1.0, pap))
            x = x + alpha * p
            r = r - alpha * ap
            z = prec(r)
            rz_new = torch.sum(r * z, dim=0)
            beta = torch.where(rz == 0, 0.0, rz_new / torch.where(rz == 0, 1.0, rz))
            p = z + beta * p
            rz = rz_new
            rr = torch.sum(r * r, dim=0)
            k += 1
        return x, k, torch.sqrt(torch.max(rr / bb_safe))

    # ------------------------------------------------------------- solve
    def _solve_compact(self, ug, consts):
        """Core solve from node velocities: ug [u, C] (u* sampled at the
        unique stencil nodes) -> (y [u, C] node forces = M^T x, iters, rel).

        Node space: rhs = W^T b = -B ug; solve B y = rhs (exact reduction,
        see the module docstring).  Point space: b = -W ug; CG on A
        (modified) or G = W W^T (original); y = W^T x."""
        c = consts if consts is not None else self.hook_consts()
        dt = ug.dtype
        B = c.get("B")
        if B is not None:
            Bc = B.to(dt)
            with full_fp32_matmul():
                rhs = -(Bc @ ug)
                if self.use_ll_velocity and c.get("Wt_vp") is not None:
                    rhs = rhs + c["Wt_vp"].to(dt)
                return self._cg(lambda v: Bc @ v, rhs, diag=c.get("diag"))

        w = c.get("w", self.weights).to(dt)
        uid = c.get("uid", self.uid)
        u = ug.shape[0]
        b = -torch.sum(w[..., None] * ug[uid], dim=1)  # [m, C]
        if self.use_ll_velocity:
            b = b + torch.as_tensor(self.prescribed_velocity, dtype=dt, device=b.device)

        def scatter(x):
            """W^T x: [m, C] -> [u, C], duplicate slots summed."""
            C = x.shape[1]
            t = torch.zeros((u, C), dtype=dt, device=x.device)
            return t.index_add_(0, uid.reshape(-1), (w[..., None] * x[:, None, :]).reshape(-1, C))

        if c.get("E_idx") is not None:
            def mv(x):
                return self._ell_matvec(x, c)
        else:
            # matrix-free Gram through the compact node space (exact with
            # clipped stencils, and for clouds too dense for an explicit Gram)
            def mv(x):
                return torch.sum(w[..., None] * scatter(x)[uid], dim=1)

        x, iters, rel = self._cg(mv, b, diag=c.get("diag"))
        return scatter(x), iters, rel

    def compute_forces(self, u_star: torch.Tensor, rho: torch.Tensor,
                       consts=None) -> torch.Tensor:
        """Solve for the velocity-correction forces and spread them.

        u_star: [3, X, Y, Z] fluid velocity without the IBM force;
        returns the Eulerian force field [3, X, Y, Z]
        (reference lagrange_3D.hpp:632-852: b = -M u* (+ target velocity),
        CG solve A x = b per component, then f += 2 rho M^T x).
        """
        shape = tuple(u_star.shape[1:])
        c = consts if consts is not None else self.hook_consts()
        if shape == self.grid_shape and c.get("uflat") is not None:
            uflat = c["uflat"]
            C = u_star.shape[0]
            ug = u_star.reshape(C, -1)[:, uflat].T  # [u, C]
            y, iters, rel = self._solve_compact(ug, c)
            self._log_cg(iters, rel)
            out = torch.zeros((C, int(np.prod(shape))), dtype=u_star.dtype,
                              device=u_star.device)
            out[:, uflat] = (2.0 * y).T.to(u_star.dtype)  # unique nodes: a plain store
            return out.reshape(u_star.shape) * rho[None]

        # generic-shape fallback (tests, ad-hoc grids): gather/scatter ops
        b = -self.interpolate(u_star, consts=consts)  # [m, 3]
        if self.use_ll_velocity:
            b = b + torch.as_tensor(self.prescribed_velocity, dtype=b.dtype, device=b.device)
        diag = c.get("diag", self.diag)
        x, iters, rel = self._cg(lambda v: self._matvec(v, shape, consts), b, diag=diag)
        self._log_cg(iters, rel)
        force = self.spread(2.0 * x, shape, consts=consts)
        return force * rho[None]

    def _log_cg(self, iters, rel):
        """CG diagnostics (reference lagrange_3D.hpp:661-668): kept as
        ``last_cg_iters``/``last_cg_residual`` and logged per solve."""
        self.last_cg_iters = int(iters)
        self.last_cg_residual = float(rel)
        line = ('{"ibm": "computeForces", "cg_iterations": %d, "cg_residual": %.3e}'
                % (self.last_cg_iters, self.last_cg_residual))
        if self.last_cg_residual > self.tol and self.last_cg_iters >= self.max_iters:
            self.log.warning("CG did not converge: %s", line)
        else:
            self.log.info(line)

    def forcing_hook(self):
        """Adapter: ``LBMConfig.forcing_hook`` running this solver.

        The hook carries ``hook.consts`` (the operator tensors), which the
        driver hands to every step, and ``reads_host``: the CG loop reads
        its condition on the host, so a CUDA graph cannot capture the hook
        and the driver runs a chunk of its steps eagerly."""

        def hook(lat, rho, u, nu, fluid_mask, consts=None):
            del lat, nu, fluid_mask
            return self.compute_forces(u, rho, consts=consts)

        hook.consts = self.hook_consts()
        hook.reads_host = True
        return hook

    # ------------------------------------------------------- distributed IBM
    # The reference runs IBM inside its multi-GPU step (state.hpp:995-1015,
    # kernels.h:178-218, lagrange_3D.hpp:632-852); JAX keeps the cloud
    # replicated and partitions the Eulerian work by node ownership (one psum
    # of [u, 3] completes the node velocities).  Here the shards are blocks of
    # one process: their partial sums are added on the plan's first device.

    @staticmethod
    def _local_ids(plan, shape, k: int):
        """(offsets [3], local extents [3]) of shard k's block."""
        exts = [shape[a] // plan.counts[a] for a in range(3)]
        idx = plan.block_index(k)
        return [idx[a] * exts[a] for a in range(3)], exts

    def _owned_c(self, plan, shape, nodes, k: int):
        """Shard k's local coordinates of ``nodes`` [..., 3] (clipped into its
        block) and which of them its block holds, on ``nodes``' device."""
        offs, exts = self._local_ids(plan, shape, k)
        loc, inside = [], None
        for a in range(3):
            g = torch.clamp(nodes[..., a], 0, shape[a] - 1)
            lc = g - offs[a]
            ok = (lc >= 0) & (lc < exts[a])
            inside = ok if inside is None else inside & ok
            loc.append(torch.clamp(lc, 0, exts[a] - 1))
        return loc, inside, exts

    def _psum(self, parts, device):
        """The shards' partial sums added on ``device``, in shard order (the
        JAX psum)."""
        total = parts[0].to(device)
        for part in parts[1:]:
            total = total + part.to(device)
        return total

    def interpolate_sharded(self, field, plan, shape, consts=None) -> torch.Tensor:
        """M u of a sharded field (a ShardedField or its blocks, [C, Xl, Yl,
        Zl] each) -> [m, C] on the plan's first device: each shard's partial
        sum over the stencil nodes it owns, the partials added."""
        w, nodes = self._cw(consts)
        blocks = getattr(field, "blocks", field)
        parts = []
        for k, blk in enumerate(blocks):
            (ix, iy, iz), inside, _ = self._owned_c(plan, shape, nodes.to(blk.device), k)
            vals = blk[:, ix, iy, iz]  # [C, m, s^3]
            wl = (w.to(blk.device) * inside).to(blk.dtype)
            parts.append(torch.sum(vals * wl[None], dim=-1).T)
        return self._psum(parts, plan.device(0))

    def spread_sharded(self, vals, plan, shape, consts=None) -> list:
        """M^T x onto every shard's block: [C, Xl, Yl, Zl] per shard, each
        spreading only the stencil nodes it owns."""
        w, nodes = self._cw(consts)
        out = []
        for k in range(plan.n_shards):
            dev = plan.device(k)
            (ix, iy, iz), inside, (lx, ly, lz) = self._owned_c(plan, shape, nodes.to(dev), k)
            flat = (ix * ly + iy) * lz + iz  # [m, s^3] local flat ids
            v = vals.to(dev)
            contrib = (w.to(dev) * inside).to(v.dtype)[..., None] * v[:, None, :]
            C = v.shape[1]
            acc = torch.zeros((lx * ly * lz, C), dtype=v.dtype, device=dev)
            acc.index_add_(0, flat.reshape(-1), contrib.reshape(-1, C))
            out.append(acc.T.reshape((C, lx, ly, lz)))
        return out

    def compute_forces_sharded(self, u_star, rho, plan, shape, consts=None) -> list:
        """The force solve on a sharded lattice: ``compute_forces``'s math with
        the sampling and spreading partitioned by node ownership and the
        compact solve on the solver's device.  ``u_star`` and ``rho`` are
        ShardedFields (or their blocks); returns each shard's force block."""
        shape = tuple(shape)
        ub = getattr(u_star, "blocks", u_star)
        rb = getattr(rho, "blocks", rho)
        c = consts if consts is not None else self.hook_consts()
        if shape == self.grid_shape and c.get("unodes") is not None:
            un = c["unodes"]  # [u, 3] global integer coordinates, unique
            parts, owned = [], []
            for k, blk in enumerate(ub):
                (lx, ly, lz), inside, exts = self._owned_c(plan, shape, un.to(blk.device), k)
                vals = blk[:, lx, ly, lz]  # [C, u]
                parts.append(torch.where(inside[None], vals, torch.zeros((), dtype=vals.dtype,
                                                                         device=vals.device)))
                owned.append(((lx, ly, lz), inside, exts))
            ug = self._psum(parts, un.device).T  # [u, C]
            y, iters, rel = self._solve_compact(ug, c)
            self._log_cg(iters, rel)
            out = []
            for blk, r, ((lx, ly, lz), inside, exts) in zip(ub, rb, owned):
                dev = blk.device
                contrib = torch.where(inside, 1.0, 0.0).to(dev)[:, None] * (2.0 * y.to(dev))
                flat = (lx * exts[1] + ly) * exts[2] + lz  # [u] local flat ids
                acc = torch.zeros((exts[0] * exts[1] * exts[2], blk.shape[0]), dtype=blk.dtype,
                                  device=dev)
                acc.index_add_(0, flat, contrib.to(blk.dtype))
                out.append(acc.T.reshape((blk.shape[0],) + tuple(exts)) * r[None])
            return out

        # the generic shape: matrix-free, the sharded operators at each iteration
        b = -self.interpolate_sharded(ub, plan, shape, consts)
        if self.use_ll_velocity:
            b = b + torch.as_tensor(self.prescribed_velocity, dtype=b.dtype, device=b.device)
        if self.method == "modified":
            def matvec(x):
                return self._ell_matvec(x, c)
        else:
            def matvec(x):
                return self.interpolate_sharded(self.spread_sharded(x, plan, shape, consts),
                                                plan, shape, consts)
        x, iters, rel = self._cg(matvec, b, diag=c.get("diag"))
        self._log_cg(iters, rel)
        return [blk * r[None] for blk, r in zip(self.spread_sharded(2.0 * x, plan, shape, consts),
                                                rb)]

    def sharded_hook(self, plan, shape):
        """``LBMConfig.forcing_hook`` for a sharded run (JAX ``sharded_hook``):
        ``shard_local``, so the sharded steps hand it the u* moments as
        ShardedFields of ``plan`` and take back the force's blocks
        (``compute_forces_sharded``).  It keeps ``consts`` and ``reads_host``
        (the CG reads its condition on the host), as ``forcing_hook``'s."""

        def hook(lat, rho, u, nu, fluid_mask, consts=None):
            del lat, nu, fluid_mask
            return self.compute_forces_sharded(u, rho, plan, tuple(shape), consts=consts)

        hook.shard_local = True
        hook.consts = self.hook_consts()
        hook.reads_host = True
        return hook

    # ---------------------------------------------------------- diagnostics
    def integrate_force(self, force_field: torch.Tensor) -> np.ndarray:
        """Total body force (reference lagrange_3D.hpp:862-890)."""
        return torch.sum(force_field, dim=(1, 2, 3)).cpu().numpy()

    def min_max_spacing(self, block: int = 1 << 24):
        """Min/max nearest-neighbour distance of the point cloud (diagnostics
        printed by the reference generators, obstacles_ibm.h:54-66).  Exact,
        in row blocks of at most ``block`` distances on the solver's device,
        without the JAX method's dense [m, m, 3] array (15 GB at 25k points)."""
        p = torch.as_tensor(self.points_phys, dtype=torch.float64, device=self.device)
        rows = max(1, block // max(self.m, 1))
        nn = []
        for i in range(0, self.m, rows):
            q = p[i : i + rows]
            dx, dy, dz = (q[:, None, a] - p[None, :, a] for a in range(3))
            d2 = dx * dx + dy * dy + dz * dz
            d2[torch.arange(len(q), device=p.device), torch.arange(i, i + len(q),
                                                                   device=p.device)] = torch.inf
            nn.append(torch.sqrt(d2.min(dim=1).values))
        nn = torch.cat(nn)
        return float(nn.min()), float(nn.max())
