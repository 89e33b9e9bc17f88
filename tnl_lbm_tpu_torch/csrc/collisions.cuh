// The D3Q27 collisions beyond the cumulant pair, per site on the 27
// registers of one thread: the counterparts of tnl_lbm_tpu_torch/ops/
// collision.py (collide_srt, collide_srt_modif_force, collide_srt_well,
// collide_bgk, collide_bgk_well, collide_mrt_les, collide_clbm with and
// without well) and ops/collision_kbc.py (collide_kbc, N1-N4 and C1-C4),
// as the registries' ids call them (SRT with the quadratic equilibrium,
// BGK without the Galilean correction).  Each is a type with
// C::collide(f, rho, ux, uy, uz, p), which lbm_site.cuh's site updates
// (site_collide, ab_site, aa_even_site, aa_odd_site) call where the code
// collides: f holds the DFs after the boundary rules and leaves with the
// post-collision DFs; rho is the density with its zeros replaced by one and
// u carries F/2; p (CollParams) holds omega1 = 1 / (3 nu + 0.5), nu, the
// site's body force and, for KBC, the variant bits.
//
// All arithmetic is float32 (every literal takes the f suffix); the square
// roots of MRT_LES and the divisions of KBC stay IEEE (no fast math).  The
// forcing terms: SRT and SRT_WELL add (1 - omega/2) S_q feq with the exact
// per-direction S_q = 3 (c_q - u).F / rho; SRT_MODIF_FORCE the Guo term
// w_q [3 (c_q - u).F + 9 (c_q.u)(c_q.F)]; BGK S_q feq, BGK_WELL -S_q psi_q;
// CLBM negates the first-order central moments (the force enters through
// u, as in the cumulant cascade); MRT_LES and KBC carry no forcing.

#pragma once

#include "lbm_site.cuh"

namespace lbm {

// c_q . F with the zero components left out.
__device__ __forceinline__ float c_dot_force(int q, const ABParams& p) {
  return c_dot(q, p.fx, p.fy, p.fz);
}

// The quadratic equilibrium's bracket 1 + 3 cu + 4.5 cu^2 - 1.5 u^2.
__device__ __forceinline__ float quad_term(int q, float ux, float uy, float uz) {
  const float uu = ux * ux + uy * uy + uz * uz;
  const float cu = c_dot(q, ux, uy, uz);
  return 1.0f + 3.0f * cu + 4.5f * cu * cu - 1.5f * uu;
}

// Improved SRT toward the quadratic equilibrium (reference d3q27/col_srt.h).
struct Srt {
  __device__ __forceinline__ static void collide(float (&f)[Q], float rho, float ux, float uy,
                                                 float uz, const CollParams& p) {
    const float o = p.omega1;
    const float uF = ux * p.fx + uy * p.fy + uz * p.fz;
    const float s3 = 3.0f / rho;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float feq = weight(q) * rho * quad_term(q, ux, uy, uz);
      const float S = (c_dot_force(q, p) - uF) * s3;
      f[q] = f[q] + (feq - f[q]) * o + (1.0f - 0.5f * o) * S * feq;
    }
  }
};

// SRT with the classic Guo forcing (reference d3q27/col_srt_modif_force.h).
struct SrtModifForce {
  __device__ __forceinline__ static void collide(float (&f)[Q], float rho, float ux, float uy,
                                                 float uz, const CollParams& p) {
    const float o = p.omega1;
    const float uF = ux * p.fx + uy * p.fy + uz * p.fz;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float feq = weight(q) * rho * quad_term(q, ux, uy, uz);
      const float cF = c_dot_force(q, p);
      const float guo = weight(q) * (3.0f * (cF - uF) + 9.0f * c_dot(q, ux, uy, uz) * cF);
      f[q] = f[q] + (feq - f[q]) * o + (1.0f - 0.5f * o) * guo;
    }
  }
};

// Well-conditioned improved SRT on deviation DFs (reference
// d3q27/col_srt_well.h): the forcing multiplies the full equilibrium.
struct SrtWell {
  __device__ __forceinline__ static void collide(float (&f)[Q], float rho, float ux, float uy,
                                                 float uz, const CollParams& p) {
    const float o = p.omega1;
    const float uF = ux * p.fx + uy * p.fy + uz * p.fz;
    const float s3 = 3.0f / rho;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float feq_dev = weight(q) * (rho * quad_term(q, ux, uy, uz) - 1.0f);
      const float S = (c_dot_force(q, p) - uF) * s3;
      f[q] = f[q] + (feq_dev - f[q]) * o + (1.0f - 0.5f * o) * (S * (feq_dev + weight(q)));
    }
  }
};

// The factorised equilibrium's axis factor (reference col_bgk.h:48-59):
// X0 = v^2 - 2/3, X+ = -(X0 + 1 + v) / 2, X- = X+ + v.
__device__ __forceinline__ float bgk_factor(int c, float v) {
  const float x0 = -2.0f / 3.0f + v * v;
  if (c == 0) return x0;
  const float xp = -0.5f * (x0 + 1.0f + v);
  return c > 0 ? xp : xp + v;
}

// BGK toward the factorised equilibrium -rho X Y Z (reference d3q27/col_bgk.h).
struct Bgk {
  __device__ __forceinline__ static void collide(float (&f)[Q], float rho, float ux, float uy,
                                                 float uz, const CollParams& p) {
    const float o = p.omega1;
    const float uF = ux * p.fx + uy * p.fy + uz * p.fz;
    const float s3 = 3.0f / rho;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float feq = -rho * bgk_factor(cx(q), ux) * bgk_factor(cy(q), uy) *
                        bgk_factor(cz(q), uz);
      const float S = (c_dot_force(q, p) - uF) * s3;
      f[q] = f[q] + (feq - f[q]) * o + (1.0f - 0.5f * o) * S * feq;
    }
  }
};

// Well-conditioned factorised BGK on deviation DFs (reference
// d3q27/col_bgk_well.h): g' = g + (-rho psi - w - g) omega - (1 - omega/2) S psi.
struct BgkWell {
  __device__ __forceinline__ static void collide(float (&f)[Q], float rho, float ux, float uy,
                                                 float uz, const CollParams& p) {
    const float o = p.omega1;
    const float uF = ux * p.fx + uy * p.fy + uz * p.fz;
    const float s3 = 3.0f / rho;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float psi = bgk_factor(cx(q), ux) * bgk_factor(cy(q), uy) * bgk_factor(cz(q), uz);
      const float feq_dev = -rho * psi - weight(q);
      const float S = (c_dot_force(q, p) - uF) * s3;
      f[q] = f[q] + (feq_dev - f[q]) * o - (1.0f - 0.5f * o) * S * psi;
    }
  }
};

// Regularised MRT with Smagorinsky LES (reference d3q27/col_mrt.h): the
// second moments P relaxed at omega = 2 / (sqrt(tau^2 + 18 C_s sqrt(Q2) /
// rho) + tau), C_s = 0.0342, every higher moment re-equilibrated.
struct MrtLes {
  __device__ __forceinline__ static void collide(float (&f)[Q], float rho, float ux, float uy,
                                                 float uz, const CollParams& p) {
    float P[3][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int q = 1; q < Q; ++q)
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = a; b < 3; ++b) {
          const int c = cq(q, a) * cq(q, b);
          if (c > 0) P[a][b] = P[a][b] + f[q];
          else if (c < 0) P[a][b] = P[a][b] - f[q];
        }
    const float u[3] = {ux, uy, uz};
    float Pn[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = a; b < 3; ++b)
        Pn[a][b] = P[a][b] - rho * (u[a] * u[b] + (a == b ? 1.0f / 3.0f : 0.0f));
    const float Q2 = 2.0f * (Pn[0][0] * Pn[0][0] + Pn[1][1] * Pn[1][1] + Pn[2][2] * Pn[2][2] +
                             2.0f * (Pn[0][1] * Pn[0][1] + Pn[0][2] * Pn[0][2] +
                                     Pn[1][2] * Pn[1][2]));
    const float tau = 3.0f * p.nu + 0.5f;
    const float omega = 2.0f / (sqrtf(tau * tau + 0.6156f * sqrtf(Q2) / rho) + tau);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = a; b < 3; ++b) P[a][b] = P[a][b] - omega * Pn[a][b];
    const float trP = P[0][0] + P[1][1] + P[2][2];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int csq = cx(q) * cx(q) + cy(q) * cy(q) + cz(q) * cz(q);
      float cPc = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const int c = cq(q, a) * cq(q, b);
          const float Pab = a <= b ? P[a][b] : P[b][a];
          if (c > 0) cPc = cPc + Pab;
          else if (c < 0) cPc = cPc - Pab;
        }
      f[q] = weight(q) * (rho * ((2.5f - 1.5f * csq) + 3.0f * c_dot(q, ux, uy, uz)) +
                          4.5f * cPc - 1.5f * trP);
    }
  }
};

// Cascaded central-moment collision (reference d3q27/col_clbm.h; WELL:
// col_clbm_well.h on deviation DFs): the cumulant operator's forward and
// inverse cascades (fwd_axis, bwd_axis) with the velocity-derivative terms
// on, omega2 = 1, and every central moment of order >= 3 at its factorised
// equilibrium (0 when odd, rho/9 for kappa_220 and its kin, rho/27 for
// kappa_222; k000/9 and k000/27 in well storage).  The first order is
// negated: the kernels always pass the body force, as the JAX kernel does.
template <bool WELL>
struct Clbm {
  __device__ __forceinline__ static void collide(float (&f)[Q], float rho, float ux, float uy,
                                                 float uz, const CollParams& p) {
    float kz[3][3][3];
#pragma unroll
    for (int ix = 0; ix < 3; ++ix)
#pragma unroll
      for (int iy = 0; iy < 3; ++iy)
        fwd_axis(f[dir_index(ix, iy, 0)], f[dir_index(ix, iy, 1)], f[dir_index(ix, iy, 2)], uz,
                 WELL, z_offset(ix, iy), kz[ix][iy][0], kz[ix][iy][1], kz[ix][iy][2]);
    float ky[3][3][3];
#pragma unroll
    for (int ix = 0; ix < 3; ++ix)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        fwd_axis(kz[ix][0][g], kz[ix][1][g], kz[ix][2][g], uy, WELL && y_has_offset(g),
                 y_offset(ix, g), ky[ix][g][0], ky[ix][g][1], ky[ix][g][2]);
    float k[3][3][3];
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        fwd_axis(ky[0][g][b], ky[1][g][b], ky[2][g][b], ux, WELL && x_has_offset(b, g),
                 x_offset(b, g), k[0][b][g], k[1][b][g], k[2][b][g]);

    const float k000 = k[0][0][0];
    const float k200 = k[2][0][0], k020 = k[0][2][0], k002 = k[0][0][2];
    const float inv_rho = 1.0f / rho;
    const float o1 = p.omega1;
    const float Dxu = -o1 * 0.5f * inv_rho * (2.0f * k200 - k020 - k002) -
                      0.5f * inv_rho * (k200 + k020 + k002 - k000);
    const float Dyv = Dxu + 1.5f * o1 * inv_rho * (k200 - k020);
    const float Dzw = Dxu + 1.5f * o1 * inv_rho * (k200 - k002);
    const float r3 = 3.0f * rho;
    const float eqd4 = (1.0f - o1) * (k200 - k020) -
                       r3 * (1.0f - o1 * 0.5f) * (ux * ux * Dxu - uy * uy * Dyv);
    const float eqd5 = (1.0f - o1) * (k200 - k002) -
                       r3 * (1.0f - o1 * 0.5f) * (ux * ux * Dxu - uz * uz * Dzw);
    const float eqd6 = k000 - r3 * 0.5f * (ux * ux * Dxu + uy * uy * Dyv + uz * uz * Dzw);
    const float ks200 = (eqd4 + eqd5 + eqd6) / 3.0f;
    const float ks020 = (-2.0f * eqd4 + eqd5 + eqd6) / 3.0f;
    const float ks002 = (eqd4 - 2.0f * eqd5 + eqd6) / 3.0f;
    const float ks110 = (1.0f - o1) * k[1][1][0];
    const float ks101 = (1.0f - o1) * k[1][0][1];
    const float ks011 = (1.0f - o1) * k[0][1][1];
    const float e4 = (WELL ? k000 : rho) / 9.0f;
    const float e6 = (WELL ? k000 : rho) / 27.0f;

    // inverse x per (order y, order z); every other slot is zero
    float bx[3][3][3];
    bwd_axis(k000, -k[1][0][0], ks200, ux, WELL, x_offset(0, 0), bx[0][0][0], bx[1][0][0],
             bx[2][0][0]);
    bwd_axis_k2z(-k[0][1][0], ks110, ux, bx[0][1][0], bx[1][1][0], bx[2][1][0]);
    bwd_axis_k1z(ks020, e4, ux, WELL, x_offset(2, 0), bx[0][2][0], bx[1][2][0], bx[2][2][0]);
    bwd_axis_k2z(-k[0][0][1], ks101, ux, bx[0][0][1], bx[1][0][1], bx[2][0][1]);
    bwd_axis_k1z(ks011, 0.0f, ux, false, 0.0f, bx[0][1][1], bx[1][1][1], bx[2][1][1]);
    bwd_axis_k1z(ks002, e4, ux, WELL, x_offset(0, 2), bx[0][0][2], bx[1][0][2], bx[2][0][2]);
    bx[0][2][1] = bx[1][2][1] = bx[2][2][1] = 0.0f;  // orders (2, 1) and (1, 2): no offset
    bx[0][1][2] = bx[1][1][2] = bx[2][1][2] = 0.0f;
    bwd_axis_k1z(e4, e6, ux, WELL, x_offset(2, 2), bx[0][2][2], bx[1][2][2], bx[2][2][2]);

    float by[3][3][3];
#pragma unroll
    for (int ix = 0; ix < 3; ++ix)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        bwd_axis(bx[ix][0][g], bx[ix][1][g], bx[ix][2][g], uy, WELL && y_has_offset(g),
                 y_offset(ix, g), by[ix][0][g], by[ix][1][g], by[ix][2][g]);
#pragma unroll
    for (int ix = 0; ix < 3; ++ix)
#pragma unroll
      for (int iy = 0; iy < 3; ++iy)
        bwd_axis(by[ix][iy][0], by[ix][iy][1], by[ix][iy][2], uz, WELL, z_offset(ix, iy),
                 f[dir_index(ix, iy, 0)], f[dir_index(ix, iy, 1)], f[dir_index(ix, iy, 2)]);
  }
};

// KBC (reference d3q27/col_kbc_n.h, col_kbc_c.h; ops/collision_kbc.py): the
// shear part ds from the second-moment deltas (dN_xz, dN_yz, dP_ab, with
// the trace dT where p.kbc & 1) and the heat flux's (p.kbc & 2; from the
// central moments where p.kbc & 4), dh = f - feq - ds with the
// inverse-cumulant feq, gamma = 1/beta - (2 - 1/beta) <ds|dh> / <dh|dh>
// (2 where <dh|dh> is zero), beta = 1 / (6 nu + 1), f' = f - beta (2 ds +
// gamma dh).  ds and feq are recomputed per direction in each of the two
// passes from 18 scalars, so no array beside f stays live.
struct Kbc {
  struct Deltas {
    float dNxz, dNyz, dPxy, dPxz, dPyz, dT;
    float xxy, xxz, xyy, yyz, xzz, yzz, xyz;  // the heat flux's deltas
    bool trace, heat;
  };

  __device__ __forceinline__ static float ds(int q, const Deltas& d) {
    const int nz = (cx(q) != 0) + (cy(q) != 0) + (cz(q) != 0);
    float e = 0.0f;
    if (nz == 1) {
      if (cx(q) != 0) e = (2.0f * d.dNxz - d.dNyz) / 6.0f;
      else if (cy(q) != 0) e = (-d.dNxz + 2.0f * d.dNyz) / 6.0f;
      else e = (-d.dNxz - d.dNyz) / 6.0f;
      if (d.trace) e = e + d.dT / 6.0f;
    } else if (nz == 2) {
      if (cz(q) == 0) e = (cx(q) * cy(q) > 0 ? d.dPxy : -d.dPxy) * 0.25f;
      else if (cy(q) == 0) e = (cx(q) * cz(q) > 0 ? d.dPxz : -d.dPxz) * 0.25f;
      else e = (cy(q) * cz(q) > 0 ? d.dPyz : -d.dPyz) * 0.25f;
    } else if (nz == 0 && d.trace) {
      e = -d.dT;
    }
    if (d.heat) {
      float h = 0.0f;
      if (nz == 1) {
        if (cx(q) != 0) h = (cx(q) > 0 ? -(d.xyy + d.xzz) : d.xyy + d.xzz) * 0.5f;
        else if (cy(q) != 0) h = (cy(q) > 0 ? -(d.xxy + d.yzz) : d.xxy + d.yzz) * 0.5f;
        else h = (cz(q) > 0 ? -(d.xxz + d.yyz) : d.xxz + d.yyz) * 0.5f;
      } else if (nz == 2) {
        if (cz(q) == 0) h = ((cx(q) > 0 ? d.xyy : -d.xyy) + (cy(q) > 0 ? d.xxy : -d.xxy)) * 0.25f;
        else if (cy(q) == 0) h = ((cx(q) > 0 ? d.xzz : -d.xzz) + (cz(q) > 0 ? d.xxz : -d.xxz)) * 0.25f;
        else h = ((cy(q) > 0 ? d.yzz : -d.yzz) + (cz(q) > 0 ? d.yyz : -d.yyz)) * 0.25f;
      } else if (nz == 3) {
        h = (cx(q) * cy(q) * cz(q) > 0 ? d.xyz : -d.xyz) * 0.125f;
      }
      e = e + h;
    }
    return e;
  }

  __device__ __forceinline__ static void collide(float (&f)[Q], float rho, float ux, float uy,
                                                 float uz, const CollParams& p) {
    Deltas d;
    d.trace = (p.kbc & 1) != 0;
    d.heat = (p.kbc & 2) != 0;
    float M200 = 0.0f, M020 = 0.0f, M002 = 0.0f, M110 = 0.0f, M101 = 0.0f, M011 = 0.0f;
#pragma unroll
    for (int q = 1; q < Q; ++q) {
      if (cx(q) != 0) M200 = M200 + f[q];
      if (cy(q) != 0) M020 = M020 + f[q];
      if (cz(q) != 0) M002 = M002 + f[q];
      if (cx(q) * cy(q) != 0) M110 = cx(q) * cy(q) > 0 ? M110 + f[q] : M110 - f[q];
      if (cx(q) * cz(q) != 0) M101 = cx(q) * cz(q) > 0 ? M101 + f[q] : M101 - f[q];
      if (cy(q) * cz(q) != 0) M011 = cy(q) * cz(q) > 0 ? M011 + f[q] : M011 - f[q];
    }
    d.dNxz = (M200 - M002) - rho * (ux * ux - uz * uz);
    d.dNyz = (M020 - M002) - rho * (uy * uy - uz * uz);
    d.dPxy = M110 - rho * ux * uy;
    d.dPxz = M101 - rho * ux * uz;
    d.dPyz = M011 - rho * uy * uz;
    d.dT = (M200 + M020 + M002) - rho * (1.0f + ux * ux + uy * uy + uz * uz);
    d.xxy = d.xxz = d.xyy = d.yyz = d.xzz = d.yzz = d.xyz = 0.0f;
    if (d.heat && (p.kbc & 4)) {
      // central third moments: the cumulant operator's forward cascade
      float kz[3][3][3];
#pragma unroll
      for (int ix = 0; ix < 3; ++ix)
#pragma unroll
        for (int iy = 0; iy < 3; ++iy)
          fwd_axis(f[dir_index(ix, iy, 0)], f[dir_index(ix, iy, 1)], f[dir_index(ix, iy, 2)], uz,
                   false, 0.0f, kz[ix][iy][0], kz[ix][iy][1], kz[ix][iy][2]);
      float ky[3][3][3];
#pragma unroll
      for (int ix = 0; ix < 3; ++ix)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          fwd_axis(kz[ix][0][g], kz[ix][1][g], kz[ix][2][g], uy, false, 0.0f, ky[ix][g][0],
                   ky[ix][g][1], ky[ix][g][2]);
      float k[3][3][3];
#pragma unroll
      for (int b = 0; b < 3; ++b)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          fwd_axis(ky[0][g][b], ky[1][g][b], ky[2][g][b], ux, false, 0.0f, k[0][b][g],
                   k[1][b][g], k[2][b][g]);
      d.xxy = k[2][1][0];
      d.xxz = k[2][0][1];
      d.xyy = k[1][2][0];
      d.yyz = k[0][2][1];
      d.xzz = k[1][0][2];
      d.yzz = k[0][1][2];
      d.xyz = k[1][1][1];
    } else if (d.heat) {
      float M210 = 0.0f, M201 = 0.0f, M120 = 0.0f, M021 = 0.0f, M102 = 0.0f, M012 = 0.0f;
      float M111 = 0.0f;
#pragma unroll
      for (int q = 1; q < Q; ++q) {
        if (cx(q) != 0 && cy(q) != 0) {
          M210 = cy(q) > 0 ? M210 + f[q] : M210 - f[q];
          M120 = cx(q) > 0 ? M120 + f[q] : M120 - f[q];
        }
        if (cx(q) != 0 && cz(q) != 0) {
          M201 = cz(q) > 0 ? M201 + f[q] : M201 - f[q];
          M102 = cx(q) > 0 ? M102 + f[q] : M102 - f[q];
        }
        if (cy(q) != 0 && cz(q) != 0) {
          M021 = cz(q) > 0 ? M021 + f[q] : M021 - f[q];
          M012 = cy(q) > 0 ? M012 + f[q] : M012 - f[q];
        }
        if (cx(q) * cy(q) * cz(q) != 0)
          M111 = cx(q) * cy(q) * cz(q) > 0 ? M111 + f[q] : M111 - f[q];
      }
      const float third = 1.0f / 3.0f;
      d.xxy = M210 - rho * uy * (third + ux * ux);
      d.xxz = M201 - rho * uz * (third + ux * ux);
      d.xyy = M120 - rho * ux * (third + uy * uy);
      d.yyz = M021 - rho * uz * (third + uy * uy);
      d.xzz = M102 - rho * ux * (third + uz * uz);
      d.yzz = M012 - rho * uy * (third + uz * uz);
      d.xyz = M111 - rho * ux * uy * uz;
    }

    const float fx[3] = {invcum_factor(-1, ux), invcum_factor(0, ux), invcum_factor(1, ux)};
    const float fy[3] = {invcum_factor(-1, uy), invcum_factor(0, uy), invcum_factor(1, uy)};
    const float fz[3] = {invcum_factor(-1, uz), invcum_factor(0, uz), invcum_factor(1, uz)};
    float num = 0.0f, den = 0.0f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float feq = rho * fx[cx(q) + 1] * fy[cy(q) + 1] * fz[cz(q) + 1];
      const float s = ds(q, d);
      const float h = (f[q] - feq) - s;
      const float ifeq = 1.0f / feq;
      num = num + s * h * ifeq;
      den = den + h * h * ifeq;
    }
    const float beta = 1.0f / (6.0f * p.nu + 1.0f);
    const float ib = 1.0f / beta;
    const float gamma = den == 0.0f ? 2.0f : ib - (2.0f - ib) * num / den;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float feq = rho * fx[cx(q) + 1] * fy[cy(q) + 1] * fz[cz(q) + 1];
      const float s = ds(q, d);
      const float h = (f[q] - feq) - s;
      f[q] = f[q] - beta * (2.0f * s + gamma * h);
    }
  }
};

}  // namespace lbm
