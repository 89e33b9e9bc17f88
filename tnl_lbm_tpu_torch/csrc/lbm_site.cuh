// Per-site D3Q27 logic shared by the A-A kernels (aa_even.cu, aa_odd.cu,
// aa_pair.cu), the A-B kernel (ab_step.cu), the coupled kernels
// (coupled_ab.cu, coupled_aa.cu) and the one-kernel NN step (nn_step.cu).
//
// CUDA counterpart of the per-site code in tnl_lbm_tpu/kernels/fused.py:
// _moments_local (moments_local), _eq_local (eq_q), _pull_transform
// (pull_transform: the WALL bounce-back swap; sym_mirror), the post-moment
// BCs of _stream_bc_collide (ab_boundary, with the Eichler moment inflow of
// tnl_lbm_tpu/ops/boundary.py inflow_left_moment_bc), _stream_bc_collide
// on FLUID/WALL/NOTHING maps (stream_bc_collide, the pair's) and with the
// full 3D set (site_collide) for the A-B step (ab_site) and the A-A even
// and odd steps (aa_even_site, aa_odd_site), and the zero-folded cumulant
// cascade of tnl_lbm_tpu/ops/collision.py:collide_cum, with well=True
// (collide_cum<true>, CUM_WELL) and without (collide_cum<false>, CUM: total
// DFs, no weight offsets).  The site updates take their collision as a
// type C with C::collide(f, rho, ux, uy, uz, p): Cum<WELL> here, the other
// operators of the D3Q27 set in collisions.cuh.
// The plain PyTorch versions of the same functions are in
// tnl_lbm_tpu_torch/kernels/fused.py and tnl_lbm_tpu_torch/ops/collision.py.
//
// One thread owns one site; its 27 DFs live in registers (every array
// index below is a compile-time constant once the loops are unrolled).
// All arithmetic is in `real`: float32, or float64 in a source that defines
// LBM_F64 before it includes this header (the float64 instances,
// f64_ab.cu, f64_aa.cu, f64_pair.cu).  Every literal is written real(...),
// since a bare double literal would promote a float32 cascade to FP64; for
// float each is the float literal it replaced, so the float32 code is
// unchanged.  A float64 source's code lives in namespace lbm_f64 (the
// macro below renames lbm there), so no inline function or constant of the
// float32 sources shares its name with one of another type in the
// library.  nvcc does not fold
// x * 0 or x + 0 under IEEE rules, so the terms that are structurally
// zero in this configuration (cumulants of order >= 3 relaxed to
// equilibrium, Geier 2017 limiters and anti-aliasing off, omega2 = 1) are
// folded out by hand, as the JAX package folds them at trace time.

#pragma once

#include <cstdint>

#ifdef LBM_F64
#define lbm lbm_f64
#endif

namespace lbm {

#ifdef LBM_F64
using real = double;
__device__ __forceinline__ double abs_r(double x) { return fabs(x); }
__device__ __forceinline__ double sqrt_r(double x) { return sqrt(x); }
#else
using real = float;
__device__ __forceinline__ float abs_r(float x) { return fabsf(x); }
__device__ __forceinline__ float sqrt_r(float x) { return sqrtf(x); }
#endif

constexpr int Q = 27;

// GEO codes (tnl_lbm_tpu/ops/boundary.py).  The A-B kernel handles the
// whole 3D set, the A-A even and odd kernels all of it but
// OUTFLOW_RIGHT_INTERP, the pair FLUID, WALL and NOTHING.
constexpr uint8_t GEO_FLUID = 0;
constexpr uint8_t GEO_WALL = 1;
constexpr uint8_t GEO_INFLOW = 2;
constexpr uint8_t GEO_INFLOW_LEFT = 3;
constexpr uint8_t GEO_OUTFLOW_EQ = 4;
constexpr uint8_t GEO_OUTFLOW_RIGHT = 5;
constexpr uint8_t GEO_OUTFLOW_RIGHT_INTERP = 6;
constexpr uint8_t GEO_PERIODIC = 7;
constexpr uint8_t GEO_NOTHING = 8;
constexpr uint8_t GEO_SYM_TOP = 9;
constexpr uint8_t GEO_SYM_BOTTOM = 10;
constexpr uint8_t GEO_SYM_LEFT = 11;
constexpr uint8_t GEO_SYM_RIGHT = 12;
constexpr uint8_t GEO_SYM_BACK = 13;
constexpr uint8_t GEO_SYM_FRONT = 14;

// Codes on which the collision runs (boundary.py collision_mask_codes(3)).
__device__ __forceinline__ bool collides(uint8_t m) {
  return m == GEO_FLUID || m == GEO_PERIODIC || m == GEO_OUTFLOW_RIGHT ||
         m == GEO_OUTFLOW_RIGHT_INTERP || m == GEO_INFLOW_LEFT;
}

// Direction q in the descriptor's enum order (tnl_lbm_tpu/models/descriptors.py)
// encoded as 9 (cx + 1) + 3 (cy + 1) + (cz + 1).
__host__ __device__ constexpr int dir_code(int q) {
  switch (q) {
    case 0: return 13;   // zzz
    case 1: return 22;   // pzz
    case 2: return 4;    // mzz
    case 3: return 16;   // zpz
    case 4: return 10;   // zmz
    case 5: return 14;   // zzp
    case 6: return 12;   // zzm
    case 7: return 25;   // ppz
    case 8: return 1;    // mmz
    case 9: return 19;   // pmz
    case 10: return 7;   // mpz
    case 11: return 23;  // pzp
    case 12: return 3;   // mzm
    case 13: return 21;  // pzm
    case 14: return 5;   // mzp
    case 15: return 17;  // zpp
    case 16: return 9;   // zmm
    case 17: return 15;  // zpm
    case 18: return 11;  // zmp
    case 19: return 26;  // ppp
    case 20: return 0;   // mmm
    case 21: return 24;  // ppm
    case 22: return 2;   // mmp
    case 23: return 20;  // pmp
    case 24: return 6;   // mpm
    case 25: return 18;  // pmm
    default: return 8;   // mpp
  }
}

__host__ __device__ constexpr int cx(int q) { return dir_code(q) / 9 - 1; }
__host__ __device__ constexpr int cy(int q) { return (dir_code(q) / 3) % 3 - 1; }
__host__ __device__ constexpr int cz(int q) { return dir_code(q) % 3 - 1; }
// Opposite directions are neighbours in the enum: (1,2), (3,4), ..., (25,26).
__host__ __device__ constexpr int opp(int q) { return q == 0 ? 0 : ((q & 1) ? q + 1 : q - 1); }

// Direction index of the tensor slot [ix][iy][iz], i = c + 1 (the inverse
// of dir_code).
__host__ __device__ constexpr int dir_index(int ix, int iy, int iz) {
  switch (9 * ix + 3 * iy + iz) {
    case 0: return 20;   // mmm
    case 1: return 8;    // mmz
    case 2: return 22;   // mmp
    case 3: return 12;   // mzm
    case 4: return 2;    // mzz
    case 5: return 14;   // mzp
    case 6: return 24;   // mpm
    case 7: return 10;   // mpz
    case 8: return 26;   // mpp
    case 9: return 16;   // zmm
    case 10: return 4;   // zmz
    case 11: return 18;  // zmp
    case 12: return 6;   // zzm
    case 13: return 0;   // zzz
    case 14: return 5;   // zzp
    case 15: return 17;  // zpm
    case 16: return 3;   // zpz
    case 17: return 15;  // zpp
    case 18: return 25;  // pmm
    case 19: return 9;   // pmz
    case 20: return 23;  // pmp
    case 21: return 13;  // pzm
    case 22: return 1;   // pzz
    case 23: return 11;  // pzp
    case 24: return 21;  // ppm
    case 25: return 7;   // ppz
    default: return 19;  // ppp
  }
}

// Direction index of a descriptor name such as "mpz" (letters m, z, p for
// c = -1, 0, +1 along x, y, z): the names the Eichler BC addresses DFs by.
__host__ __device__ constexpr int qn(const char* name) {
  return dir_index(name[0] == 'm' ? 0 : (name[0] == 'z' ? 1 : 2),
                   name[1] == 'm' ? 0 : (name[1] == 'z' ? 1 : 2),
                   name[2] == 'm' ? 0 : (name[2] == 'z' ? 1 : 2));
}

// A direction index as a compile-time constant, so that the register array
// is indexed statically: f[QConst<qn("mpz")>::value].
template <int I>
struct QConst {
  static constexpr int value = I;
};

// Component a (0 x, 1 y, 2 z) of direction q, and the direction with that
// component negated (descriptors.py mirror(axis)).
__host__ __device__ constexpr int cq(int q, int a) { return a == 0 ? cx(q) : (a == 1 ? cy(q) : cz(q)); }
__host__ __device__ constexpr int mirror(int q, int a) {
  return dir_index(cx(q) * (a == 0 ? -1 : 1) + 1, cy(q) * (a == 1 ? -1 : 1) + 1,
                   cz(q) * (a == 2 ? -1 : 1) + 1);
}

// Lattice weight of direction q: 8/27, 2/27, 1/54, 1/216 by the number of
// nonzero components.
__host__ __device__ constexpr real weight(int q) {
  return (cx(q) != 0) + (cy(q) != 0) + (cz(q) != 0) == 0   ? real(8.0) / real(27.0)
         : (cx(q) != 0) + (cy(q) != 0) + (cz(q) != 0) == 1 ? real(2.0) / real(27.0)
         : (cx(q) != 0) + (cy(q) != 0) + (cz(q) != 0) == 2 ? real(1.0) / real(54.0)
                                                             : real(1.0) / real(216.0);
}

// Weight offsets of the well-conditioned cascade (collision.py
// central_moments / dfs_from_central_moments with well=True).  The forward
// and the inverse transform shift each axis triple by the same constant:
// z level by the number m of nonzero (cx, cy): 4/9, 1/9, 1/36;
// y level by (ix, order g): g = 0 -> 2/3 (centre) or 1/6, g = 2 -> 2/9 or
// 1/18, g = 1 -> none; x level by (order b, order g): (0,0) -> 1,
// (0,2)/(2,0) -> 1/3, (2,2) -> 1/9, any order 1 -> none.
__host__ __device__ constexpr real z_offset(int ix, int iy) {
  const int m = (ix != 1) + (iy != 1);
  return m == 0 ? real(4.0) / real(9.0) : (m == 1 ? real(1.0) / real(9.0) : real(1.0) / real(36.0));
}
__host__ __device__ constexpr bool y_has_offset(int g) { return g != 1; }
__host__ __device__ constexpr real y_offset(int ix, int g) {
  return g == 0 ? (ix == 1 ? real(2.0) / real(3.0) : real(1.0) / real(6.0))
                : (ix == 1 ? real(2.0) / real(9.0) : real(1.0) / real(18.0));
}
__host__ __device__ constexpr bool x_has_offset(int b, int g) { return b != 1 && g != 1; }
__host__ __device__ constexpr real x_offset(int b, int g) {
  return (b == 0 && g == 0) ? real(1.0) : ((b == 0 || g == 0) ? real(1.0) / real(3.0) : real(1.0) / real(9.0));
}

// One axis of the forward central-moment cascade (Geier 2015 eqs. 6-8;
// collision.py _forward_axis): (f-, f0, f+) -> (k0, k1, k2).
__device__ __forceinline__ void fwd_axis(real fm, real fz, real fp, real v,
                                         bool has_off, real K0,
                                         real& k0, real& k1, real& k2) {
  const real s = fp + fm;
  const real d = fp - fm;
  k0 = s + fz;
  const real t = v * (has_off ? k0 + K0 : k0);
  const real w = v * d;
  k1 = d - t;
  k2 = (s - (w + w)) + v * t;
}

// One axis of the inverse cascade (eqs. 88-90; collision.py _backward_axis).
__device__ __forceinline__ void bwd_axis(real k0, real k1, real k2, real v,
                                         bool has_off, real K0,
                                         real& fm, real& fz, real& fp) {
  const real b = v * (has_off ? k0 + K0 : k0);
  const real a = v * b;
  const real t = v * k1;
  const real s = ((a + t) + t) + k2;
  const real w = b + k1;
  fz = k0 - s;
  fm = real(0.5) * (s - w);
  fp = real(0.5) * (s + w);
}

// bwd_axis with k2 == 0 (and no offset).
__device__ __forceinline__ void bwd_axis_k2z(real k0, real k1, real v,
                                             real& fm, real& fz, real& fp) {
  const real b = v * k0;
  const real a = v * b;
  const real t = v * k1;
  const real s = (a + t) + t;
  const real w = b + k1;
  fz = k0 - s;
  fm = real(0.5) * (s - w);
  fp = real(0.5) * (s + w);
}

// bwd_axis with k1 == 0.
__device__ __forceinline__ void bwd_axis_k1z(real k0, real k2, real v,
                                             bool has_off, real K0,
                                             real& fm, real& fz, real& fp) {
  const real b = v * (has_off ? k0 + K0 : k0);
  const real s = v * b + k2;
  fz = k0 - s;
  fm = real(0.5) * (s - b);
  fp = real(0.5) * (s + b);
}

// bwd_axis with k0 == k2 == 0 (and no offset).
__device__ __forceinline__ void bwd_axis_k1only(real k1, real v,
                                                real& fm, real& fz, real& fp) {
  const real t = v * k1;
  const real s = t + t;
  fz = -s;
  fm = real(0.5) * (s - k1);
  fp = real(0.5) * (s + k1);
}

// Cumulant collision (collision.py collide_cum with its defaults), in place
// on the 27 DFs: WELL = true is CUM_WELL on deviation DFs (every transform
// runs on weight-shifted moments), WELL = false is CUM on total DFs.  u
// already carries F/2; rho is the total density (never 0 here).  The
// offsets enter only where WELL holds; without it the axis transforms get
// has_off = false and fold to the plain cascade.
template <bool WELL>
__device__ __forceinline__ void collide_cum(real (&f)[Q], real rho, real ux, real uy,
                                            real uz, real omega1) {
  // forward: z, then y, then x
  real kz[3][3][3];  // [ix][iy][order z]
#pragma unroll
  for (int ix = 0; ix < 3; ++ix)
#pragma unroll
    for (int iy = 0; iy < 3; ++iy)
      fwd_axis(f[dir_index(ix, iy, 0)], f[dir_index(ix, iy, 1)], f[dir_index(ix, iy, 2)],
               uz, WELL, z_offset(ix, iy), kz[ix][iy][0], kz[ix][iy][1], kz[ix][iy][2]);
  real ky[3][3][3];  // [ix][order z][order y]
#pragma unroll
  for (int ix = 0; ix < 3; ++ix)
#pragma unroll
    for (int g = 0; g < 3; ++g)
      fwd_axis(kz[ix][0][g], kz[ix][1][g], kz[ix][2][g], uy, WELL && y_has_offset(g),
               y_offset(ix, g), ky[ix][g][0], ky[ix][g][1], ky[ix][g][2]);
  real k[3][3][3];  // [order x][order y][order z]; only orders <= 2 are used
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int g = 0; g < 3; ++g)
      fwd_axis(ky[0][g][b], ky[1][g][b], ky[2][g][b], ux, WELL && x_has_offset(b, g),
               x_offset(b, g), k[0][b][g], k[1][b][g], k[2][b][g]);

  const real k000 = k[0][0][0];
  const real C110 = k[1][1][0], C101 = k[1][0][1], C011 = k[0][1][1];
  const real C200 = k[2][0][0], C020 = k[0][2][0], C002 = k[0][0][2];
  const real inv_rho = real(1.0) / rho;
  const real third = real(1.0) / real(3.0);
  const real o1 = omega1;

  // second order (Geier 2017 eqs. 33-35, omega2 = 1, no anti-aliasing)
  const real ks110 = (real(1.0) - o1) * C110;
  const real ks101 = (real(1.0) - o1) * C101;
  const real ks011 = (real(1.0) - o1) * C011;
  const real eq33 = (real(1.0) - o1) * (C200 - C020);
  const real eq34 = (real(1.0) - o1) * (C200 - C002);
  const real eq35 = k000;
  const real ks200 = (eq33 + eq34 + eq35) / real(3.0);
  const real ks020 = (-real(2.0) * eq33 + eq34 + eq35) / real(3.0);
  const real ks002 = (eq33 - real(2.0) * eq34 + eq35) / real(3.0);
  // orders 3, 5 and the order-3 products feeding orders 5-6 are zero
  real ks211, ks121, ks112, ks220, ks022, ks202, ks222;
  if constexpr (WELL) {
    // the shifted-space inverses of orders 4 and 6 (col_cum_well.h eqs. 53-56)
    ks211 = ((ks200 + third) * ks011 + real(2.0) * ks101 * ks110) * inv_rho;
    ks121 = ((ks020 + third) * ks101 + real(2.0) * ks110 * ks011) * inv_rho;
    ks112 = ((ks002 + third) * ks110 + real(2.0) * ks011 * ks101) * inv_rho;
    ks220 = (ks020 * ks200 + real(2.0) * ks110 * ks110 + (ks020 + ks200) * third) * inv_rho
            - k000 * inv_rho / real(9.0);
    ks022 = (ks002 * ks020 + real(2.0) * ks011 * ks011 + (ks002 + ks020) * third) * inv_rho
            - k000 * inv_rho / real(9.0);
    ks202 = (ks200 * ks002 + real(2.0) * ks101 * ks101 + (ks200 + ks002) * third) * inv_rho
            - k000 * inv_rho / real(9.0);
    const real sum_ks2 = ks200 + ks020 + ks002;
    const real sum_ks22 = ks022 + ks202 + ks220;
    const real sum_sq_s = ks101 * ks101 + ks011 * ks011 + ks110 * ks110;
    const real sum_pairs_s = ks200 * ks020 + ks200 * ks002 + ks020 * ks002;
    ks222 =
        (ks200 * ks022 + ks020 * ks202 + ks002 * ks220
         + real(4.0) * (ks011 * ks211 + ks101 * ks121 + ks110 * ks112)
         + sum_ks2 / real(9.0) + sum_ks22 * third) * inv_rho
        - (real(16.0) * ks110 * ks101 * ks011
           + real(4.0) * (ks101 * ks101 * ks020 + ks011 * ks011 * ks200 + ks110 * ks110 * ks002)
           + real(2.0) * ks200 * ks020 * ks002
           + (real(4.0) / real(3.0)) * sum_sq_s + (real(2.0) / real(3.0)) * sum_pairs_s + (real(2.0) / real(9.0)) * sum_ks2)
          * inv_rho * inv_rho
        - (k000 * k000 - k000) / real(27.0) * inv_rho * inv_rho;
  } else {
    // the inverses of orders 4 and 6 on total DFs (Geier 2015 eqs. 81-84)
    ks211 = (ks200 * ks011 + real(2.0) * ks101 * ks110) * inv_rho;
    ks121 = (ks020 * ks101 + real(2.0) * ks110 * ks011) * inv_rho;
    ks112 = (ks002 * ks110 + real(2.0) * ks011 * ks101) * inv_rho;
    ks220 = (ks020 * ks200 + real(2.0) * ks110 * ks110) * inv_rho;
    ks022 = (ks002 * ks020 + real(2.0) * ks011 * ks011) * inv_rho;
    ks202 = (ks200 * ks002 + real(2.0) * ks101 * ks101) * inv_rho;
    ks222 =
        (ks200 * ks022 + ks020 * ks202 + ks002 * ks220
         + real(4.0) * (ks011 * ks211 + ks101 * ks121 + ks110 * ks112)) * inv_rho
        - (real(16.0) * ks110 * ks101 * ks011
           + real(4.0) * (ks101 * ks101 * ks020 + ks011 * ks011 * ks200 + ks110 * ks110 * ks002)
           + real(2.0) * ks200 * ks020 * ks002)
          * inv_rho * inv_rho;
  }

  // inverse x: post-collision moments ks[a][b][g] per (b, g); the first
  // order is negated (trapezoidal forcing, col_cum.h:341-345)
  real bx[3][3][3];  // [ix][order y][order z]
  bwd_axis(k000, -k[1][0][0], ks200, ux, WELL, x_offset(0, 0), bx[0][0][0], bx[1][0][0], bx[2][0][0]);
  bwd_axis_k2z(-k[0][1][0], ks110, ux, bx[0][1][0], bx[1][1][0], bx[2][1][0]);
  bwd_axis_k1z(ks020, ks220, ux, WELL, x_offset(2, 0), bx[0][2][0], bx[1][2][0], bx[2][2][0]);
  bwd_axis_k2z(-k[0][0][1], ks101, ux, bx[0][0][1], bx[1][0][1], bx[2][0][1]);
  bwd_axis_k1z(ks011, ks211, ux, false, real(0.0), bx[0][1][1], bx[1][1][1], bx[2][1][1]);
  bwd_axis_k1only(ks121, ux, bx[0][2][1], bx[1][2][1], bx[2][2][1]);
  bwd_axis_k1z(ks002, ks202, ux, WELL, x_offset(0, 2), bx[0][0][2], bx[1][0][2], bx[2][0][2]);
  bwd_axis_k1only(ks112, ux, bx[0][1][2], bx[1][1][2], bx[2][1][2]);
  bwd_axis_k1z(ks022, ks222, ux, WELL, x_offset(2, 2), bx[0][2][2], bx[1][2][2], bx[2][2][2]);

  // inverse y, then z
  real by[3][3][3];  // [ix][iy][order z]
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

// The cumulant collision as a site update takes its collision (C::collide).
template <bool WELL>
struct Cum {
  template <class P>
  __device__ __forceinline__ static void collide(real (&f)[Q], real rho, real ux, real uy,
                                                 real uz, const P& p) {
    collide_cum<WELL>(f, rho, ux, uy, uz, p.omega1);
  }
};

// rho = sum_q f_q (+1 with WELL, deviation storage) and u = (j + F/2) / rho,
// summed over q in order (fused.py _moments_local); neumaier selects the
// compensated sum (reference USE_HIGH_PRECISION_RHO, d3q27/common.h:19-28).
template <bool WELL>
__device__ __forceinline__ void moments_local(const real (&f)[Q], real fx, real fy, real fz,
                                              bool neumaier, real& rho,
                                              real& ux, real& uy, real& uz) {
  real r;
  if (neumaier) {
    real s = f[0];
    real comp = real(0.0);
#pragma unroll
    for (int q = 1; q < Q; ++q) {
      const real x = f[q];
      const real t = s + x;
      comp = comp + (abs_r(s) >= abs_r(x) ? (s - t) + x : (x - t) + s);
      s = t;
    }
    r = s + comp;
  } else {
    r = f[0];
#pragma unroll
    for (int q = 1; q < Q; ++q) r = r + f[q];
  }
  if constexpr (WELL) rho = r + real(1.0); else rho = r;
  real jx = real(0.0), jy = real(0.0), jz = real(0.0);
#pragma unroll
  for (int q = 1; q < Q; ++q) {
    if (cx(q) > 0) jx = jx + f[q]; else if (cx(q) < 0) jx = jx - f[q];
    if (cy(q) > 0) jy = jy + f[q]; else if (cy(q) < 0) jy = jy - f[q];
    if (cz(q) > 0) jz = jz + f[q]; else if (cz(q) < 0) jz = jz - f[q];
  }
  ux = (jx + real(0.5) * fx) / rho;
  uy = (jy + real(0.5) * fy) / rho;
  uz = (jz + real(0.5) * fz) / rho;
}

// Pull-side BC transform (fused.py _pull_transform): full-way bounce-back
// swaps every direction with its opposite on WALL sites.
__device__ __forceinline__ void pull_transform(real (&f)[Q], uint8_t m) {
  if (m == GEO_WALL) {
#pragma unroll
    for (int q = 1; q < Q; q += 2) {
      const real t = f[q];
      f[q] = f[q + 1];
      f[q + 1] = t;
    }
  }
}

struct SiteParams {
  real omega1;      // 1 / (3 nu + 0.5)
  real fx, fy, fz;  // homogeneous body force
  int neumaier;      // compensated density sum
};

// Neighbour coordinate s + d on an axis of extent n: wrapped when periodic,
// clamped to the domain otherwise (the edge-replicated halo of pad_halo).
__device__ __forceinline__ int neighbour(int s, int d, int n, bool periodic) {
  const int t = s + d;
  if (periodic) return t < 0 ? t + n : (t >= n ? t - n : t);
  return t < 0 ? 0 : (t >= n ? n - 1 : t);
}

// Destinations along one axis of an A-A odd push from coordinate s with
// velocity c: t0 = s + c (wrapped, or -1 when it leaves a non-periodic
// domain) and t1 = s itself at the edge-replicated first/last layer, else
// -1.  Every destination gets exactly one writer (aa_odd.cu).
__device__ __forceinline__ void push_targets(int s, int c, int n, bool periodic,
                                             int& t0, int& t1) {
  t1 = -1;
  if (c == 0) {
    t0 = s;
  } else if (periodic) {
    t0 = neighbour(s, c, n, true);
  } else {
    const int t = s + c;
    t0 = (t >= 0 && t < n) ? t : -1;
    if ((c > 0 && s == 0) || (c < 0 && s == n - 1)) t1 = s;
  }
}

// fused.py _stream_bc_collide for one site of a FLUID/WALL/NOTHING map,
// CUM_WELL: f holds the pulled DFs on entry and the post-collision DFs on
// exit; (rho, u) are the macro outputs (WALL and NOTHING sites report
// rho = 1, u = 0).  P is SiteParams or ABParams.
template <class P>
__device__ __forceinline__ void stream_bc_collide(real (&f)[Q], uint8_t m, const P& p,
                                                  real& rho, real& ux, real& uy, real& uz) {
  pull_transform(f, m);
  moments_local<true>(f, p.fx, p.fy, p.fz, p.neumaier != 0, rho, ux, uy, uz);
  if (m == GEO_FLUID) {
    collide_cum<true>(f, rho == real(0.0) ? real(1.0) : rho, ux, uy, uz, p.omega1);
  } else {
    rho = real(1.0);
    ux = uy = uz = real(0.0);
  }
}

// ---------------------------------------------------------------- A-B step

// Equilibrium kinds of fused.py _eq_local: quadratic, well-conditioned
// (the deviation w (feq - 1)), inverse-cumulant and entropic (per-axis
// products).  EQ_DYN reads the kind at run time from CollParams::eq.
constexpr int EQ_QUAD = 0;
constexpr int EQ_WELL = 1;
constexpr int EQ_INVCUM = 2;
constexpr int EQ_ENTROPIC = 3;
constexpr int EQ_DYN = -1;

// c_q . u with the zero components left out.
__device__ __forceinline__ real c_dot(int q, real ux, real uy, real uz) {
  real s = real(0.0);
  bool any = false;
  if (cx(q) != 0) { s = cx(q) > 0 ? ux : -ux; any = true; }
  if (cy(q) != 0) { s = any ? (cy(q) > 0 ? s + uy : s - uy) : (cy(q) > 0 ? uy : -uy); any = true; }
  if (cz(q) != 0) { s = any ? (cz(q) > 0 ? s + uz : s - uz) : (cz(q) > 0 ? uz : -uz); }
  return s;
}

// One axis factor of the inverse-cumulant equilibrium (equilibrium.py
// eq_inv_cum): c = 0 -> (2 - 3 v^2) / 3, c = +-1 -> (3 v^2 +- 3 v + 1) / 6.
__device__ __forceinline__ real invcum_factor(int c, real v) {
  return c == 0 ? (real(2.0) - real(3.0) * v * v) / real(3.0)
                : (c > 0 ? (real(3.0) * v * v + real(3.0) * v + real(1.0)) / real(6.0)
                         : (real(3.0) * v * v - real(3.0) * v + real(1.0)) / real(6.0));
}

// One axis factor of the entropic equilibrium (equilibrium.py eq_entropic),
// s = sqrt(1 + 3 v^2): c = 0 -> (2/3) (2 - s), c = +-1 -> (1/6) (2 - s)
// ((2 v + s) / (1 - v))^{+-1}.  IEEE sqrt and division (no fast math).
__device__ __forceinline__ real entropic_factor(int c, real v) {
  const real s = sqrt_r(real(1.0) + real(3.0) * v * v);
  const real base = real(2.0) - s;
  if (c == 0) return (real(2.0) / real(3.0)) * base;
  const real r = (real(2.0) * v + s) / (real(1.0) - v);
  return c > 0 ? (real(1.0) / real(6.0)) * base * r : (real(1.0) / real(6.0)) * base / r;
}

// Equilibrium component q of kind EQ at (rho, u) (fused.py _eq_local).
template <int EQ>
__device__ __forceinline__ real eq_q(int q, real rho, real ux, real uy, real uz) {
  if constexpr (EQ == EQ_INVCUM) {
    return rho * invcum_factor(cx(q), ux) * invcum_factor(cy(q), uy) * invcum_factor(cz(q), uz);
  } else if constexpr (EQ == EQ_ENTROPIC) {
    return rho * entropic_factor(cx(q), ux) * entropic_factor(cy(q), uy) *
           entropic_factor(cz(q), uz);
  } else {
    const real uu = ux * ux + uy * uy + uz * uz;
    const real cu = c_dot(q, ux, uy, uz);
    const real feq = rho * (real(1.0) + real(3.0) * cu + real(4.5) * cu * cu - real(1.5) * uu);
    if constexpr (EQ == EQ_WELL) return weight(q) * (feq - real(1.0));
    else return weight(q) * feq;
  }
}

// Symmetry plane (boundary.py sym_table(3), apply_symmetry): the incoming
// components with c[AXIS] == SIGN take their mirror image's value.
template <int AXIS, int SIGN>
__device__ __forceinline__ void sym_mirror(real (&f)[Q]) {
#pragma unroll
  for (int q = 1; q < Q; ++q)
    if (cq(q, AXIS) == SIGN) f[q] = f[mirror(q, AXIS)];
}

// Pull-side transforms after the streaming reads (fused.py _pull_transform):
// the WALL swap and the six symmetry planes.  The outflow pull rules are
// reads, done by the kernel.
__device__ __forceinline__ void pull_transform_ab(real (&f)[Q], uint8_t m) {
  switch (m) {
    case GEO_WALL: pull_transform(f, m); break;
    case GEO_SYM_TOP: sym_mirror<2, -1>(f); break;
    case GEO_SYM_BOTTOM: sym_mirror<2, 1>(f); break;
    case GEO_SYM_LEFT: sym_mirror<0, 1>(f); break;
    case GEO_SYM_RIGHT: sym_mirror<0, -1>(f); break;
    case GEO_SYM_BACK: sym_mirror<1, 1>(f); break;
    case GEO_SYM_FRONT: sym_mirror<1, -1>(f); break;
    default: break;
  }
}

// Eichler moment inflow at the -x boundary (boundary.py
// inflow_left_moment_bc; reference d3q27/bc.h:77-128) on total DFs: the 9
// unknown c_x = +1 DFs are rebuilt from the prescribed velocity and the
// known DFs, which are only read; returns the density.
__device__ __forceinline__ real inflow_left_moment(real (&f)[Q], real vx, real vy,
                                                    real vz) {
#define FN(name) f[QConst<qn(name)>::value]
  const real g_zd = ((FN("zpp") + FN("zmm")) + FN("zpm")) + FN("zmp");
  const real g_za = ((FN("zpz") + FN("zmz")) + FN("zzp")) + FN("zzm");
  const real g_zb = ((FN("zzp") + FN("zzm")) + FN("zpz")) + FN("zmz");
  const real g_md = ((FN("mpp") + FN("mmm")) + FN("mpm")) + FN("mmp");
  const real g_ma = ((FN("mpz") + FN("mmz")) + FN("mzp")) + FN("mzm");
  const real s_zero = (FN("zzz") + g_zd) + g_za;
  const real s_minus = (FN("mzz") + g_md) + g_ma;
  const real rho = (s_zero + real(2.0) * s_minus) / (real(1.0) - vx);

  const real m100 = rho * vx;
  const real m010 = rho * vy;
  const real m001 = rho * vz;
  const real m011 = rho * vy * vz;
  const real m020 = rho / real(3.0) + rho * vy * vy;
  const real m002 = rho / real(3.0) + rho * vz * vz;
  const real m021 = rho * vz / real(3.0) + rho * vy * vy * vz;
  const real m012 = rho * vy / real(3.0) + rho * vy * vz * vz;
  const real m022 = rho / real(9.0) + rho / real(3.0) * (vy * vy + vz * vz) + rho * vy * vy * vz * vz;

  FN("pzz") = m100 + (m022 - (m020 + m002)) + FN("mzz") + (g_zd + g_zb) + real(2.0) * (g_md + g_ma);
  FN("ppz") = real(0.5) * ((m020 - m022) + (-m012 + m010)) - (FN("mpz") + FN("zpz"));
  FN("pmz") = real(0.5) * ((m020 - m022) + (m012 - m010)) - (FN("mmz") + FN("zmz"));
  FN("pzp") = real(0.5) * ((m002 - m022) + (-m021 + m001)) - (FN("mzp") + FN("zzp"));
  FN("pzm") = real(0.5) * ((m002 - m022) + (m021 - m001)) - (FN("mzm") + FN("zzm"));
  FN("ppp") = real(0.25) * ((m022 + m011) + (m021 + m012)) - (FN("mpp") + FN("zpp"));
  FN("ppm") = real(0.25) * ((m022 - m011) + (-m021 + m012)) - (FN("mpm") + FN("zpm"));
  FN("pmp") = real(0.25) * ((m022 - m011) + (m021 - m012)) - (FN("mmp") + FN("zmp"));
  FN("pmm") = real(0.25) * ((m022 + m011) + (-m021 - m012)) - (FN("mmm") + FN("zmm"));
#undef FN
  return rho;
}

struct ABParams {
  real omega1;            // 1 / (3 nu + 0.5)
  real fx, fy, fz;        // homogeneous body force
  real uin_x, uin_y, uin_z;  // inflow velocity (INFLOW, INFLOW_LEFT)
  int neumaier;            // compensated density sum
};

// The params of the family instances (coll_step.cuh): ABParams, the
// viscosity (MRT_LES and KBC read it), the equilibrium kind of an EQ_DYN
// instance, and KBC's shear part (1 the trace, 2 the heat flux, 4 its
// central moments).  A type of its own, so that the cumulant kernels'
// parameters stay as they were.
struct CollParams : ABParams {
  real nu;
  int eq;
  int kbc;
};

// The post-moment boundary rules of fused.py _stream_bc_collide
// (:313-348), per site: INFLOW_LEFT, INFLOW, OUTFLOW_EQ, OUTFLOW_RIGHT,
// OUTFLOW_RIGHT_INTERP.  f holds the pulled and transformed DFs, (rho, u)
// their moments; both are updated in place.  P is ABParams, or CollParams
// (EQ_DYN).
template <bool WELL, int EQ, class P>
__device__ __forceinline__ void ab_boundary(real (&f)[Q], uint8_t m, const P& p,
                                            real& rho, real& ux, real& uy, real& uz) {
  if constexpr (EQ == EQ_DYN) {
    // the kind is uniform over the launch: one branch for every thread
    if (p.eq == EQ_INVCUM)
      ab_boundary<WELL, EQ_INVCUM>(f, m, p, rho, ux, uy, uz);
    else if (p.eq == EQ_ENTROPIC)
      ab_boundary<WELL, EQ_ENTROPIC>(f, m, p, rho, ux, uy, uz);
    else
      ab_boundary<WELL, EQ_QUAD>(f, m, p, rho, ux, uy, uz);
    return;
  }
  switch (m) {
    case GEO_INFLOW_LEFT: {
      // the moment BC works on total DFs: add w_q first, subtract it after
      if constexpr (WELL) {
#pragma unroll
        for (int q = 0; q < Q; ++q) f[q] = f[q] + weight(q);
      }
      rho = inflow_left_moment(f, p.uin_x, p.uin_y, p.uin_z);
      if constexpr (WELL) {
#pragma unroll
        for (int q = 0; q < Q; ++q) f[q] = f[q] - weight(q);
      }
      ux = p.uin_x;
      uy = p.uin_y;
      uz = p.uin_z;
      break;
    }
    case GEO_INFLOW:
#pragma unroll
      for (int q = 0; q < Q; ++q) f[q] = eq_q<EQ>(q, real(1.0), p.uin_x, p.uin_y, p.uin_z);
      rho = real(1.0);
      ux = p.uin_x;
      uy = p.uin_y;
      uz = p.uin_z;
      break;
    case GEO_OUTFLOW_EQ:
#pragma unroll
      for (int q = 0; q < Q; ++q) f[q] = eq_q<EQ>(q, real(1.0), ux, uy, uz);
      rho = real(1.0);
      break;
    case GEO_OUTFLOW_RIGHT:
      rho = real(1.0);
      break;
    case GEO_OUTFLOW_RIGHT_INTERP:
      // equilibrium decomposition toward rho_out = 1 (reference bc.h:138-143)
#pragma unroll
      for (int q = 0; q < Q; ++q)
        f[q] = (f[q] + eq_q<EQ>(q, real(1.0), ux, uy, uz)) - eq_q<EQ>(q, rho, ux, uy, uz);
      rho = real(1.0);
      break;
    default:
      break;
  }
}

// fused.py _stream_bc_collide for one site after the pull, with the full
// 3D boundary set: the pull-side transforms (WALL swap, symmetry mirrors),
// the moments, the post-moment BCs and the collision where the code
// collides (the collision C, Cum<WELL> unless named).  v holds the pulled
// DFs on entry and the post-collision DFs on exit (NOTHING sites pass
// theirs through); (rho, u) are the macro outputs, WALL and NOTHING sites
// report rho = 1, u = 0.  The outflow pull rules are reads, done by the
// caller.  P is ABParams, or the family instances' CollParams.
template <bool WELL, int EQ, class C = Cum<WELL>, class P = ABParams>
__device__ __forceinline__ void site_collide(real (&v)[Q], uint8_t m, const P& p,
                                             real& rho, real& ux, real& uy, real& uz) {
  pull_transform_ab(v, m);
  moments_local<WELL>(v, p.fx, p.fy, p.fz, p.neumaier != 0, rho, ux, uy, uz);
  ab_boundary<WELL, EQ>(v, m, p, rho, ux, uy, uz);
  if (collides(m)) C::collide(v, rho == real(0.0) ? real(1.0) : rho, ux, uy, uz, p);
  if (m == GEO_WALL || m == GEO_NOTHING) {
    rho = real(1.0);
    ux = uy = uz = real(0.0);
  }
}

// speed of sound of the interpolated outflow (streaming.py SPEED_OF_SOUND)
// and 1 - it: in float32 each rounded once to float, in float64 as the
// plain version computes them (the literal and 1 - it in double)
#ifdef LBM_F64
constexpr double CS = 0.5773502691896257;
constexpr double ONE_MINUS_CS = 1.0 - CS;
#else
constexpr float CS = 0.5773502691896257f;
constexpr float ONE_MINUS_CS = 0.4226497308103743f;
#endif

// The A-B read at (x, y, z) with code m (fused.py _pull_transform's reads):
// pull f_q from x - c_q (wrapped on periodic axes, clamped to the edge site
// otherwise) and the outflow pull rules (OUTFLOW_RIGHT: every q from x-1;
// OUTFLOW_RIGHT_INTERP: the c_x = -1 components blend x-1 and x).  A row
// away from the x and y faces takes a short path with plain offsets; only
// z needs the wrap/clamp rule there.  Offsets are 64-bit.
__device__ __forceinline__ void ab_pull(const real* __restrict__ f, uint8_t m, int x, int y,
                                        int z, int X, int Y, int Z, int periodic_bits,
                                        real (&v)[Q]) {
  const int64_t N = (int64_t)X * Y * Z;
  const int64_t site = ((int64_t)x * Y + y) * Z + z;
  const bool px = periodic_bits & 1, py = periodic_bits & 2, pz = periodic_bits & 4;
  const int64_t sx = (int64_t)Y * Z, sy = Z;
  const bool row_inside = x > 0 && x < X - 1 && y > 0 && y < Y - 1;
  if (row_inside) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
      v[q] = f[q * N + site - cx(q) * sx - cy(q) * sy + (neighbour(z, -cz(q), Z, pz) - z)];
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int nx = neighbour(x, -cx(q), X, px);
      const int ny = neighbour(y, -cy(q), Y, py);
      const int nz = neighbour(z, -cz(q), Z, pz);
      v[q] = f[q * N + ((int64_t)nx * Y + ny) * Z + nz];
    }
  }
  if (m == GEO_OUTFLOW_RIGHT || m == GEO_OUTFLOW_RIGHT_INTERP) {
    // the outflow pull rules read x-1 (and x) in place of x - c_x
    const int64_t xm = neighbour(x, -1, X, px);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int64_t yz = (int64_t)neighbour(y, -cy(q), Y, py) * Z + neighbour(z, -cz(q), Z, pz);
      const real from_xm = f[q * N + xm * sx + yz];
      if (m == GEO_OUTFLOW_RIGHT)
        v[q] = from_xm;
      else if (cx(q) == -1)
        v[q] = CS * from_xm + ONE_MINUS_CS * f[q * N + (int64_t)x * sx + yz];
    }
  }
}

// The params of a site with a per-site force (the force_field variants):
// the homogeneous force of p plus the site's force from ff [3, X, Y, Z],
// as the plain hooked step adds the hook's output to the body force.  P is
// ABParams, or the family instances' CollParams, whose viscosity,
// equilibrium kind and KBC bits pass through; the collision takes the sum
// as its force (the SRT and BGK families' forcing terms read it).
template <class P>
__device__ __forceinline__ P site_params(const P& p, const real* __restrict__ ff, int64_t site,
                                         int64_t N) {
  P s = p;
  s.fx = p.fx + ff[site];
  s.fy = p.fy + ff[N + site];
  s.fz = p.fz + ff[2 * N + site];
  return s;
}

// A per-site inflow velocity (the profile instances of the A-B step):
// component a at (x, y, z) is u[a sa + x sx + y sy + z sz], in elements, so
// a profile that broadcasts to [3, X, Y, Z] (sim_2's [3, 1, Y, Z]) is read
// in place with stride 0 on its broadcast axes.
struct Profile {
  const real* u;
  int64_t sa, sx, sy, sz;
};

// The params of a site under an inflow profile: p with the site's own
// inflow velocity where the code reads one (INFLOW_LEFT, INFLOW); three
// loads at those sites only (fused.py _stream_bc_collide's u_in_field).
template <class P>
__device__ __forceinline__ P inflow_params(const P& p, const Profile& prof, uint8_t m, int x,
                                           int y, int z) {
  P s = p;
  if (m == GEO_INFLOW_LEFT || m == GEO_INFLOW) {
    const real* u = prof.u + x * prof.sx + y * prof.sy + z * prof.sz;
    s.uin_x = u[0];
    s.uin_y = u[prof.sa];
    s.uin_z = u[2 * prof.sa];
  }
  return s;
}

// One A-B site update of D3Q27 (fused.py _stream_bc_collide with the pull
// of make_fused_step), shared by the A-B step (ab_step.cu), the coupled
// step (coupled_ab.cu) and the one-kernel NN step (nn_step.cu): pull f_q
// from x - c_q (wrapped on periodic axes, clamped to the edge site
// otherwise), the outflow pull rules, the WALL swap and the symmetry
// mirrors, the moments, the post-moment BCs and the collision where the
// code collides.  Writes fout, rho_out and u_out at the site and returns
// the velocity it reported in (ux, uy, uz): NOTHING sites keep their stored
// DFs, WALL and NOTHING sites report rho = 1, u = 0.  FF (the force_field
// variant) adds the site's force from ff to p's; PROF (the profile
// instances) reads the inflow velocity of an INFLOW_LEFT or INFLOW site from
// prof in place of p's.  A row away from the x
// and y faces takes a short path with plain offsets; only z needs the
// wrap/clamp rule there.  Offsets are 64-bit.  The reads are ab_pull's,
// written out here: with the call in their place B7's instances took 88
// registers instead of 80 and ran 1.8% slower (tests/main_paths_ab.py:
// sim_coupled res 8 lost 5-7% MLUPS).  C is the collision (site_collide).
template <bool WELL, int EQ, bool FF = false, class C = Cum<WELL>, class P = ABParams,
          bool PROF = false>
__device__ __forceinline__ void ab_site(const real* __restrict__ f, real* __restrict__ fout,
                                        const uint8_t* __restrict__ map,
                                        real* __restrict__ rho_out, real* __restrict__ u_out,
                                        int x, int y, int z, int X, int Y, int Z,
                                        int periodic_bits, const P& p,
                                        real& ux, real& uy, real& uz,
                                        const real* __restrict__ ff = nullptr,
                                        Profile prof = Profile{}) {
  const int64_t N = (int64_t)X * Y * Z;
  const int64_t site = ((int64_t)x * Y + y) * Z + z;
  const bool px = periodic_bits & 1, py = periodic_bits & 2, pz = periodic_bits & 4;
  const int64_t sx = (int64_t)Y * Z, sy = Z;

  const uint8_t m = map[site];
  real v[Q];
  if (m == GEO_NOTHING) {
    // inert ghost site: its stored DFs, rho = 1, u = 0
#pragma unroll
    for (int q = 0; q < Q; ++q) fout[q * N + site] = f[q * N + site];
    rho_out[site] = real(1.0);
    u_out[site] = real(0.0);
    u_out[N + site] = real(0.0);
    u_out[2 * N + site] = real(0.0);
    ux = uy = uz = real(0.0);
    return;
  }
  const bool row_inside = x > 0 && x < X - 1 && y > 0 && y < Y - 1;
  if (row_inside) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
      v[q] = f[q * N + site - cx(q) * sx - cy(q) * sy + (neighbour(z, -cz(q), Z, pz) - z)];
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int nx = neighbour(x, -cx(q), X, px);
      const int ny = neighbour(y, -cy(q), Y, py);
      const int nz = neighbour(z, -cz(q), Z, pz);
      v[q] = f[q * N + ((int64_t)nx * Y + ny) * Z + nz];
    }
  }
  if (m == GEO_OUTFLOW_RIGHT || m == GEO_OUTFLOW_RIGHT_INTERP) {
    // the outflow pull rules read x-1 (and x) in place of x - c_x
    const int64_t xm = neighbour(x, -1, X, px);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int64_t yz = (int64_t)neighbour(y, -cy(q), Y, py) * Z + neighbour(z, -cz(q), Z, pz);
      const real from_xm = f[q * N + xm * sx + yz];
      if (m == GEO_OUTFLOW_RIGHT)
        v[q] = from_xm;
      else if (cx(q) == -1)
        v[q] = CS * from_xm + ONE_MINUS_CS * f[q * N + (int64_t)x * sx + yz];
    }
  }
  real rho;
  if constexpr (PROF)
    site_collide<WELL, EQ, C>(v, m, inflow_params(p, prof, m, x, y, z), rho, ux, uy, uz);
  else if constexpr (FF)
    site_collide<WELL, EQ, C>(v, m, site_params(p, ff, site, N), rho, ux, uy, uz);
  else
    site_collide<WELL, EQ, C>(v, m, p, rho, ux, uy, uz);
#pragma unroll
  for (int q = 0; q < Q; ++q) fout[q * N + site] = v[q];
  rho_out[site] = rho;
  u_out[site] = ux;
  u_out[N + site] = uy;
  u_out[2 * N + site] = uz;
}

// The u* pre-pass at one site (fused.py _stream_bc_collide with
// macro_only; reference kernels.h:178-218): the pulled DFs v after the WALL
// swap and the symmetry mirrors, their moments with p's homogeneous force
// written to rho_out / u_out.  Every code takes it, NOTHING too; no BC
// overrides the moments.
template <bool WELL>
__device__ __forceinline__ void macro_site(real (&v)[Q], uint8_t m, const ABParams& p,
                                           real* __restrict__ rho_out,
                                           real* __restrict__ u_out, int64_t site, int64_t N) {
  pull_transform_ab(v, m);
  real rho, ux, uy, uz;
  moments_local<WELL>(v, p.fx, p.fy, p.fz, p.neumaier != 0, rho, ux, uy, uz);
  rho_out[site] = rho;
  u_out[site] = ux;
  u_out[N + site] = uy;
  u_out[2 * N + site] = uz;
}

// ---------------------------------------------------------------- A-A steps

// One A-A even site update of D3Q27 (fused_aa.py even_kernel, reference
// streaming_AA.h:16-45), shared by the even step (aa_even.cu) and the
// coupled even step (coupled_aa.cu): read the site's own 27 DFs, same
// direction - every pull rule reads the site itself, as the JAX kernel's
// shifted() ignores its offsets - update them as the A-B step does, and
// write them to the opposite slots of the same site, in place.  NOTHING
// sites keep their stored DFs.  Writes rho_out and u_out and returns the
// reported velocity in (ux, uy, uz).  FF adds the site's force from ff; C
// is the collision (site_collide).
template <bool WELL, int EQ, bool FF = false, class C = Cum<WELL>, class P = ABParams>
__device__ __forceinline__ void aa_even_site(real* __restrict__ f,
                                             const uint8_t* __restrict__ map,
                                             real* __restrict__ rho_out,
                                             real* __restrict__ u_out, int64_t site, int64_t N,
                                             const P& p, real& ux, real& uy,
                                             real& uz, const real* __restrict__ ff = nullptr) {
  const uint8_t m = map[site];
  real rho = real(1.0);
  ux = uy = uz = real(0.0);
  if (m != GEO_NOTHING) {
    real v[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = f[q * N + site];
    if constexpr (FF)
      site_collide<WELL, EQ, C>(v, m, site_params(p, ff, site, N), rho, ux, uy, uz);
    else
      site_collide<WELL, EQ, C>(v, m, p, rho, ux, uy, uz);
#pragma unroll
    for (int q = 0; q < Q; ++q) f[q * N + site] = v[opp(q)];
  }
  rho_out[site] = rho;
  u_out[site] = ux;
  u_out[N + site] = uy;
  u_out[2 * N + site] = uz;
}

// The A-A odd read at (x, y, z) with code m (fused_aa.py odd_kernel,
// reference streaming_AA.h:47-76): f_in[q] = f[opp q](s - c_q), wrapped on
// periodic axes and clamped otherwise; OUTFLOW_RIGHT pulls f[opp q](x-1,
// y - c_y, z - c_z) (the JAX odd kernel's shifted() at the A-B rule's
// offsets); LEAN (a FLUID/WALL/NOTHING map) has no outflow.  A row away
// from the x and y faces takes a short path with plain x and y offsets.
template <bool LEAN>
__device__ __forceinline__ void aa_odd_pull(const real* __restrict__ f, uint8_t m, int x, int y,
                                            int z, int X, int Y, int Z, int periodic_bits,
                                            real (&v)[Q]) {
  const int64_t N = (int64_t)X * Y * Z;
  const int64_t site = ((int64_t)x * Y + y) * Z + z;
  const bool px = periodic_bits & 1, py = periodic_bits & 2, pz = periodic_bits & 4;
  const bool row_inside = x > 0 && x < X - 1 && y > 0 && y < Y - 1;
  const int64_t sx = (int64_t)Y * Z, sy = Z;
  if (row_inside) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
      v[q] = f[opp(q) * N + site - cx(q) * sx - cy(q) * sy + (neighbour(z, -cz(q), Z, pz) - z)];
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int nx = neighbour(x, -cx(q), X, px);
      const int ny = neighbour(y, -cy(q), Y, py);
      const int nz = neighbour(z, -cz(q), Z, pz);
      v[q] = f[opp(q) * N + ((int64_t)nx * Y + ny) * Z + nz];
    }
  }
  if (!LEAN && m == GEO_OUTFLOW_RIGHT) {
    const int64_t xm = neighbour(x, -1, X, px);
#pragma unroll
    for (int q = 0; q < Q; ++q)
      v[q] = f[opp(q) * N + xm * sx + (int64_t)neighbour(y, -cy(q), Y, py) * Z +
               neighbour(z, -cz(q), Z, pz)];
  }
}

// One A-A odd site update of D3Q27 (fused_aa.py odd_kernel, reference
// streaming_AA.h:47-76), shared by the odd step (aa_odd.cu), the coupled
// odd step (coupled_aa.cu) and the one-kernel NN step (nn_step.cu), out of
// place from f into fout.  Pull
// f_in[q] = f[opp q](s - c_q), wrapped on periodic axes and clamped
// otherwise; OUTFLOW_RIGHT pulls f[opp q](x-1, y - c_y, z - c_z) (the JAX
// odd kernel's shifted() at the A-B rule's offsets).  Update as the A-B
// step does, then push f_post[q] to the neighbours: the JAX step defines
// the push as f_out = pull(pad_halo(f_post)) with edge replication on the
// non-periodic axes, so destination x takes component q from the unique
// source clamp(x - c_q) (a wrap on periodic axes).  Read as a scatter,
// source s writes q to s + c_q when that lies in the domain and, on every
// non-periodic axis where s is the first layer and c = +1 or the last
// layer and c = -1, also to the layer s itself: up to 8 destinations at a
// corner, each destination with exactly one writer.  With a per-site force
// (FF) each site collides with its own force, so the edge-replicated layers
// carry the edge site's post-collision DFs - the JAX kernel's
// edge-replicated force ring with no ring.  NOTHING sites pass
// their pulled DFs on uncollided, as the plain step does; pushes aimed at
// a NOTHING destination are dropped and its own thread restores its
// stored DFs.  Writes rho_out and u_out and returns the reported velocity.
// A row away from the x and y faces (all but a thin shell) takes a short
// path with plain x and y offsets; only z needs the wrap/clamp and
// edge-replication rules there.  LEAN is CUM_WELL on a map of FLUID, WALL
// and NOTHING only: the pair's stream_bc_collide, without the boundary
// switch and the outflow read.  Offsets are 64-bit.  The reads are
// aa_odd_pull's, written out here as ab_site's are.  C is the collision
// (site_collide).
template <bool WELL, int EQ, bool LEAN, bool FF = false, class C = Cum<WELL>,
          class P = ABParams>
__device__ __forceinline__ void aa_odd_site(const real* __restrict__ f, real* __restrict__ fout,
                                            const uint8_t* __restrict__ map,
                                            real* __restrict__ rho_out,
                                            real* __restrict__ u_out, int x, int y, int z, int X,
                                            int Y, int Z, int periodic_bits, bool has_nothing,
                                            const P& p, real& ux, real& uy, real& uz,
                                            const real* __restrict__ ff = nullptr) {
  const int64_t N = (int64_t)X * Y * Z;
  const int64_t site = ((int64_t)x * Y + y) * Z + z;
  const bool px = periodic_bits & 1, py = periodic_bits & 2, pz = periodic_bits & 4;
  const bool row_inside = x > 0 && x < X - 1 && y > 0 && y < Y - 1;
  const int64_t sx = (int64_t)Y * Z, sy = Z;

  real v[Q];
  if (row_inside) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
      v[q] = f[opp(q) * N + site - cx(q) * sx - cy(q) * sy + (neighbour(z, -cz(q), Z, pz) - z)];
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int nx = neighbour(x, -cx(q), X, px);
      const int ny = neighbour(y, -cy(q), Y, py);
      const int nz = neighbour(z, -cz(q), Z, pz);
      v[q] = f[opp(q) * N + ((int64_t)nx * Y + ny) * Z + nz];
    }
  }
  const uint8_t m = map[site];
  if (!LEAN && m == GEO_OUTFLOW_RIGHT) {
    const int64_t xm = neighbour(x, -1, X, px);
#pragma unroll
    for (int q = 0; q < Q; ++q)
      v[q] = f[opp(q) * N + xm * sx + (int64_t)neighbour(y, -cy(q), Y, py) * Z +
               neighbour(z, -cz(q), Z, pz)];
  }
  real rho;
  if constexpr (LEAN) stream_bc_collide(v, m, p, rho, ux, uy, uz);
  else if constexpr (FF) site_collide<WELL, EQ, C>(v, m, site_params(p, ff, site, N), rho, ux, uy, uz);
  else site_collide<WELL, EQ, C>(v, m, p, rho, ux, uy, uz);

  // pushes aimed at a NOTHING site are dropped: its own thread restores it
  auto push = [&](int q, int64_t dst) {
    if (!(has_nothing && map[dst] == GEO_NOTHING)) fout[q * N + dst] = v[q];
  };
  if (row_inside) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      int tz0, tz1;
      push_targets(z, cz(q), Z, pz, tz0, tz1);
      const int64_t row = site - z + cx(q) * sx + cy(q) * sy;
      if (tz0 >= 0) push(q, row + tz0);
      if (tz1 >= 0) push(q, row + tz1);
    }
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      int tx[2], ty[2], tz[2];
      push_targets(x, cx(q), X, px, tx[0], tx[1]);
      push_targets(y, cy(q), Y, py, ty[0], ty[1]);
      push_targets(z, cz(q), Z, pz, tz[0], tz[1]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            if (tx[i] >= 0 && ty[j] >= 0 && tz[k] >= 0)
              push(q, ((int64_t)tx[i] * Y + ty[j]) * Z + tz[k]);
    }
  }
  if (m == GEO_NOTHING) {
#pragma unroll
    for (int q = 0; q < Q; ++q) fout[q * N + site] = f[q * N + site];
  }
  rho_out[site] = rho;
  u_out[site] = ux;
  u_out[N + site] = uy;
  u_out[2 * N + site] = uz;
}


// ------------------------------------------------- the sharded lattice's steps

// One A-B site update on a haloed shard block (the sharded A-B step's B4;
// JAX make_fused_step with prepadded=True, local_shape=(X, Y, Z)): f is
// [Q, X + 2, Y + 2, Z], the shard's block with a 1-wide x/y halo at origin
// (1, 1, 0); fout, the map, rho and u are the block itself, [X, Y, Z] (the
// map is not haloed: the outflow pulls from x-1 read f only).  Every x and
// y neighbour read comes from the halo, with no wrap or clamp on those axes;
// z keeps ab_site's wrap/clamp rule (pz).  The reads and the arithmetic are
// ab_site's, so a shard's site is the unsharded step's site bit for bit
// where the halo holds what the unsharded step reads there: the neighbour
// shard's layers, or at a non-periodic global face the edge-replicated ones.
template <bool WELL, int EQ>
__device__ __forceinline__ void ab_halo_site(const real* __restrict__ f, real* __restrict__ fout,
                                             const uint8_t* __restrict__ map,
                                             real* __restrict__ rho_out,
                                             real* __restrict__ u_out, int x, int y, int z, int X,
                                             int Y, int Z, bool pz, const ABParams& p) {
  const int64_t N = (int64_t)X * Y * Z;
  const int64_t site = ((int64_t)x * Y + y) * Z + z;
  const int64_t Yh = Y + 2, sx = Yh * Z, sy = Z;
  const int64_t Nh = (int64_t)(X + 2) * sx;
  const int64_t sh = ((int64_t)(x + 1) * Yh + (y + 1)) * Z + z;
  const uint8_t m = map[site];
  if (m == GEO_NOTHING) {
#pragma unroll
    for (int q = 0; q < Q; ++q) fout[q * N + site] = f[q * Nh + sh];
    rho_out[site] = real(1.0);
    u_out[site] = real(0.0);
    u_out[N + site] = real(0.0);
    u_out[2 * N + site] = real(0.0);
    return;
  }
  real v[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q)
    v[q] = f[q * Nh + sh - cx(q) * sx - cy(q) * sy + (neighbour(z, -cz(q), Z, pz) - z)];
  if (m == GEO_OUTFLOW_RIGHT || m == GEO_OUTFLOW_RIGHT_INTERP) {
    // the outflow pull rules read x-1 (and x) in place of x - c_x
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int64_t yz = sh - cy(q) * sy + (neighbour(z, -cz(q), Z, pz) - z);
      const real from_xm = f[q * Nh + yz - sx];
      if (m == GEO_OUTFLOW_RIGHT)
        v[q] = from_xm;
      else if (cx(q) == -1)
        v[q] = CS * from_xm + ONE_MINUS_CS * f[q * Nh + yz];
    }
  }
  real rho, ux, uy, uz;
  site_collide<WELL, EQ>(v, m, p, rho, ux, uy, uz);
#pragma unroll
  for (int q = 0; q < Q; ++q) fout[q * N + site] = v[q];
  rho_out[site] = rho;
  u_out[site] = ux;
  u_out[N + site] = uy;
  u_out[2 * N + site] = uz;
}

// Destinations along a sharded axis of the haloed odd push from local
// coordinate s (in [-1, n], the block and its ring) with velocity c: t0 =
// s + c where it lies in the block [0, n), else -1; t1 = s itself where s
// is the block's first layer on a global low face and c = +1, or its last
// layer on a global high face and c = -1 (the edge-replicated layer of
// push_targets), else -1.
__device__ __forceinline__ void block_targets(int s, int c, int n, bool glo, bool ghi, int& t0,
                                              int& t1) {
  const int t = s + c;
  t0 = (t >= 0 && t < n) ? t : -1;
  t1 = ((c > 0 && s == 0 && glo) || (c < 0 && s == n - 1 && ghi)) ? s : -1;
}

// One A-A odd site update on a haloed shard block (the sharded A-A step's
// B3; JAX _build_odd_call with prepadded=True, its map_ring_in and bflags):
// f is [Q, X + 4, Y + 4, Z], the shard's block with a 2-wide x/y halo at
// origin (2, 2, 0); ring is the map of the block and its 1-wide x/y ring,
// [X + 2, Y + 2, Z] at origin (1, 1, 0); fout, rho and u are the block.
// One thread per source site (x, y) in [-1, X] x [-1, Y]: the ring's sites
// are the neighbour shards' edge sites, collided again here, so that their
// pushes into the block need no exchange after the collision.  The read and
// the collision are aa_odd_site's.  The push writes destinations inside the
// block only: s + c_q, and on a global non-periodic face (gbits: bit 0 the
// low x face, 1 the high x face, 2 low y, 3 high y) also the layer s
// itself, which is aa_odd_site's edge replication; a ring site on such a
// face pushes nothing (its layer is the edge-replicated one).  z keeps
// aa_odd_site's rules (pz).  Pushes aimed at a NOTHING site of the block are
// dropped and its own thread restores its stored DFs.  A row away from the
// block's x and y faces takes a short path, as in aa_odd_site: there only
// z has targets to choose.
template <bool WELL, int EQ, bool LEAN>
__device__ __forceinline__ void aa_odd_halo_site(const real* __restrict__ f,
                                                 real* __restrict__ fout,
                                                 const uint8_t* __restrict__ ring,
                                                 real* __restrict__ rho_out,
                                                 real* __restrict__ u_out, int x, int y, int z,
                                                 int X, int Y, int Z, bool pz, int gbits,
                                                 bool has_nothing, const ABParams& p) {
  const bool gxl = gbits & 1, gxh = gbits & 2, gyl = gbits & 4, gyh = gbits & 8;
  if ((x < 0 && gxl) || (x >= X && gxh) || (y < 0 && gyl) || (y >= Y && gyh)) return;
  const int64_t N = (int64_t)X * Y * Z;
  const int64_t Yh = Y + 4, sx = Yh * Z, sy = Z;
  const int64_t Nh = (int64_t)(X + 4) * sx;
  const int64_t sh = ((int64_t)(x + 2) * Yh + (y + 2)) * Z + z;
  const int64_t Yr = Y + 2;
  const uint8_t m = ring[((int64_t)(x + 1) * Yr + (y + 1)) * Z + z];
  real v[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q)
    v[q] = f[opp(q) * Nh + sh - cx(q) * sx - cy(q) * sy + (neighbour(z, -cz(q), Z, pz) - z)];
  if (!LEAN && m == GEO_OUTFLOW_RIGHT) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
      v[q] = f[opp(q) * Nh + sh - sx - cy(q) * sy + (neighbour(z, -cz(q), Z, pz) - z)];
  }
  real rho, ux, uy, uz;
  if constexpr (LEAN) stream_bc_collide(v, m, p, rho, ux, uy, uz);
  else site_collide<WELL, EQ>(v, m, p, rho, ux, uy, uz);

  if (x > 0 && x < X - 1 && y > 0 && y < Y - 1) {
    // a row away from the block's x and y faces: every x/y destination lies
    // in the block, and only z takes push_targets' rules
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      int tz0, tz1;
      push_targets(z, cz(q), Z, pz, tz0, tz1);
      const int64_t row = ((int64_t)(x + cx(q)) * Y + (y + cy(q))) * Z;
      const int64_t rrow = ((int64_t)(x + 1 + cx(q)) * Yr + (y + 1 + cy(q))) * Z;
      if (tz0 >= 0 && !(has_nothing && ring[rrow + tz0] == GEO_NOTHING))
        fout[q * N + row + tz0] = v[q];
      if (tz1 >= 0 && !(has_nothing && ring[rrow + tz1] == GEO_NOTHING))
        fout[q * N + row + tz1] = v[q];
    }
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      int tx[2], ty[2], tz[2];
      block_targets(x, cx(q), X, gxl, gxh, tx[0], tx[1]);
      block_targets(y, cy(q), Y, gyl, gyh, ty[0], ty[1]);
      push_targets(z, cz(q), Z, pz, tz[0], tz[1]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            if (tx[i] >= 0 && ty[j] >= 0 && tz[k] >= 0 &&
                !(has_nothing &&
                  ring[((int64_t)(tx[i] + 1) * Yr + (ty[j] + 1)) * Z + tz[k]] == GEO_NOTHING))
              fout[q * N + ((int64_t)tx[i] * Y + ty[j]) * Z + tz[k]] = v[q];
    }
  }
  if (x < 0 || x >= X || y < 0 || y >= Y) return;  // a ring site: its own outputs are not ours
  const int64_t site = ((int64_t)x * Y + y) * Z + z;
  if (m == GEO_NOTHING) {
#pragma unroll
    for (int q = 0; q < Q; ++q) fout[q * N + site] = f[q * Nh + sh];
  }
  rho_out[site] = rho;
  u_out[site] = ux;
  u_out[N + site] = uy;
  u_out[2 * N + site] = uz;
}

}  // namespace lbm
