// Per-site D3Q27 logic shared by the A-A kernels (aa_even.cu, aa_odd.cu,
// aa_pair.cu).
//
// CUDA counterpart of the per-site code in tnl_lbm_tpu/kernels/fused.py:
// _moments_local (moments_local), _pull_transform (pull_transform: the
// WALL bounce-back swap), _stream_bc_collide (stream_bc_collide) and the
// zero-folded well-conditioned cumulant cascade of
// tnl_lbm_tpu/ops/collision.py:collide_cum(well=True) (collide_cum_well).
// The plain PyTorch versions of the same functions are in
// tnl_lbm_tpu_torch/kernels/fused.py and tnl_lbm_tpu_torch/ops/collision.py.
//
// One thread owns one site; its 27 DFs live in registers (every array
// index below is a compile-time constant once the loops are unrolled).
// All arithmetic is float32: every literal carries the f suffix, since a
// double literal would promote the cascade to FP64.  nvcc does not fold
// x * 0.0f or x + 0.0f under IEEE rules, so the terms that are structurally
// zero in this configuration (cumulants of order >= 3 relaxed to
// equilibrium, Geier 2017 limiters and anti-aliasing off, omega2 = 1) are
// folded out by hand, as the JAX package folds them at trace time.

#pragma once

#include <cstdint>

namespace lbm {

constexpr int Q = 27;

// GEO codes (tnl_lbm_tpu/ops/boundary.py) the kernels handle.
constexpr uint8_t GEO_FLUID = 0;
constexpr uint8_t GEO_WALL = 1;
constexpr uint8_t GEO_NOTHING = 8;

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

// Weight offsets of the well-conditioned cascade (collision.py
// central_moments / dfs_from_central_moments with well=True).  The forward
// and the inverse transform shift each axis triple by the same constant:
// z level by the number m of nonzero (cx, cy): 4/9, 1/9, 1/36;
// y level by (ix, order g): g = 0 -> 2/3 (centre) or 1/6, g = 2 -> 2/9 or
// 1/18, g = 1 -> none; x level by (order b, order g): (0,0) -> 1,
// (0,2)/(2,0) -> 1/3, (2,2) -> 1/9, any order 1 -> none.
__host__ __device__ constexpr float z_offset(int ix, int iy) {
  const int m = (ix != 1) + (iy != 1);
  return m == 0 ? 4.0f / 9.0f : (m == 1 ? 1.0f / 9.0f : 1.0f / 36.0f);
}
__host__ __device__ constexpr bool y_has_offset(int g) { return g != 1; }
__host__ __device__ constexpr float y_offset(int ix, int g) {
  return g == 0 ? (ix == 1 ? 2.0f / 3.0f : 1.0f / 6.0f)
                : (ix == 1 ? 2.0f / 9.0f : 1.0f / 18.0f);
}
__host__ __device__ constexpr bool x_has_offset(int b, int g) { return b != 1 && g != 1; }
__host__ __device__ constexpr float x_offset(int b, int g) {
  return (b == 0 && g == 0) ? 1.0f : ((b == 0 || g == 0) ? 1.0f / 3.0f : 1.0f / 9.0f);
}

// One axis of the forward central-moment cascade (Geier 2015 eqs. 6-8;
// collision.py _forward_axis): (f-, f0, f+) -> (k0, k1, k2).
__device__ __forceinline__ void fwd_axis(float fm, float fz, float fp, float v,
                                         bool has_off, float K0,
                                         float& k0, float& k1, float& k2) {
  const float s = fp + fm;
  const float d = fp - fm;
  k0 = s + fz;
  const float t = v * (has_off ? k0 + K0 : k0);
  const float w = v * d;
  k1 = d - t;
  k2 = (s - (w + w)) + v * t;
}

// One axis of the inverse cascade (eqs. 88-90; collision.py _backward_axis).
__device__ __forceinline__ void bwd_axis(float k0, float k1, float k2, float v,
                                         bool has_off, float K0,
                                         float& fm, float& fz, float& fp) {
  const float b = v * (has_off ? k0 + K0 : k0);
  const float a = v * b;
  const float t = v * k1;
  const float s = ((a + t) + t) + k2;
  const float w = b + k1;
  fz = k0 - s;
  fm = 0.5f * (s - w);
  fp = 0.5f * (s + w);
}

// bwd_axis with k2 == 0 (and no offset).
__device__ __forceinline__ void bwd_axis_k2z(float k0, float k1, float v,
                                             float& fm, float& fz, float& fp) {
  const float b = v * k0;
  const float a = v * b;
  const float t = v * k1;
  const float s = (a + t) + t;
  const float w = b + k1;
  fz = k0 - s;
  fm = 0.5f * (s - w);
  fp = 0.5f * (s + w);
}

// bwd_axis with k1 == 0.
__device__ __forceinline__ void bwd_axis_k1z(float k0, float k2, float v,
                                             bool has_off, float K0,
                                             float& fm, float& fz, float& fp) {
  const float b = v * (has_off ? k0 + K0 : k0);
  const float s = v * b + k2;
  fz = k0 - s;
  fm = 0.5f * (s - b);
  fp = 0.5f * (s + b);
}

// bwd_axis with k0 == k2 == 0 (and no offset).
__device__ __forceinline__ void bwd_axis_k1only(float k1, float v,
                                                float& fm, float& fz, float& fp) {
  const float t = v * k1;
  const float s = t + t;
  fz = -s;
  fm = 0.5f * (s - k1);
  fp = 0.5f * (s + k1);
}

// Well-conditioned cumulant collision (collision.py collide_cum with
// well=True and its defaults), in place on the 27 deviation DFs.  u already
// carries F/2; rho is the total density (never 0 here).
__device__ __forceinline__ void collide_cum_well(float (&f)[Q], float rho, float ux,
                                                 float uy, float uz, float omega1) {
  // forward: z, then y, then x
  float kz[3][3][3];  // [ix][iy][order z]
#pragma unroll
  for (int ix = 0; ix < 3; ++ix)
#pragma unroll
    for (int iy = 0; iy < 3; ++iy)
      fwd_axis(f[dir_index(ix, iy, 0)], f[dir_index(ix, iy, 1)], f[dir_index(ix, iy, 2)],
               uz, true, z_offset(ix, iy), kz[ix][iy][0], kz[ix][iy][1], kz[ix][iy][2]);
  float ky[3][3][3];  // [ix][order z][order y]
#pragma unroll
  for (int ix = 0; ix < 3; ++ix)
#pragma unroll
    for (int g = 0; g < 3; ++g)
      fwd_axis(kz[ix][0][g], kz[ix][1][g], kz[ix][2][g], uy, y_has_offset(g),
               y_offset(ix, g), ky[ix][g][0], ky[ix][g][1], ky[ix][g][2]);
  float k[3][3][3];  // [order x][order y][order z]; only orders <= 2 are used
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int g = 0; g < 3; ++g)
      fwd_axis(ky[0][g][b], ky[1][g][b], ky[2][g][b], ux, x_has_offset(b, g),
               x_offset(b, g), k[0][b][g], k[1][b][g], k[2][b][g]);

  const float k000 = k[0][0][0];
  const float C110 = k[1][1][0], C101 = k[1][0][1], C011 = k[0][1][1];
  const float C200 = k[2][0][0], C020 = k[0][2][0], C002 = k[0][0][2];
  const float inv_rho = 1.0f / rho;
  const float third = 1.0f / 3.0f;
  const float o1 = omega1;

  // second order (Geier 2017 eqs. 33-35, omega2 = 1, no anti-aliasing)
  const float ks110 = (1.0f - o1) * C110;
  const float ks101 = (1.0f - o1) * C101;
  const float ks011 = (1.0f - o1) * C011;
  const float eq33 = (1.0f - o1) * (C200 - C020);
  const float eq34 = (1.0f - o1) * (C200 - C002);
  const float eq35 = k000;
  const float ks200 = (eq33 + eq34 + eq35) / 3.0f;
  const float ks020 = (-2.0f * eq33 + eq34 + eq35) / 3.0f;
  const float ks002 = (eq33 - 2.0f * eq34 + eq35) / 3.0f;
  // orders 3, 5 and the order-3 products feeding orders 5-6 are zero; the
  // shifted-space inverses of orders 4 and 6 (col_cum_well.h eqs. 53-56)
  const float ks211 = ((ks200 + third) * ks011 + 2.0f * ks101 * ks110) * inv_rho;
  const float ks121 = ((ks020 + third) * ks101 + 2.0f * ks110 * ks011) * inv_rho;
  const float ks112 = ((ks002 + third) * ks110 + 2.0f * ks011 * ks101) * inv_rho;
  const float ks220 = (ks020 * ks200 + 2.0f * ks110 * ks110 + (ks020 + ks200) * third) * inv_rho
                      - k000 * inv_rho / 9.0f;
  const float ks022 = (ks002 * ks020 + 2.0f * ks011 * ks011 + (ks002 + ks020) * third) * inv_rho
                      - k000 * inv_rho / 9.0f;
  const float ks202 = (ks200 * ks002 + 2.0f * ks101 * ks101 + (ks200 + ks002) * third) * inv_rho
                      - k000 * inv_rho / 9.0f;
  const float sum_ks2 = ks200 + ks020 + ks002;
  const float sum_ks22 = ks022 + ks202 + ks220;
  const float sum_sq_s = ks101 * ks101 + ks011 * ks011 + ks110 * ks110;
  const float sum_pairs_s = ks200 * ks020 + ks200 * ks002 + ks020 * ks002;
  const float ks222 =
      (ks200 * ks022 + ks020 * ks202 + ks002 * ks220
       + 4.0f * (ks011 * ks211 + ks101 * ks121 + ks110 * ks112)
       + sum_ks2 / 9.0f + sum_ks22 * third) * inv_rho
      - (16.0f * ks110 * ks101 * ks011
         + 4.0f * (ks101 * ks101 * ks020 + ks011 * ks011 * ks200 + ks110 * ks110 * ks002)
         + 2.0f * ks200 * ks020 * ks002
         + (4.0f / 3.0f) * sum_sq_s + (2.0f / 3.0f) * sum_pairs_s + (2.0f / 9.0f) * sum_ks2)
        * inv_rho * inv_rho
      - (k000 * k000 - k000) / 27.0f * inv_rho * inv_rho;

  // inverse x: post-collision moments ks[a][b][g] per (b, g); the first
  // order is negated (trapezoidal forcing, col_cum.h:341-345)
  float bx[3][3][3];  // [ix][order y][order z]
  bwd_axis(k000, -k[1][0][0], ks200, ux, true, x_offset(0, 0), bx[0][0][0], bx[1][0][0], bx[2][0][0]);
  bwd_axis_k2z(-k[0][1][0], ks110, ux, bx[0][1][0], bx[1][1][0], bx[2][1][0]);
  bwd_axis_k1z(ks020, ks220, ux, true, x_offset(2, 0), bx[0][2][0], bx[1][2][0], bx[2][2][0]);
  bwd_axis_k2z(-k[0][0][1], ks101, ux, bx[0][0][1], bx[1][0][1], bx[2][0][1]);
  bwd_axis_k1z(ks011, ks211, ux, false, 0.0f, bx[0][1][1], bx[1][1][1], bx[2][1][1]);
  bwd_axis_k1only(ks121, ux, bx[0][2][1], bx[1][2][1], bx[2][2][1]);
  bwd_axis_k1z(ks002, ks202, ux, true, x_offset(0, 2), bx[0][0][2], bx[1][0][2], bx[2][0][2]);
  bwd_axis_k1only(ks112, ux, bx[0][1][2], bx[1][1][2], bx[2][1][2]);
  bwd_axis_k1z(ks022, ks222, ux, true, x_offset(2, 2), bx[0][2][2], bx[1][2][2], bx[2][2][2]);

  // inverse y, then z
  float by[3][3][3];  // [ix][iy][order z]
#pragma unroll
  for (int ix = 0; ix < 3; ++ix)
#pragma unroll
    for (int g = 0; g < 3; ++g)
      bwd_axis(bx[ix][0][g], bx[ix][1][g], bx[ix][2][g], uy, y_has_offset(g),
               y_offset(ix, g), by[ix][0][g], by[ix][1][g], by[ix][2][g]);
#pragma unroll
  for (int ix = 0; ix < 3; ++ix)
#pragma unroll
    for (int iy = 0; iy < 3; ++iy)
      bwd_axis(by[ix][iy][0], by[ix][iy][1], by[ix][iy][2], uz, true, z_offset(ix, iy),
               f[dir_index(ix, iy, 0)], f[dir_index(ix, iy, 1)], f[dir_index(ix, iy, 2)]);
}

// rho = 1 + sum_q f_q (well storage) and u = (j + F/2) / rho, summed over q
// in order (fused.py _moments_local); neumaier selects the compensated sum
// (reference USE_HIGH_PRECISION_RHO, d3q27/common.h:19-28).
__device__ __forceinline__ void moments_local(const float (&f)[Q], float fx, float fy, float fz,
                                              bool neumaier, float& rho,
                                              float& ux, float& uy, float& uz) {
  float r;
  if (neumaier) {
    float s = f[0];
    float comp = 0.0f;
#pragma unroll
    for (int q = 1; q < Q; ++q) {
      const float x = f[q];
      const float t = s + x;
      comp = comp + (fabsf(s) >= fabsf(x) ? (s - t) + x : (x - t) + s);
      s = t;
    }
    r = s + comp;
  } else {
    r = f[0];
#pragma unroll
    for (int q = 1; q < Q; ++q) r = r + f[q];
  }
  rho = r + 1.0f;
  float jx = 0.0f, jy = 0.0f, jz = 0.0f;
#pragma unroll
  for (int q = 1; q < Q; ++q) {
    if (cx(q) > 0) jx = jx + f[q]; else if (cx(q) < 0) jx = jx - f[q];
    if (cy(q) > 0) jy = jy + f[q]; else if (cy(q) < 0) jy = jy - f[q];
    if (cz(q) > 0) jz = jz + f[q]; else if (cz(q) < 0) jz = jz - f[q];
  }
  ux = (jx + 0.5f * fx) / rho;
  uy = (jy + 0.5f * fy) / rho;
  uz = (jz + 0.5f * fz) / rho;
}

// Pull-side BC transform (fused.py _pull_transform): full-way bounce-back
// swaps every direction with its opposite on WALL sites.
__device__ __forceinline__ void pull_transform(float (&f)[Q], uint8_t m) {
  if (m == GEO_WALL) {
#pragma unroll
    for (int q = 1; q < Q; q += 2) {
      const float t = f[q];
      f[q] = f[q + 1];
      f[q + 1] = t;
    }
  }
}

struct SiteParams {
  float omega1;      // 1 / (3 nu + 0.5)
  float fx, fy, fz;  // homogeneous body force
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

// fused.py _stream_bc_collide for one site: f holds the pulled DFs on entry
// and the post-collision DFs on exit; (rho, u) are the macro outputs
// (WALL and NOTHING sites report rho = 1, u = 0).
__device__ __forceinline__ void stream_bc_collide(float (&f)[Q], uint8_t m, const SiteParams& p,
                                                  float& rho, float& ux, float& uy, float& uz) {
  pull_transform(f, m);
  moments_local(f, p.fx, p.fy, p.fz, p.neumaier != 0, rho, ux, uy, uz);
  if (m == GEO_FLUID) {
    collide_cum_well(f, rho == 0.0f ? 1.0f : rho, ux, uy, uz, p.omega1);
  } else {
    rho = 1.0f;
    ux = uy = uz = 0.0f;
  }
}

}  // namespace lbm
