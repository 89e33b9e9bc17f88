// A-B step for D2Q9 in float32 with the 2D boundary set, the Bouzidi curved
// walls and per-site inflow profiles; SRT (with or without Guo forcing) or
// the cascaded CLBM.  One thread per site.
//
// Replaces the Pallas kernel of tnl_lbm_tpu/kernels/fused_2d.py
// make_fused_step_2d (kernel :133, pallas_call :244), in that kernel's order
// (:146-241), per site x:
//  1. pull f_q from x - c_q, wrapped on periodic axes and clamped to the
//     edge site otherwise (a pull off the edge reads the edge site);
//  2. OUTFLOW_RIGHT: every q from (x-1, y - c_y);
//  3. FLUID_NEAR_WALL (with thetas): the Bouzidi two-branch interpolation
//     from the pre-streaming state (ops/streaming.py bouzidi): theta < 0
//     keeps the pulled value, theta <= 1/2 takes
//     2 theta f_opp(x) + (1 - 2 theta) f_opp(x + c_q), theta > 1/2 takes
//     (1 - w) f_q(x) + w f_opp(x) with w = 1/2 / max(theta, 1/4);
//  4. WALL: bounce-back, on the DFs the rules above produced;
//  5. moments, u = (j + F/2) / rho;
//  6. INFLOW: eq(1, u_in), rho = 1, u = u_in (a vector, or a profile read
//     through its strides, 0 along a broadcast axis);
//  7. OUTFLOW_EQ: eq(1, u), rho = 1;  8. OUTFLOW_RIGHT: rho = 1;
//  9. the collision sees rho = 1 where rho == 0;
// 10. SRT (Guo's term only when a force was passed) or CLBM on FLUID,
//     OUTFLOW_RIGHT and FLUID_NEAR_WALL;
// 11. NOTHING keeps its pre-streaming DFs; 12. WALL and NOTHING report
//     rho = 1, u = 0.
// The plain PyTorch version is kernels/fused.py _stream_bc_collide with
// the D2Q9 collisions of ops/collision_2d.py (kernels/fused_2d.py).
//
// Bound: HBM bytes.  Per site and step 9 f32 are read and 9 written (72 B),
// plus the 1-byte map and the 12 B of rho and u: 85 B/site.  The thetas
// (32 B) are read only at near-wall sites and the profile only at INFLOW
// sites.  The site update is about 150-250 FP32 operations, far below what
// the card does in the time it takes to move 85 B.  Design: y is the
// contiguous axis of [9, X, Y], and threadIdx.x runs along y, so each
// component's pull (shifted by c_y) and every store are contiguous runs of
// a warp; a block is 128 sites of one x row, and the rows x +- 1 are re-read
// by the neighbouring blocks through L1/L2.  The cascade runs in registers;
// no shared memory.  Rows away from the x faces and y edges take a short
// path with plain offsets.  The TPU kernel's whole-field-in-VMEM single
// program and its concatenate-built shifts have no counterpart here.
// Offsets are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "lbm_site.cuh"

namespace d2q9 {

using lbm::GEO_FLUID;
using lbm::GEO_INFLOW;
using lbm::GEO_NOTHING;
using lbm::GEO_OUTFLOW_EQ;
using lbm::GEO_OUTFLOW_RIGHT;
using lbm::GEO_WALL;
using lbm::neighbour;

// the Bouzidi code of the D2Q9 set (tnl_lbm_tpu/ops/boundary.py)
constexpr uint8_t GEO_FLUID_NEAR_WALL = 15;

constexpr int Q = 9;
constexpr int THREADS = 128;
constexpr int SRT = 0;
constexpr int CLBM = 1;

// Directions in the descriptor's order: zz pz mz zp zm pp mm pm mp
// (tnl_lbm_tpu_torch/models/descriptors.py D2Q9).
__host__ __device__ constexpr int cx(int q) {
  return (q == 1 || q == 5 || q == 7) ? 1 : ((q == 2 || q == 6 || q == 8) ? -1 : 0);
}
__host__ __device__ constexpr int cy(int q) {
  return (q == 3 || q == 5 || q == 8) ? 1 : ((q == 4 || q == 6 || q == 7) ? -1 : 0);
}
// Opposite directions are neighbours in the enum: (1,2), (3,4), (5,6), (7,8).
__host__ __device__ constexpr int opp(int q) { return q == 0 ? 0 : ((q & 1) ? q + 1 : q - 1); }
__host__ __device__ constexpr float weight(int q) {
  return q == 0 ? 4.0f / 9.0f : (q < 5 ? 1.0f / 9.0f : 1.0f / 36.0f);
}
// The direction of the tensor slot [ix][iy], i = c + 1.
__host__ __device__ constexpr int slot(int ix, int iy) {
  return ix == 0 ? (iy == 0 ? 6 : (iy == 1 ? 2 : 8))
         : ix == 1 ? (iy == 0 ? 4 : (iy == 1 ? 0 : 3))
                   : (iy == 0 ? 7 : (iy == 1 ? 1 : 5));
}

// c_q . v, added as the plain version adds it (cx vx + cy vy, zeros left out).
__device__ __forceinline__ float c_dot(int q, float vx, float vy) {
  if (cx(q) == 0) return cy(q) == 0 ? 0.0f : (cy(q) > 0 ? vy : -vy);
  const float s = cx(q) > 0 ? vx : -vx;
  return cy(q) == 0 ? s : (cy(q) > 0 ? s + vy : s - vy);
}

// The boundary rules' equilibrium at rho = 1 (fused.py _eq_local, "quad").
__device__ __forceinline__ float eq_unit(int q, float ux, float uy) {
  const float uu = ux * ux + uy * uy;
  const float cu = c_dot(q, ux, uy);
  return weight(q) * (1.0f + 3.0f * cu + 4.5f * cu * cu - 1.5f * uu);
}

struct Params {
  float omega;                    // 1 / (3 nu + 0.5)
  float fx, fy;                   // homogeneous body force (0 when none was passed)
  float uin_x, uin_y;             // the inflow vector, when uin is null
  const float* uin;               // the inflow profile, or null
  long long uin_sc, uin_sx, uin_sy;  // its strides: component, x, y
  const float* bz;                // the Bouzidi thetas [8, X, Y], or null
};

// D2Q9 SRT (ops/collision_2d.py collide_srt_2d with eq_quadratic), with
// Guo's forcing term when FORCE.
template <bool FORCE>
__device__ __forceinline__ void collide_srt(float (&f)[Q], float rho, float ux, float uy,
                                            const Params& p) {
  const float o = p.omega;
  const float uu = ux * ux + uy * uy;
  const float uF = ux * p.fx + uy * p.fy;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float cu = c_dot(q, ux, uy);
    const float feq = weight(q) * rho * (1.0f + 3.0f * cu + 4.5f * cu * cu - 1.5f * uu);
    f[q] = f[q] + (feq - f[q]) * o;
    if constexpr (FORCE) {
      const float cF = c_dot(q, p.fx, p.fy);
      const float body = 3.0f * (cF - uF) + 9.0f * cu * cF;
      f[q] = f[q] + (1.0f - 0.5f * o) * (weight(q) * body);
    }
  }
}

// D2Q9 cascaded LBM (ops/collision_2d.py collide_clbm_2d): central moments
// along y, then x; the shear moments relax at omega, the trace, orders 3
// and 4 at rate 1 to (2 rho / 3, 0, rho / 9), the first order is negated;
// back along x, then y.  u carries F/2.
__device__ __forceinline__ void collide_clbm(float (&f)[Q], float rho, float ux, float uy,
                                             float omega) {
  float ky[3][3];  // [ix][order y]
#pragma unroll
  for (int ix = 0; ix < 3; ++ix)
    lbm::fwd_axis(f[slot(ix, 0)], f[slot(ix, 1)], f[slot(ix, 2)], uy, false, 0.0f, ky[ix][0],
                  ky[ix][1], ky[ix][2]);
  float k[3][3];  // [order x][order y]
#pragma unroll
  for (int b = 0; b < 3; ++b)
    lbm::fwd_axis(ky[0][b], ky[1][b], ky[2][b], ux, false, 0.0f, k[0][b], k[1][b], k[2][b]);

  const float diff_s = (1.0f - omega) * (k[2][0] - k[0][2]);
  const float trace_s = (2.0f / 3.0f) * rho;
  const float ks[3][3] = {{k[0][0], -k[0][1], 0.5f * (trace_s - diff_s)},
                          {-k[1][0], (1.0f - omega) * k[1][1], 0.0f},
                          {0.5f * (trace_s + diff_s), 0.0f, rho / 9.0f}};
  float bx[3][3];  // [ix][order y]
#pragma unroll
  for (int b = 0; b < 3; ++b)
    lbm::bwd_axis(ks[0][b], ks[1][b], ks[2][b], ux, false, 0.0f, bx[0][b], bx[1][b], bx[2][b]);
#pragma unroll
  for (int ix = 0; ix < 3; ++ix)
    lbm::bwd_axis(bx[ix][0], bx[ix][1], bx[ix][2], uy, false, 0.0f, f[slot(ix, 0)],
                  f[slot(ix, 1)], f[slot(ix, 2)]);
}

template <int COLL, bool FORCE>
__device__ __forceinline__ void site(const float* __restrict__ f, float* __restrict__ fout,
                                     const uint8_t* __restrict__ map, float* __restrict__ rho_out,
                                     float* __restrict__ u_out, int x, int y, int X, int Y,
                                     int periodic_bits, const Params& p) {
  const int64_t N = (int64_t)X * Y;
  const int64_t s = (int64_t)x * Y + y;
  const bool px = periodic_bits & 1, py = periodic_bits & 2;
  const uint8_t m = map[s];
  if (m == GEO_NOTHING) {
    // inert ghost site: its stored DFs, rho = 1, u = 0
#pragma unroll
    for (int q = 0; q < Q; ++q) fout[q * N + s] = f[q * N + s];
    rho_out[s] = 1.0f;
    u_out[s] = 0.0f;
    u_out[N + s] = 0.0f;
    return;
  }
  auto at = [&](int q, int dx, int dy) {
    return f[q * N + (int64_t)neighbour(x, dx, X, px) * Y + neighbour(y, dy, Y, py)];
  };
  float v[Q];
  if (x > 0 && x < X - 1 && y > 0 && y < Y - 1) {
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = f[q * N + s - cx(q) * (int64_t)Y - cy(q)];
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = at(q, -cx(q), -cy(q));
  }
  if (m == GEO_OUTFLOW_RIGHT) {
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = at(q, -1, -cy(q));
  } else if (m == GEO_FLUID_NEAR_WALL && p.bz != nullptr) {
#pragma unroll
    for (int q = 1; q < Q; ++q) {
      const float th = p.bz[(q - 1) * N + s];
      if (th < 0.0f) continue;  // the link does not hit the wall
      const float f_opp = f[opp(q) * N + s];
      if (th <= 0.5f) {
        v[q] = 2.0f * th * f_opp + (1.0f - 2.0f * th) * at(opp(q), cx(q), cy(q));
      } else {
        const float w = 0.5f / fmaxf(th, 0.25f);
        v[q] = (1.0f - w) * f[q * N + s] + w * f_opp;
      }
    }
  }
  if (m == GEO_WALL) {
#pragma unroll
    for (int q = 1; q < Q; q += 2) {
      const float t = v[q];
      v[q] = v[q + 1];
      v[q + 1] = t;
    }
  }

  // moments: sequential sums over q (fused.py _moments_local)
  float rho = v[0];
#pragma unroll
  for (int q = 1; q < Q; ++q) rho = rho + v[q];
  float jx = 0.0f, jy = 0.0f;
#pragma unroll
  for (int q = 1; q < Q; ++q) {
    if (cx(q) > 0) jx = jx + v[q]; else if (cx(q) < 0) jx = jx - v[q];
    if (cy(q) > 0) jy = jy + v[q]; else if (cy(q) < 0) jy = jy - v[q];
  }
  float ux = (jx + 0.5f * p.fx) / rho;
  float uy = (jy + 0.5f * p.fy) / rho;

  if (m == GEO_INFLOW) {
    if (p.uin != nullptr) {
      const int64_t o = x * p.uin_sx + y * p.uin_sy;
      ux = p.uin[o];
      uy = p.uin[o + p.uin_sc];
    } else {
      ux = p.uin_x;
      uy = p.uin_y;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = eq_unit(q, ux, uy);
    rho = 1.0f;
  } else if (m == GEO_OUTFLOW_EQ) {
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = eq_unit(q, ux, uy);
    rho = 1.0f;
  } else if (m == GEO_OUTFLOW_RIGHT) {
    rho = 1.0f;
  }

  if (m == GEO_FLUID || m == GEO_OUTFLOW_RIGHT || m == GEO_FLUID_NEAR_WALL) {
    const float rho_c = rho == 0.0f ? 1.0f : rho;
    if constexpr (COLL == SRT)
      collide_srt<FORCE>(v, rho_c, ux, uy, p);
    else
      collide_clbm(v, rho_c, ux, uy, p.omega);
  }
  if (m == GEO_WALL) {
    rho = 1.0f;
    ux = uy = 0.0f;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) fout[q * N + s] = v[q];
  rho_out[s] = rho;
  u_out[s] = ux;
  u_out[N + s] = uy;
}

// One site of the force_field variant: the site's force from ff [2, X, Y]
// added to the homogeneous one, for the moments and Guo's term.
template <int COLL, bool FORCE>
__device__ __forceinline__ void site_ff(const float* __restrict__ f, float* __restrict__ fout,
                                        const uint8_t* __restrict__ map,
                                        const float* __restrict__ ff,
                                        float* __restrict__ rho_out, float* __restrict__ u_out,
                                        int x, int y, int X, int Y, int periodic_bits,
                                        const Params& p0) {
  const int64_t N = (int64_t)X * Y;
  const int64_t s = (int64_t)x * Y + y;
  Params p = p0;
  p.fx = p0.fx + ff[s];
  p.fy = p0.fy + ff[N + s];
  site<COLL, FORCE>(f, fout, map, rho_out, u_out, x, y, X, Y, periodic_bits, p);
}

}  // namespace d2q9

// One kernel per (collision, force, per-site force); named so that the
// -Xptxas -v report can be read per instance.  CLBM takes the force through
// u alone, so it has one without a per-site force.  The force_field
// instances (JAX fused_2d.py:80-90, 134-146, the carrier of the 2D forcing
// hooks) read the per-site force: 8 B/site more, 93 B/site with the 85 B
// of the step.
#define D2Q9_KERNEL(NAME, COLL, FORCE, FF)                                                   \
  extern "C" __global__ void __launch_bounds__(d2q9::THREADS)                               \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                            \
           const uint8_t* __restrict__ map, const float* __restrict__ ff,                    \
           float* __restrict__ rho, float* __restrict__ u, int X, int Y, int periodic_bits,  \
           d2q9::Params p) {                                                                 \
    const int y = blockIdx.x * blockDim.x + threadIdx.x;                                     \
    if (y >= Y) return;                                                                      \
    if constexpr (FF)                                                                        \
      d2q9::site_ff<COLL, FORCE>(f, fout, map, ff, rho, u, blockIdx.y, y, X, Y,              \
                                 periodic_bits, p);                                          \
    else                                                                                     \
      d2q9::site<COLL, FORCE>(f, fout, map, rho, u, blockIdx.y, y, X, Y, periodic_bits, p);  \
  }

D2Q9_KERNEL(d2q9_srt_kernel, d2q9::SRT, false, false)
D2Q9_KERNEL(d2q9_srt_force_kernel, d2q9::SRT, true, false)
D2Q9_KERNEL(d2q9_clbm_kernel, d2q9::CLBM, false, false)
D2Q9_KERNEL(d2q9_srt_force_field_kernel, d2q9::SRT, true, true)
D2Q9_KERNEL(d2q9_clbm_force_field_kernel, d2q9::CLBM, false, true)

// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown variant.  pbits (periodic axes): bit 0
// x, bit 1 y.  variant: 0 SRT, 1 SRT with Guo forcing, 2 CLBM, 3 SRT with a
// per-site force (Guo's term with it), 4 CLBM with a per-site force (ff:
// the force [2, X, Y], added to (fx, fy)).  uin: the inflow profile with its
// strides in elements (component, x, y), or null for the vector (uin_x,
// uin_y); bz: the thetas [8, X, Y] or null.
extern "C" int tnl_lbm_d2q9_step(const float* f, float* fout, const uint8_t* map, const float* ff,
                                 const float* bz, const float* uin, long long uin_sc,
                                 long long uin_sx, long long uin_sy, float* rho, float* u, int X,
                                 int Y, int pbits, int variant, float nu, float fx, float fy,
                                 float uin_x, float uin_y, void* stream) {
  using Kernel = void (*)(const float*, float*, const uint8_t*, const float*, float*, float*, int,
                          int, int, d2q9::Params);
  Kernel kernel;
  switch (variant) {
    case 0: kernel = d2q9_srt_kernel; break;
    case 1: kernel = d2q9_srt_force_kernel; break;
    case 2: kernel = d2q9_clbm_kernel; break;
    case 3: kernel = d2q9_srt_force_field_kernel; break;
    case 4: kernel = d2q9_clbm_force_field_kernel; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant >= 3 && ff == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const d2q9::Params p{1.0f / (3.0f * nu + 0.5f), fx, fy, uin_x, uin_y, uin,
                       uin_sc, uin_sx, uin_sy, bz};
  const int block = Y >= d2q9::THREADS ? d2q9::THREADS : ((Y + 31) / 32) * 32;
  const dim3 grid((Y + block - 1) / block, X);
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(f, fout, map, ff, rho, u, X, Y,
                                                                 pbits, p);
  return static_cast<int>(cudaGetLastError());
}
