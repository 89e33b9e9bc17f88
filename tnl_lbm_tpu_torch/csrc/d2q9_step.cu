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
// path with plain offsets.  The TPU kernel's concatenate-built shifts have
// no counterpart here.  Offsets are 64-bit.
//
// Its whole-field-in-VMEM single program has one on small lattices: the
// resident chunk at the end of this file runs n steps in one launch on a
// lattice held in the shared memory of a thread-block cluster, through the
// same site update (`update`, over a load accessor), compiled without
// multiply-add contraction so that it equals n per-step launches bit for
// bit.  Bound of a chunk: its bytes once (85 B/site) or its operations (n
// site updates), whichever is larger; at the golden sweep's 128 x 32 the
// operations, and the time is the cluster barrier and the dependent
// shared-memory reads of each step.

#include <cooperative_groups.h>
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

// Where the site update reads the pre-streaming DFs of the global state
// [9, X, Y]: at(q, dx, dy) is f_q at (x + dx, y + dy), wrapped on periodic
// axes and clamped to the edge site otherwise; inner(q, dx, dy) the same
// for a site whose 8 neighbours lie inside the lattice; here(q) the site's
// own; theta(q) its Bouzidi theta of link q (q >= 1, from bz [8, X, Y]).
struct GlobalSrc {
  const float* __restrict__ f;
  const float* __restrict__ bz;
  int64_t N, s;
  int x, y, X, Y;
  bool px, py;
  __device__ __forceinline__ float theta(int q) const { return bz[(q - 1) * N + s]; }
  __device__ __forceinline__ float at(int q, int dx, int dy) const {
    return f[q * N + (int64_t)neighbour(x, dx, X, px) * Y + neighbour(y, dy, Y, py)];
  }
  __device__ __forceinline__ float inner(int q, int dx, int dy) const {
    return f[q * N + s + dx * (int64_t)Y + dy];
  }
  __device__ __forceinline__ float here(int q) const { return f[q * N + s]; }
};

// The site update (steps 1-12 above) of site (x, y), global index s of N,
// with map code m, reading the pre-streaming DFs through `src` (GlobalSrc,
// or the resident chunk's BandSrc): the new DFs v, rho and u.  Both kernels
// run this one body, so they do the same arithmetic in the same order; the
// source is compiled with -fmad=false (kernels/build.py), so no multiply-add
// is contracted in one kernel and not in the other, and the resident chunk
// equals the per-step launches bit for bit.
template <int COLL, bool FORCE, class Src>
__device__ __forceinline__ void update(const Src& src, uint8_t m, int x, int y, int X, int Y,
                                       int64_t N, int64_t s, const Params& p, float (&v)[Q],
                                       float& rho, float& ux, float& uy) {
  if (m == GEO_NOTHING) {
    // inert ghost site: its stored DFs, rho = 1, u = 0
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = src.here(q);
    rho = 1.0f;
    ux = uy = 0.0f;
    return;
  }
  // the site's global reads first, all in flight together: the thetas of a
  // ring site and an inflow site's profile value
  const bool ring = m == GEO_FLUID_NEAR_WALL && p.bz != nullptr;
  float th[Q];
  if (ring) {
#pragma unroll
    for (int q = 1; q < Q; ++q) th[q] = src.theta(q);
  }
  float in_x = p.uin_x, in_y = p.uin_y;
  if (m == GEO_INFLOW && p.uin != nullptr) {
    const int64_t o = x * p.uin_sx + y * p.uin_sy;
    in_x = p.uin[o];
    in_y = p.uin[o + p.uin_sc];
  }
  if (x > 0 && x < X - 1 && y > 0 && y < Y - 1) {
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = src.inner(q, -cx(q), -cy(q));
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = src.at(q, -cx(q), -cy(q));
  }
  if (m == GEO_OUTFLOW_RIGHT) {
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = src.at(q, -1, -cy(q));
  } else if (ring) {
    // every read of the interpolation first, both branches' values computed
    // and one kept (the same operations on the same values as a branch)
    float own[Q], beyond[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) own[q] = src.here(q);
#pragma unroll
    for (int q = 1; q < Q; ++q) beyond[q] = src.at(opp(q), cx(q), cy(q));
#pragma unroll
    for (int q = 1; q < Q; ++q) {
      const float f_opp = own[opp(q)];
      const float w = 0.5f / fmaxf(th[q], 0.25f);
      const float lo = 2.0f * th[q] * f_opp + (1.0f - 2.0f * th[q]) * beyond[q];
      const float hi = (1.0f - w) * own[q] + w * f_opp;
      // th < 0: the link does not hit the wall
      v[q] = th[q] < 0.0f ? v[q] : (th[q] <= 0.5f ? lo : hi);
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
  rho = v[0];
#pragma unroll
  for (int q = 1; q < Q; ++q) rho = rho + v[q];
  float jx = 0.0f, jy = 0.0f;
#pragma unroll
  for (int q = 1; q < Q; ++q) {
    if (cx(q) > 0) jx = jx + v[q]; else if (cx(q) < 0) jx = jx - v[q];
    if (cy(q) > 0) jy = jy + v[q]; else if (cy(q) < 0) jy = jy - v[q];
  }
  ux = (jx + 0.5f * p.fx) / rho;
  uy = (jy + 0.5f * p.fy) / rho;

  if (m == GEO_INFLOW) {
    ux = in_x;
    uy = in_y;
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
}

template <int COLL, bool FORCE>
__device__ __forceinline__ void site(const float* __restrict__ f, float* __restrict__ fout,
                                     const uint8_t* __restrict__ map, float* __restrict__ rho_out,
                                     float* __restrict__ u_out, int x, int y, int X, int Y,
                                     int periodic_bits, const Params& p) {
  const int64_t N = (int64_t)X * Y;
  const int64_t s = (int64_t)x * Y + y;
  const GlobalSrc src{f, p.bz, N, s, x, y, X, Y, (periodic_bits & 1) != 0,
                      (periodic_bits & 2) != 0};
  float v[Q], rho, ux, uy;
  update<COLL, FORCE>(src, map[s], x, y, X, Y, N, s, p, v, rho, ux, uy);
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

// Where the haloed step (the sharded lattice's B5) reads the pre-streaming
// DFs: a shard's block [9, X+2, Y+2] whose 1-wide ring holds the
// neighbouring shards' edge layers (or the wrap, or the edge replicated on a
// domain face), so every pull is a plain offset with no wrap or clamp; the
// thetas are the block's own [8, X, Y].  s is the site's index in the
// haloed block, sb in the block.
struct HaloSrc {
  const float* __restrict__ f;
  const float* __restrict__ bz;
  int64_t NP, N, s, sb;
  int YP;
  __device__ __forceinline__ float theta(int q) const { return bz[(q - 1) * N + sb]; }
  __device__ __forceinline__ float at(int q, int dx, int dy) const {
    return f[q * NP + s + dx * (int64_t)YP + dy];
  }
  __device__ __forceinline__ float inner(int q, int dx, int dy) const { return at(q, dx, dy); }
  __device__ __forceinline__ float here(int q) const { return f[q * NP + s]; }
};

// One site (x, y) of an X x Y block through the haloed reads: its map code,
// profile value and thetas at the block's own index, the new DFs, rho and u
// into the block [9, X, Y] (ff: the force_field variant's per-site force
// [2, X, Y], or null).
template <int COLL, bool FORCE, bool FF>
__device__ __forceinline__ void site_halo(const float* __restrict__ f, float* __restrict__ fout,
                                          const uint8_t* __restrict__ map,
                                          const float* __restrict__ ff,
                                          float* __restrict__ rho_out, float* __restrict__ u_out,
                                          int x, int y, int X, int Y, const Params& p0) {
  const int64_t N = (int64_t)X * Y;
  const int64_t sb = (int64_t)x * Y + y;
  const int YP = Y + 2;
  const HaloSrc src{f, p0.bz, (int64_t)(X + 2) * YP, N, (int64_t)(x + 1) * YP + y + 1, sb, YP};
  Params p = p0;
  if constexpr (FF) {
    p.fx = p0.fx + ff[sb];
    p.fy = p0.fy + ff[N + sb];
  }
  float v[Q], rho, ux, uy;
  update<COLL, FORCE>(src, map[sb], x, y, X, Y, N, sb, p, v, rho, ux, uy);
#pragma unroll
  for (int q = 0; q < Q; ++q) fout[q * N + sb] = v[q];
  rho_out[sb] = rho;
  u_out[sb] = ux;
  u_out[N + sb] = uy;
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

// The haloed step of the sharded lattice (JAX make_fused_step_2d with
// local_shape, run per shard by parallel/sharded.py make_sharded_fused_step_2d):
// one thread per site of the X x Y block, reading the block with its 1-wide
// ring [9, X+2, Y+2] (HaloSrc), the same five variants as the per-step
// kernel.  Bound: the block's 85 B/site, plus the ring's reads (the
// components that point into the block: 3 of 9 per ring site).
#define D2Q9_HALO_KERNEL(NAME, COLL, FORCE, FF)                                             \
  extern "C" __global__ void __launch_bounds__(d2q9::THREADS)                              \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                           \
           const uint8_t* __restrict__ map, const float* __restrict__ ff,                   \
           float* __restrict__ rho, float* __restrict__ u, int X, int Y, d2q9::Params p) {  \
    const int y = blockIdx.x * blockDim.x + threadIdx.x;                                    \
    if (y >= Y) return;                                                                     \
    d2q9::site_halo<COLL, FORCE, FF>(f, fout, map, ff, rho, u, blockIdx.y, y, X, Y, p);    \
  }

D2Q9_HALO_KERNEL(d2q9_halo_srt_kernel, d2q9::SRT, false, false)
D2Q9_HALO_KERNEL(d2q9_halo_srt_force_kernel, d2q9::SRT, true, false)
D2Q9_HALO_KERNEL(d2q9_halo_clbm_kernel, d2q9::CLBM, false, false)
D2Q9_HALO_KERNEL(d2q9_halo_srt_force_field_kernel, d2q9::SRT, true, true)
D2Q9_HALO_KERNEL(d2q9_halo_clbm_force_field_kernel, d2q9::CLBM, false, true)

// Launches the haloed step on `stream`: f is the haloed block [9, X+2, Y+2],
// fout, map, ff, bz, rho and u the block's own (X x Y); the other arguments
// as tnl_lbm_d2q9_step's (no periodic bits: the ring holds every neighbour;
// the profile's strides are those of the block's view).
extern "C" int tnl_lbm_d2q9_step_halo(const float* f, float* fout, const uint8_t* map,
                                      const float* ff, const float* bz, const float* uin,
                                      long long uin_sc, long long uin_sx, long long uin_sy,
                                      float* rho, float* u, int X, int Y, int variant, float nu,
                                      float fx, float fy, float uin_x, float uin_y, void* stream) {
  using Kernel = void (*)(const float*, float*, const uint8_t*, const float*, float*, float*, int,
                          int, d2q9::Params);
  Kernel kernel;
  switch (variant) {
    case 0: kernel = d2q9_halo_srt_kernel; break;
    case 1: kernel = d2q9_halo_srt_force_kernel; break;
    case 2: kernel = d2q9_halo_clbm_kernel; break;
    case 3: kernel = d2q9_halo_srt_force_field_kernel; break;
    case 4: kernel = d2q9_halo_clbm_force_field_kernel; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((variant >= 3 && ff == nullptr) || X < 1 || Y < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const d2q9::Params p{1.0f / (3.0f * nu + 0.5f), fx, fy, uin_x, uin_y, uin,
                       uin_sc, uin_sx, uin_sy, bz};
  const int block = Y >= d2q9::THREADS ? d2q9::THREADS : ((Y + 31) / 32) * 32;
  const dim3 grid((Y + block - 1) / block, X);
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(f, fout, map, ff, rho, u, X, Y, p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The resident chunk: n A-B steps in one launch on a lattice held in the
// shared memory of one thread-block cluster (the counterpart of the TPU
// kernel's whole field in VMEM and the JAX driver's lax.scan over it).
//
// One cluster of C blocks, one block per SM.  Block r owns the band of x
// rows [r R, r R + R), R = ceil(X / C) (the last bands may be short or
// empty), and holds two copies of the band's 9 DFs (ping-pong) and its map
// byte: 73 B/site.  A step pulls from the current copy and writes the
// other; the rows x +- 1 that belong to the neighbouring bands (and across
// a periodic x, the far band) are read from their blocks' shared memory
// through distributed shared memory (cluster.map_shared_rank), and the
// thetas and the inflow profile through L1 from global memory.  One
// cluster.sync() per step separates a step's writes from the next step's
// reads (and that step's writes from this one's reads).  The band is
// loaded from f once; the last step stores its DFs, rho and u to global
// memory.  f is read only before the first barrier, so fout may be f.
namespace d2q9 {

namespace cg = cooperative_groups;

// The chunk's size rule.  kernels/fused_2d.py (resident_limits) reads these
// constants from this file, so they stay integer literals.
// threads per block of the chunk, at most (one site per thread per pass)
constexpr int CHUNK_THREADS = 512;
// blocks of the cluster, one per SM (16: the most an H100 takes, non-portable)
constexpr int CLUSTER_MAX = 16;
// dynamic shared memory a chunk block may hold (200 KB)
constexpr int CHUNK_SMEM_MAX = 204800;
// shared memory per site: two copies of the 9 f32 DFs and the map byte,
// and with Bouzidi thetas their 8 f32
constexpr int CHUNK_BYTES_PER_SITE = 73;
constexpr int CHUNK_THETA_BYTES = 32;
static_assert(CHUNK_BYTES_PER_SITE == 2 * Q * 4 + 1 && CHUNK_THETA_BYTES == (Q - 1) * 4,
              "the chunk's shared-memory layout");

__host__ __device__ inline long long chunk_smem(int R, int Y, bool thetas) {
  return (long long)R * Y * (CHUNK_BYTES_PER_SITE + (thetas ? CHUNK_THETA_BYTES : 0));
}

// Reads of the resident chunk: row[1 + dx] is row x + dx (wrapped or
// clamped) of the current copy, component 0, in this block's shared memory
// or a neighbour's; P floats per component; th the site's thetas in this
// block's shared memory, P floats apart.
struct BandSrc {
  const float* row[3];
  const float* th;
  int P, y, Y;
  bool py;
  __device__ __forceinline__ float theta(int q) const { return th[(q - 1) * P]; }
  __device__ __forceinline__ float at(int q, int dx, int dy) const {
    return row[dx + 1][q * P + neighbour(y, dy, Y, py)];
  }
  __device__ __forceinline__ float inner(int q, int dx, int dy) const {
    return row[dx + 1][q * P + y + dy];
  }
  __device__ __forceinline__ float here(int q) const { return row[1][q * P + y]; }
};

template <int COLL, bool FORCE>
__device__ __forceinline__ void chunk(const float* f, float* fout,
                                      const uint8_t* __restrict__ map, float* __restrict__ rho_out,
                                      float* __restrict__ u_out, int X, int Y, int R,
                                      int periodic_bits, int n_steps, const Params& p) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 chunk_smem4[];
  __shared__ const float* peers[CLUSTER_MAX];
  float* buf = reinterpret_cast<float*>(chunk_smem4);
  const int P = R * Y;
  float* sth = buf + 2 * Q * P;  // the band's thetas, when the lattice has them
  uint8_t* smap = reinterpret_cast<uint8_t*>(sth + (p.bz != nullptr ? (Q - 1) * P : 0));
  const int rank = (int)cluster.block_rank();
  if ((int)threadIdx.x < (int)cluster.num_blocks())
    peers[threadIdx.x] = cluster.map_shared_rank(buf, (int)threadIdx.x);
  const int x0 = rank * R;
  const int sites = max(0, min(R, X - x0)) * Y;
  const int64_t N = (int64_t)X * Y, base = (int64_t)x0 * Y;
  const bool px = (periodic_bits & 1) != 0, py = (periodic_bits & 2) != 0;
  for (int k = threadIdx.x; k < sites; k += blockDim.x) {
#pragma unroll
    for (int q = 0; q < Q; ++q) buf[q * P + k] = f[q * N + base + k];
    smap[k] = map[base + k];
    if (p.bz != nullptr) {
#pragma unroll
      for (int q = 0; q < Q - 1; ++q) sth[q * P + k] = p.bz[q * N + base + k];
    }
  }
  cluster.sync();  // every band (and peers) in place before a neighbour reads it
  // Slots [0, edge) are the band's first and last rows, the only ones the
  // neighbouring bands read and the only ones that read them; the rest are
  // the interior rows in order.
  const int rows = sites / max(Y, 1), edge = min(sites, 2 * Y);
  auto band_site = [&](int k) {
    return k < Y ? k : (k < 2 * Y ? (rows - 1) * Y + k - Y : k - Y);
  };
  auto step_site = [&](int j, int cur, bool last) {
    const int lx = j / Y, y = j - lx * Y, x = x0 + lx;
    BandSrc src;
    src.row[1] = buf + cur + lx * Y;
#pragma unroll
    for (int d = -1; d <= 1; d += 2) {
      const int xx = neighbour(x, d, X, px), o = xx / R;
      src.row[d + 1] = peers[o] + cur + (xx - o * R) * Y;
    }
    src.th = sth + j;
    src.P = P;
    src.y = y;
    src.Y = Y;
    src.py = py;
    float v[Q], rho, ux, uy;
    update<COLL, FORCE>(src, smap[j], x, y, X, Y, N, base + j, p, v, rho, ux, uy);
    if (last) {
      const int64_t s = base + j;
#pragma unroll
      for (int q = 0; q < Q; ++q) fout[q * N + s] = v[q];
      rho_out[s] = rho;
      u_out[s] = ux;
      u_out[N + s] = uy;
    } else {
      float* nxt = buf + (Q * P - cur) + j;
#pragma unroll
      for (int q = 0; q < Q; ++q) nxt[q * P] = v[q];
    }
  };
  // A step: the edge rows, the cluster barrier's arrival (the neighbours
  // need nothing else of this block for this step), the interior rows while
  // the barrier completes, then this block's own step done and the
  // neighbours' edge rows done (the wait) before the next step reads them
  // or overwrites what they read.
  for (int it = 0; it < n_steps; ++it) {
    const int cur = (it & 1) * Q * P;
    const bool last = it == n_steps - 1;
    for (int k = threadIdx.x; k < edge; k += blockDim.x) step_site(band_site(k), cur, last);
    asm volatile("barrier.cluster.arrive;\n" ::: "memory");
    for (int k = threadIdx.x; k < sites; k += blockDim.x)
      if (k >= edge) step_site(band_site(k), cur, last);
    __syncthreads();
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
  }
}

}  // namespace d2q9

// f and fout carry no __restrict__: an even chunk stores into f itself.
#define D2Q9_CHUNK_KERNEL(NAME, COLL, FORCE)                                                  \
  extern "C" __global__ void __launch_bounds__(d2q9::CHUNK_THREADS, 1)                        \
      NAME(const float* f, float* fout, const uint8_t* __restrict__ map,                       \
           float* __restrict__ rho, float* __restrict__ u, int X, int Y, int R,                \
           int periodic_bits, int n_steps, d2q9::Params p) {                                   \
    d2q9::chunk<COLL, FORCE>(f, fout, map, rho, u, X, Y, R, periodic_bits, n_steps, p);       \
  }

D2Q9_CHUNK_KERNEL(d2q9_chunk_srt_kernel, d2q9::SRT, false)
D2Q9_CHUNK_KERNEL(d2q9_chunk_srt_force_kernel, d2q9::SRT, true)
D2Q9_CHUNK_KERNEL(d2q9_chunk_clbm_kernel, d2q9::CLBM, false)

namespace {

using ChunkKernel = void (*)(const float*, float*, const uint8_t*, float*, float*, int, int, int,
                             int, int, d2q9::Params);
// variant 0-2 as tnl_lbm_d2q9_step's
const ChunkKernel CHUNK_KERNELS[3] = {d2q9_chunk_srt_kernel, d2q9_chunk_srt_force_kernel,
                                      d2q9_chunk_clbm_kernel};

// Shared memory above 48 KB and clusters above 8 blocks are opt-ins.
cudaError_t chunk_opt_in() {
  for (ChunkKernel k : CHUNK_KERNELS) {
    const void* fn = reinterpret_cast<const void*>(k);
    cudaError_t rc =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, d2q9::CHUNK_SMEM_MAX);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

// The launch of a cluster of CLUSTER_MAX blocks with the band R of an X x Y
// lattice, or an error for what the kernel does not take.
cudaError_t chunk_config(int X, int Y, bool thetas, int* R, cudaLaunchConfig_t* cfg,
                         cudaLaunchAttribute* attr, void* stream) {
  static const cudaError_t opted = chunk_opt_in();
  if (opted != cudaSuccess) return opted;
  if (X < 1 || Y < 1) return cudaErrorInvalidValue;
  constexpr int cluster = d2q9::CLUSTER_MAX;
  *R = (X + cluster - 1) / cluster;
  const long long smem = d2q9::chunk_smem(*R, Y, thetas);
  if (smem > d2q9::CHUNK_SMEM_MAX) return cudaErrorInvalidValue;
  const int sites = *R * Y;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, 1, 1);
  cfg->blockDim = dim3(sites >= d2q9::CHUNK_THREADS ? d2q9::CHUNK_THREADS : (sites + 31) / 32 * 32,
                       1, 1);
  cfg->dynamicSmemBytes = (size_t)(smem + 15) / 16 * 16;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// n_steps (>= 1) A-B steps of the D2Q9 lattice in one cluster launch;
// arguments as tnl_lbm_d2q9_step's (variants 0-2; the force_field variants
// run per step).  The state after the last step goes to fout, which may be
// f; rho and u are the last step's.  Returns the CUDA error of the launch:
// cudaErrorInvalidValue for a variant or size the kernel does not take, the
// runtime's error where the card refuses the cluster.
extern "C" int tnl_lbm_d2q9_chunk(const float* f, float* fout, const uint8_t* map,
                                  const float* bz, const float* uin, long long uin_sc,
                                  long long uin_sx, long long uin_sy, float* rho, float* u, int X,
                                  int Y, int pbits, int variant, float nu, float fx, float fy,
                                  float uin_x, float uin_y, int n_steps, void* stream) {
  if (variant < 0 || variant > 2 || n_steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  int R;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t rc = chunk_config(X, Y, bz != nullptr, &R, &cfg, &attr, stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const d2q9::Params p{1.0f / (3.0f * nu + 0.5f), fx, fy, uin_x, uin_y, uin,
                       uin_sc, uin_sx, uin_sy, bz};
  rc = cudaLaunchKernelEx(&cfg, CHUNK_KERNELS[variant], f, fout, map, rho, u, X, Y, R, pbits,
                          n_steps, p);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// The chunk's launch geometry for an X x Y lattice (with Bouzidi thetas
// or not): out[0] the band's rows R, out[1] threads per block, out[2]
// dynamic shared memory bytes, out[3] the clusters of that shape the card
// can hold at once (0: it cannot launch one).  Returns the CUDA error.
extern "C" int tnl_lbm_d2q9_chunk_info(int X, int Y, int thetas, int* out) {
  int R;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t rc = chunk_config(X, Y, thetas != 0, &R, &cfg, &attr, nullptr);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int clusters = 0;
  rc = cudaOccupancyMaxActiveClusters(&clusters, CHUNK_KERNELS[2], &cfg);
  out[0] = R;
  out[1] = (int)cfg.blockDim.x;
  out[2] = (int)cfg.dynamicSmemBytes;
  out[3] = clusters;
  return static_cast<int>(rc);
}
