// A-B step for D3Q27 (CUM_WELL or CUM) in float32 with the full 3D
// boundary set, one thread per site.
//
// Replaces the Pallas kernel of tnl_lbm_tpu/kernels/fused.py
// make_fused_step (pallas_call at :585).  Per site x: pull each f_q from
// the neighbour at x - c_q (reference streaming_AB.h:21-52; wrapped on
// periodic axes, clamped to the edge site otherwise - the edge-replicated
// halo of _pad_once and _zshift), apply the pull rules of the outflow codes
// (OUTFLOW_RIGHT: every direction from x-1; OUTFLOW_RIGHT_INTERP: the
// c_x = -1 components blend x-1 and x by the speed of sound), the WALL
// swap and the symmetry mirrors, take the moments, apply the post-moment
// BCs (lbm_site.cuh ab_boundary), collide where the code collides and pass
// the DFs through elsewhere.  NOTHING sites keep their stored DFs; WALL
// and NOTHING sites report rho = 1, u = 0.  The result goes out of place
// into a second buffer (the A-B double buffer).
//
// Collision and equilibrium kind are template parameters: <WELL, EQ> is
// <true, EQ_WELL> for CUM_WELL, <false, EQ_QUAD> and <false, EQ_INVCUM>
// for CUM with eq_quadratic and eq_inv_cum.
//
// Bound: HBM bytes.  Per site and step 27 f32 are read and 27 written
// (216 B), plus the 1-byte map and the 16 B of rho and u: 233 B/site.
// threadIdx.x runs along z, the fastest axis of [27, X, Y, Z], so each
// component's neighbour reads (shifted by c_z) and its writes are
// contiguous runs of a warp; the shifted rows are re-read by the
// neighbouring blocks through L2.  The cascade runs in registers; no shared
// memory.  A block is one (x, y) row: rows away from the x and y faces take
// a short path with plain offsets, and only z needs the wrap/clamp rule.
// The TPU kernel's (tx, ty+8) DMA windows, lane padding and VMEM fitting
// have no counterpart here.  Offsets are 64-bit.

#include <cuda_runtime.h>

#include "lbm_site.cuh"

using namespace lbm;

// speed of sound of the interpolated outflow (streaming.py SPEED_OF_SOUND)
// and 1 - it, each rounded once to float
constexpr float CS = 0.5773502691896257f;
constexpr float ONE_MINUS_CS = 0.4226497308103743f;
// threads per block, along z
constexpr int THREADS = 128;

namespace {

template <bool WELL, int EQ>
__device__ __forceinline__ void ab_step_body(const float* __restrict__ f,
                                             float* __restrict__ fout,
                                             const uint8_t* __restrict__ map,
                                             float* __restrict__ rho_out,
                                             float* __restrict__ u_out, int Y, int Z,
                                             int periodic_bits, const ABParams& p) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  if (z >= Z) return;
  const int X = gridDim.z;
  const int x = blockIdx.z, y = blockIdx.y;
  const int64_t N = (int64_t)X * Y * Z;
  const int64_t site = ((int64_t)x * Y + y) * Z + z;
  const bool px = periodic_bits & 1, py = periodic_bits & 2, pz = periodic_bits & 4;
  const int64_t sx = (int64_t)Y * Z, sy = Z;

  const uint8_t m = map[site];
  float v[Q];
  if (m == GEO_NOTHING) {
    // inert ghost site: its stored DFs, rho = 1, u = 0
#pragma unroll
    for (int q = 0; q < Q; ++q) fout[q * N + site] = f[q * N + site];
    rho_out[site] = 1.0f;
    u_out[site] = 0.0f;
    u_out[N + site] = 0.0f;
    u_out[2 * N + site] = 0.0f;
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
      const float from_xm = f[q * N + xm * sx + yz];
      if (m == GEO_OUTFLOW_RIGHT)
        v[q] = from_xm;
      else if (cx(q) == -1)
        v[q] = CS * from_xm + ONE_MINUS_CS * f[q * N + (int64_t)x * sx + yz];
    }
  }
  pull_transform_ab(v, m);

  float rho, ux, uy, uz;
  moments_local<WELL>(v, p.fx, p.fy, p.fz, p.neumaier != 0, rho, ux, uy, uz);
  ab_boundary<WELL, EQ>(v, m, p, rho, ux, uy, uz);
  if (collides(m)) collide_cum<WELL>(v, rho == 0.0f ? 1.0f : rho, ux, uy, uz, p.omega1);

#pragma unroll
  for (int q = 0; q < Q; ++q) fout[q * N + site] = v[q];
  if (m == GEO_WALL) {
    rho = 1.0f;
    ux = uy = uz = 0.0f;
  }
  rho_out[site] = rho;
  u_out[site] = ux;
  u_out[N + site] = uy;
  u_out[2 * N + site] = uz;
}

}  // namespace

// One kernel per (collision, equilibrium kind); named so that the
// -Xptxas -v report can be read per instance.
#define AB_STEP_KERNEL(NAME, WELL, EQ)                                                       \
  extern "C" __global__ void __launch_bounds__(THREADS)                                     \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                            \
           const uint8_t* __restrict__ map, float* __restrict__ rho, float* __restrict__ u,  \
           int Y, int Z, int periodic_bits, ABParams p) {                                    \
    ab_step_body<WELL, EQ>(f, fout, map, rho, u, Y, Z, periodic_bits, p);                    \
  }

AB_STEP_KERNEL(ab_step_cum_well_kernel, true, EQ_WELL)
AB_STEP_KERNEL(ab_step_cum_quad_kernel, false, EQ_QUAD)
AB_STEP_KERNEL(ab_step_cum_invcum_kernel, false, EQ_INVCUM)

namespace {

using StepKernel = void (*)(const float*, float*, const uint8_t*, float*, float*, int, int, int,
                            ABParams);

int launch(StepKernel kernel, const float* f, float* fout, const uint8_t* map, float* rho,
           float* u, int X, int Y, int Z, int periodic_bits, const ABParams& p,
           cudaStream_t stream) {
  const int block = Z >= THREADS ? THREADS : ((Z + 31) / 32) * 32;
  const dim3 grid((Z + block - 1) / block, Y, X);
  kernel<<<grid, block, 0, stream>>>(f, fout, map, rho, u, Y, Z, periodic_bits, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown variant.  pbits (periodic axes): bit 0 x,
// bit 1 y, bit 2 z.  variant: 0 CUM_WELL (well-conditioned equilibrium),
// 1 CUM with the quadratic equilibrium, 2 CUM with the inverse-cumulant one.
extern "C" int tnl_lbm_ab_step(const float* f, float* fout, const uint8_t* map, float* rho,
                               float* u, int X, int Y, int Z, int pbits, int variant,
                               float nu, float fx, float fy, float fz, float uin_x,
                               float uin_y, float uin_z, int neumaier, void* stream) {
  const ABParams p{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch(ab_step_cum_well_kernel, f, fout, map, rho, u, X, Y, Z, pbits, p, s);
    case 1: return launch(ab_step_cum_quad_kernel, f, fout, map, rho, u, X, Y, Z, pbits, p, s);
    case 2: return launch(ab_step_cum_invcum_kernel, f, fout, map, rho, u, X, Y, Z, pbits, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
