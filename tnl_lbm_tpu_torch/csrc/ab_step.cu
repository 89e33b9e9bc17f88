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
// the DFs through elsewhere (lbm_site.cuh ab_site).  NOTHING sites keep
// their stored DFs; WALL and NOTHING sites report rho = 1, u = 0.  The
// result goes out of place into a second buffer (the A-B double buffer).
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

// threads per block, along z
constexpr int THREADS = 128;

// One kernel per (collision, equilibrium kind); named so that the
// -Xptxas -v report can be read per instance.
#define AB_STEP_KERNEL(NAME, WELL, EQ)                                                       \
  extern "C" __global__ void __launch_bounds__(THREADS)                                     \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                            \
           const uint8_t* __restrict__ map, float* __restrict__ rho, float* __restrict__ u,  \
           int Y, int Z, int periodic_bits, ABParams p) {                                    \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                     \
    if (z >= Z) return;                                                                      \
    float ux, uy, uz;                                                                        \
    ab_site<WELL, EQ>(f, fout, map, rho, u, blockIdx.z, blockIdx.y, z, gridDim.z, Y, Z,      \
                      periodic_bits, p, ux, uy, uz);                                         \
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
