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
// for CUM with eq_quadratic and eq_inv_cum.  The step's instances of the
// other D3Q27 collisions are in coll_step.cuh (coll_srt.cu, coll_clbm.cu,
// coll_kbc.cu).  Two variants of make_fused_step
// (its force_field and macro_only flags, JAX fused.py:486-510, 636-650) are
// instances of their own: force_field reads a per-site [3, X, Y, Z] force
// (added to the homogeneous one, lbm_site.cuh site_params) in place of the
// homogeneous force alone; macro_only is the u* pre-pass of the hooked
// pipeline (kernels/hooked.py; reference kernels.h:178-218): the pull, the
// WALL and symmetry transforms and the moments with the homogeneous force,
// rho and u written, no collision and no f output.
//
// Bound: HBM bytes.  Per site and step 27 f32 are read and 27 written
// (216 B), plus the 1-byte map and the 16 B of rho and u: 233 B/site;
// force_field adds the 12 B of the force (245 B/site), macro_only moves
// 27 f32 in, the map and rho and u out (125 B/site).
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

// One kernel per (collision, equilibrium kind, per-site force); named so
// that the -Xptxas -v report can be read per instance.
#define AB_STEP_KERNEL(NAME, WELL, EQ, FF)                                                   \
  extern "C" __global__ void __launch_bounds__(THREADS)                                     \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                            \
           const uint8_t* __restrict__ map, const float* __restrict__ ff,                    \
           float* __restrict__ rho, float* __restrict__ u, int Y, int Z, int periodic_bits,  \
           ABParams p) {                                                                     \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                     \
    if (z >= Z) return;                                                                      \
    float ux, uy, uz;                                                                        \
    ab_site<WELL, EQ, FF>(f, fout, map, rho, u, blockIdx.z, blockIdx.y, z, gridDim.z, Y, Z,  \
                          periodic_bits, p, ux, uy, uz, ff);                                 \
  }

// The u* pre-pass: one instance per storage (well-conditioned or total DFs).
#define AB_MACRO_KERNEL(NAME, WELL)                                                          \
  extern "C" __global__ void __launch_bounds__(THREADS)                                     \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                            \
           const uint8_t* __restrict__ map, const float* __restrict__ ff,                    \
           float* __restrict__ rho, float* __restrict__ u, int Y, int Z, int periodic_bits,  \
           ABParams p) {                                                                     \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                     \
    if (z >= Z) return;                                                                      \
    const int x = blockIdx.z, y = blockIdx.y, X = gridDim.z;                                 \
    const int64_t N = (int64_t)X * Y * Z;                                                    \
    const int64_t site = ((int64_t)x * Y + y) * Z + z;                                       \
    const uint8_t m = map[site];                                                             \
    float v[Q];                                                                              \
    ab_pull(f, m, x, y, z, X, Y, Z, periodic_bits, v);                                       \
    macro_site<WELL>(v, m, p, rho, u, site, N);                                              \
  }

AB_STEP_KERNEL(ab_step_cum_well_kernel, true, EQ_WELL, false)
AB_STEP_KERNEL(ab_step_cum_quad_kernel, false, EQ_QUAD, false)
AB_STEP_KERNEL(ab_step_cum_invcum_kernel, false, EQ_INVCUM, false)
AB_STEP_KERNEL(ab_step_force_field_cum_well_kernel, true, EQ_WELL, true)
AB_STEP_KERNEL(ab_step_force_field_cum_quad_kernel, false, EQ_QUAD, true)
AB_STEP_KERNEL(ab_step_force_field_cum_invcum_kernel, false, EQ_INVCUM, true)
AB_MACRO_KERNEL(ab_macro_well_kernel, true)
AB_MACRO_KERNEL(ab_macro_total_kernel, false)

// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown variant or mode.  pbits (periodic
// axes): bit 0 x, bit 1 y, bit 2 z.  variant: 0 CUM_WELL (well-conditioned
// equilibrium), 1 CUM with the quadratic equilibrium, 2 CUM with the
// inverse-cumulant one.  mode: 0 the step, 1 force_field (ff: the per-site
// force [3, X, Y, Z]), 2 macro_only (fout unused, may be null).
extern "C" int tnl_lbm_ab_step(const float* f, float* fout, const uint8_t* map, const float* ff,
                               float* rho, float* u, int X, int Y, int Z, int pbits, int variant,
                               int mode, float nu, float fx, float fy, float fz, float uin_x,
                               float uin_y, float uin_z, int neumaier, void* stream) {
  using StepKernel = void (*)(const float*, float*, const uint8_t*, const float*, float*, float*,
                              int, int, int, ABParams);
  static const StepKernel kernels[3][3] = {
      {ab_step_cum_well_kernel, ab_step_cum_quad_kernel, ab_step_cum_invcum_kernel},
      {ab_step_force_field_cum_well_kernel, ab_step_force_field_cum_quad_kernel,
       ab_step_force_field_cum_invcum_kernel},
      {ab_macro_well_kernel, ab_macro_total_kernel, ab_macro_total_kernel}};
  if (variant < 0 || variant > 2 || mode < 0 || mode > 2 || (mode == 1 && ff == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ABParams p{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier};
  const int block = Z >= THREADS ? THREADS : ((Z + 31) / 32) * 32;
  const dim3 grid((Z + block - 1) / block, Y, X);
  kernels[mode][variant]<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      f, fout, map, ff, rho, u, Y, Z, pbits, p);
  return static_cast<int>(cudaGetLastError());
}
