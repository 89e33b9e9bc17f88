// A-A even step for D3Q27 in float32 with the 3D boundary set, one thread
// per site.
//
// Replaces the Pallas kernel of tnl_lbm_tpu/kernels/fused_aa.py
// make_fused_step_aa (even_kernel, pallas_call at :408).  Per site
// (lbm_site.cuh aa_even_site): read the 27 DFs of the site itself (same
// site, same direction, reference streaming_AA.h:16-45), apply the WALL
// swap and the symmetry mirrors, take the moments, apply the post-moment
// BCs (INFLOW, INFLOW_LEFT, OUTFLOW_EQ, OUTFLOW_RIGHT; every pull rule of
// the even step reads the site itself), collide where the code collides,
// and write the result to the opposite slots of the same site; NOTHING
// sites keep their DFs.  Each thread reads and writes only its own site,
// so the update is in place on the one state buffer.
//
// Instances: the three of the A-B step (CUM_WELL; CUM with eq_quadratic;
// CUM with eq_inv_cum); the other D3Q27 collisions' are in coll_step.cuh.  A map of FLUID, WALL and NOTHING only runs the
// CUM_WELL one too: on the even step the boundary switch measured no cost
// (the odd step keeps a lean instance, aa_odd.cu).  The variants of
// make_fused_step_aa (JAX fused_aa.py:324-500) have instances of their own:
// force_field collides each site with the homogeneous force plus its own
// from a per-site [3, X, Y, Z] force; macro_only is the u* pre-pass of the
// hooked pipeline, the transformed moments with the homogeneous force,
// written to rho and u, with f left as it is.
//
// Bound: HBM bytes.  Per site and step 27 f32 are read and 27 written
// (216 B), plus the 1-byte map read and the 16 B of rho and u (force_field:
// + 12 B; macro_only: 27 f32 read, 125 B/site).  The design
// keeps every load and store coalesced: threadIdx.x runs along z, the
// fastest axis of the [27, X, Y, Z] layout, so each of the 27 component
// planes is read and written as contiguous runs of a warp.  The cumulant
// cascade runs entirely in registers; no shared memory is used.
// Offsets are 64-bit: 27 X Y Z exceeds 2^31 at 512^3.

#include <cuda_runtime.h>

#include "lbm_site.cuh"

using namespace lbm;

// threads per block, along z
constexpr int THREADS = 128;

// One kernel per instance, named so that the -Xptxas -v report can be read
// per instance.
#define AA_EVEN_KERNEL(NAME, WELL, EQ, FF)                                                    \
  extern "C" __global__ void __launch_bounds__(THREADS)                                      \
      NAME(float* __restrict__ f, const uint8_t* __restrict__ map,                            \
           const float* __restrict__ ff, float* __restrict__ rho, float* __restrict__ u,      \
           int Y, int Z, ABParams p) {                                                        \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                      \
    if (z >= Z) return;                                                                       \
    const int64_t N = (int64_t)gridDim.z * Y * Z;                                             \
    const int64_t site = ((int64_t)blockIdx.z * Y + blockIdx.y) * Z + z;                      \
    float ux, uy, uz;                                                                         \
    aa_even_site<WELL, EQ, FF>(f, map, rho, u, site, N, p, ux, uy, uz, ff);                   \
  }

// The u* pre-pass of the even parity: the site's own DFs.
template <bool WELL>
__device__ __forceinline__ void aa_even_macro(const float* __restrict__ f,
                                              const uint8_t* __restrict__ map,
                                              float* __restrict__ rho, float* __restrict__ u,
                                              int64_t site, int64_t N, const ABParams& p) {
  float v[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) v[q] = f[q * N + site];
  macro_site<WELL>(v, map[site], p, rho, u, site, N);
}

#define AA_EVEN_MACRO_KERNEL(NAME, WELL)                                                      \
  extern "C" __global__ void __launch_bounds__(THREADS)                                      \
      NAME(float* __restrict__ f, const uint8_t* __restrict__ map,                            \
           const float* __restrict__ ff, float* __restrict__ rho, float* __restrict__ u,      \
           int Y, int Z, ABParams p) {                                                        \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                      \
    if (z >= Z) return;                                                                       \
    const int64_t N = (int64_t)gridDim.z * Y * Z;                                             \
    const int64_t site = ((int64_t)blockIdx.z * Y + blockIdx.y) * Z + z;                      \
    aa_even_macro<WELL>(f, map, rho, u, site, N, p);                                         \
  }

AA_EVEN_KERNEL(aa_even_cum_well_kernel, true, EQ_WELL, false)
AA_EVEN_KERNEL(aa_even_cum_quad_kernel, false, EQ_QUAD, false)
AA_EVEN_KERNEL(aa_even_cum_invcum_kernel, false, EQ_INVCUM, false)
AA_EVEN_KERNEL(aa_even_force_field_cum_well_kernel, true, EQ_WELL, true)
AA_EVEN_KERNEL(aa_even_force_field_cum_quad_kernel, false, EQ_QUAD, true)
AA_EVEN_KERNEL(aa_even_force_field_cum_invcum_kernel, false, EQ_INVCUM, true)
AA_EVEN_MACRO_KERNEL(aa_even_macro_well_kernel, true)
AA_EVEN_MACRO_KERNEL(aa_even_macro_total_kernel, false)

// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown variant or mode.  variant: 0 CUM_WELL,
// 1 CUM with the quadratic equilibrium, 2 CUM with the inverse-cumulant one
// (as tnl_lbm_ab_step), 3 CUM_WELL on a FLUID/WALL/NOTHING map (the
// CUM_WELL instance).  mode: 0 the step, 1 force_field (ff: the per-site
// force), 2 macro_only (f only read).
extern "C" int tnl_lbm_aa_even(float* f, const uint8_t* map, const float* ff, float* rho,
                               float* u, int X, int Y, int Z, int variant, int mode, float nu,
                               float fx, float fy, float fz, float uin_x, float uin_y,
                               float uin_z, int neumaier, void* stream) {
  using Kernel = void (*)(float*, const uint8_t*, const float*, float*, float*, int, int,
                          ABParams);
  static const Kernel kernels[3][4] = {
      {aa_even_cum_well_kernel, aa_even_cum_quad_kernel, aa_even_cum_invcum_kernel,
       aa_even_cum_well_kernel},
      {aa_even_force_field_cum_well_kernel, aa_even_force_field_cum_quad_kernel,
       aa_even_force_field_cum_invcum_kernel, aa_even_force_field_cum_well_kernel},
      {aa_even_macro_well_kernel, aa_even_macro_total_kernel, aa_even_macro_total_kernel,
       aa_even_macro_well_kernel}};
  if (variant < 0 || variant > 3 || mode < 0 || mode > 2 || (mode == 1 && ff == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ABParams p{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier};
  const int block = Z >= THREADS ? THREADS : ((Z + 31) / 32) * 32;
  const dim3 grid((Z + block - 1) / block, Y, X);
  kernels[mode][variant]<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(f, map, ff, rho,
                                                                                u, Y, Z, p);
  return static_cast<int>(cudaGetLastError());
}
