// A-A odd step for D3Q27 in float32 with the 3D boundary set, one thread
// per source site.
//
// Replaces the Pallas kernel of tnl_lbm_tpu/kernels/fused_aa.py
// _build_odd_call (odd_kernel, pallas_call at :287).  Per site s
// (lbm_site.cuh aa_odd_site): pull the opposite components from the
// neighbours, f_in[q](s) = f[opp q](s - c_q) (reference
// streaming_AA.h:47-76; OUTFLOW_RIGHT pulls from x-1), apply the WALL swap
// and the symmetry mirrors, take the moments, apply the post-moment BCs,
// collide where the code collides, and push f_post[q](s) to the
// neighbours with the one-writer edge-replicated scatter that equals the
// JAX step's pull(pad_halo(f_post)) (sim/step.py:224).  NOTHING sites keep
// their stored DFs: their thread copies its own 27 values and pushes aimed
// at a NOTHING destination are dropped.  The kernel writes out of place
// into a second buffer; an in-place odd step would race at the
// edge-replicated layers.
//
// Instances (the other D3Q27 collisions' are in coll_step.cuh): the three
// of the A-B step (CUM_WELL; CUM with eq_quadratic;
// CUM with eq_inv_cum), and CUM_WELL on a map of FLUID, WALL and NOTHING
// only without the boundary switch (the bench duct's instance), which
// measured 3% faster there than the full CUM_WELL one.  The variants of
// make_fused_step_aa (JAX fused_aa.py:129-250) have instances of their own,
// none lean: force_field collides each site with the homogeneous force
// plus its own from a per-site [3, X, Y, Z] force and pushes as the step
// does (lbm_site.cuh aa_odd_site: the edge-replicated layers take the edge
// site's own post-collision DFs, which is the JAX kernel's edge-replicated
// force ring); macro_only is the u* pre-pass of the hooked pipeline, the
// odd read, the WALL and symmetry transforms and the moments with the
// homogeneous force, written to rho and u, no push.
//
// Bound: HBM bytes.  Per site and step 27 f32 are read and 27 written
// (216 B), plus the map and the 16 B of rho and u (force_field: + 12 B;
// macro_only: 27 f32 read, 125 B/site).  threadIdx.x runs along
// z, the fastest axis, so for each component the neighbour reads and the
// pushed writes of a warp are contiguous runs shifted by c_z.  The cascade
// runs in registers; no shared memory.  Offsets are 64-bit.

#include <cuda_runtime.h>

#include "lbm_site.cuh"

using namespace lbm;

// threads per block, along z
constexpr int THREADS = 128;

#define AA_ODD_KERNEL(NAME, WELL, EQ, LEAN, FF)                                               \
  extern "C" __global__ void __launch_bounds__(THREADS)                                      \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                             \
           const uint8_t* __restrict__ map, const float* __restrict__ ff,                     \
           float* __restrict__ rho, float* __restrict__ u, int Y, int Z, int periodic_bits,   \
           int has_nothing, ABParams p) {                                                     \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                      \
    if (z >= Z) return;                                                                       \
    float ux, uy, uz;                                                                         \
    aa_odd_site<WELL, EQ, LEAN, FF>(f, fout, map, rho, u, blockIdx.z, blockIdx.y, z,          \
                                    gridDim.z, Y, Z, periodic_bits, has_nothing != 0, p, ux,  \
                                    uy, uz, ff);                                              \
  }

// The u* pre-pass of the odd parity.
#define AA_ODD_MACRO_KERNEL(NAME, WELL)                                                       \
  extern "C" __global__ void __launch_bounds__(THREADS)                                      \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                             \
           const uint8_t* __restrict__ map, const float* __restrict__ ff,                     \
           float* __restrict__ rho, float* __restrict__ u, int Y, int Z, int periodic_bits,   \
           int has_nothing, ABParams p) {                                                     \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                      \
    if (z >= Z) return;                                                                       \
    const int x = blockIdx.z, y = blockIdx.y, X = gridDim.z;                                  \
    const int64_t N = (int64_t)X * Y * Z;                                                     \
    const int64_t site = ((int64_t)x * Y + y) * Z + z;                                        \
    const uint8_t m = map[site];                                                              \
    float v[Q];                                                                               \
    aa_odd_pull<false>(f, m, x, y, z, X, Y, Z, periodic_bits, v);                             \
    macro_site<WELL>(v, m, p, rho, u, site, N);                                               \
  }

AA_ODD_KERNEL(aa_odd_kernel, true, EQ_WELL, true, false)
AA_ODD_KERNEL(aa_odd_cum_well_kernel, true, EQ_WELL, false, false)
AA_ODD_KERNEL(aa_odd_cum_quad_kernel, false, EQ_QUAD, false, false)
AA_ODD_KERNEL(aa_odd_cum_invcum_kernel, false, EQ_INVCUM, false, false)
AA_ODD_KERNEL(aa_odd_force_field_cum_well_kernel, true, EQ_WELL, false, true)
AA_ODD_KERNEL(aa_odd_force_field_cum_quad_kernel, false, EQ_QUAD, false, true)
AA_ODD_KERNEL(aa_odd_force_field_cum_invcum_kernel, false, EQ_INVCUM, false, true)
AA_ODD_MACRO_KERNEL(aa_odd_macro_well_kernel, true)
AA_ODD_MACRO_KERNEL(aa_odd_macro_total_kernel, false)

// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown variant or mode.  periodic_bits: bit 0
// x, bit 1 y, bit 2 z; variant and mode as tnl_lbm_aa_even (variant 3 runs
// the lean instance only in mode 0); fout is unused in mode 2.
extern "C" int tnl_lbm_aa_odd(const float* f, float* fout, const uint8_t* map, const float* ff,
                              float* rho, float* u, int X, int Y, int Z, int periodic_bits,
                              int has_nothing, int variant, int mode, float nu, float fx,
                              float fy, float fz, float uin_x, float uin_y, float uin_z,
                              int neumaier, void* stream) {
  using Kernel = void (*)(const float*, float*, const uint8_t*, const float*, float*, float*,
                          int, int, int, int, ABParams);
  static const Kernel kernels[3][4] = {
      {aa_odd_cum_well_kernel, aa_odd_cum_quad_kernel, aa_odd_cum_invcum_kernel, aa_odd_kernel},
      {aa_odd_force_field_cum_well_kernel, aa_odd_force_field_cum_quad_kernel,
       aa_odd_force_field_cum_invcum_kernel, aa_odd_force_field_cum_well_kernel},
      {aa_odd_macro_well_kernel, aa_odd_macro_total_kernel, aa_odd_macro_total_kernel,
       aa_odd_macro_well_kernel}};
  if (variant < 0 || variant > 3 || mode < 0 || mode > 2 || (mode == 1 && ff == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ABParams p{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier};
  const int block = Z >= THREADS ? THREADS : ((Z + 31) / 32) * 32;
  const dim3 grid((Z + block - 1) / block, Y, X);
  kernels[mode][variant]<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      f, fout, map, ff, rho, u, Y, Z, periodic_bits, has_nothing, p);
  return static_cast<int>(cudaGetLastError());
}
