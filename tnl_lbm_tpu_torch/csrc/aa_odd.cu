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
// Instances: the three of the A-B step (CUM_WELL; CUM with eq_quadratic;
// CUM with eq_inv_cum), and CUM_WELL on a map of FLUID, WALL and NOTHING
// only without the boundary switch (the bench duct's instance), which
// measured 3% faster there than the full CUM_WELL one.
//
// Bound: HBM bytes.  Per site and step 27 f32 are read and 27 written
// (216 B), plus the map and the 16 B of rho and u.  threadIdx.x runs along
// z, the fastest axis, so for each component the neighbour reads and the
// pushed writes of a warp are contiguous runs shifted by c_z.  The cascade
// runs in registers; no shared memory.  Offsets are 64-bit.

#include <cuda_runtime.h>

#include "lbm_site.cuh"

using namespace lbm;

// threads per block, along z
constexpr int THREADS = 128;

#define AA_ODD_KERNEL(NAME, WELL, EQ, LEAN)                                                   \
  extern "C" __global__ void __launch_bounds__(THREADS)                                      \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                             \
           const uint8_t* __restrict__ map, float* __restrict__ rho, float* __restrict__ u,   \
           int Y, int Z, int periodic_bits, int has_nothing, ABParams p) {                    \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                      \
    if (z >= Z) return;                                                                       \
    float ux, uy, uz;                                                                         \
    aa_odd_site<WELL, EQ, LEAN>(f, fout, map, rho, u, blockIdx.z, blockIdx.y, z, gridDim.z,   \
                                Y, Z, periodic_bits, has_nothing != 0, p, ux, uy, uz);        \
  }

AA_ODD_KERNEL(aa_odd_kernel, true, EQ_WELL, true)
AA_ODD_KERNEL(aa_odd_cum_well_kernel, true, EQ_WELL, false)
AA_ODD_KERNEL(aa_odd_cum_quad_kernel, false, EQ_QUAD, false)
AA_ODD_KERNEL(aa_odd_cum_invcum_kernel, false, EQ_INVCUM, false)

// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown variant.  periodic_bits: bit 0 x,
// bit 1 y, bit 2 z; variant as tnl_lbm_aa_even.
extern "C" int tnl_lbm_aa_odd(const float* f, float* fout, const uint8_t* map, float* rho,
                              float* u, int X, int Y, int Z, int periodic_bits, int has_nothing,
                              int variant, float nu, float fx, float fy, float fz, float uin_x,
                              float uin_y, float uin_z, int neumaier, void* stream) {
  using Kernel = void (*)(const float*, float*, const uint8_t*, float*, float*, int, int, int,
                          int, ABParams);
  static const Kernel kernels[4] = {aa_odd_cum_well_kernel, aa_odd_cum_quad_kernel,
                                    aa_odd_cum_invcum_kernel, aa_odd_kernel};
  if (variant < 0 || variant > 3) return static_cast<int>(cudaErrorInvalidValue);
  const ABParams p{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier};
  const int block = Z >= THREADS ? THREADS : ((Z + 31) / 32) * 32;
  const dim3 grid((Z + block - 1) / block, Y, X);
  kernels[variant]<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      f, fout, map, rho, u, Y, Z, periodic_bits, has_nothing, p);
  return static_cast<int>(cudaGetLastError());
}
