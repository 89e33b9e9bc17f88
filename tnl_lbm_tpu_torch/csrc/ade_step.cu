// A-B step of the D3Q7 advection-diffusion lattice in float32, one thread
// per site.
//
// Replaces the Pallas kernel of tnl_lbm_tpu/kernels/fused_ade.py
// make_fused_ade_step (pallas_call at :338).  Per site: read the advecting
// velocity u, pull each g_q from x - c_q (wrapped on periodic axes,
// clamped to the edge site otherwise - the edge-replicated 2-wide x and
// 1-wide y halo of _pad_ade and _zshift), apply the ADE boundary rules
// (OUTFLOW_RIGHT, OUTFLOW_PE, WALL, WALL_BODY, the symmetry planes, the
// conjugate TRANSFER_* links, INFLOW) and collide where the code collides
// (ade_site.cuh ade_site_update).  NOTHING sites keep their stored g and
// report phi = 0.  Out of place, into a second buffer.
//
// One instance per collision (SRT, MRT, CLBM, CLBM-RS).  nu is a scalar
// (omega computed once on the host) or a per-site field, and the packed
// transfer flags are one byte per site (6 bits used), read only at the
// transfer sites; both are runtime choices: a null pointer means none.
//
// Bound: HBM bytes.  Per site and step 7 f32 are read and 7 written
// (56 B), plus the 1-byte map, the 12 B of u and the 4 B of phi: 73 B/site
// (77 with a nu field).  The arithmetic is a few dozen flops per site.
// threadIdx.x runs along z, so each component's reads and writes are
// contiguous runs of a warp; the neighbours' rows come through L2.  No
// shared memory.  Offsets are 64-bit.

#include <cuda_runtime.h>

#include "ade_site.cuh"

using namespace lbm;

// threads per block, along z
constexpr int ADE_THREADS = 128;

#define ADE_STEP_KERNEL(NAME, COLL)                                                             \
  extern "C" __global__ void __launch_bounds__(ADE_THREADS)                                    \
      NAME(const float* __restrict__ g, float* __restrict__ gout,                               \
           const uint8_t* __restrict__ map, const float* __restrict__ u,                        \
           const float* __restrict__ nu_field, const uint8_t* __restrict__ tflags,              \
           float* __restrict__ phi, int Y, int Z, int periodic_bits, ADEParams p) {             \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                        \
    if (z >= Z) return;                                                                         \
    const int x = blockIdx.z, y = blockIdx.y, X = gridDim.z;                                    \
    const int64_t N = (int64_t)X * Y * Z;                                                       \
    const int64_t site = ((int64_t)x * Y + y) * Z + z;                                          \
    ade_site<COLL>(g, gout, map, nu_field, tflags, phi, x, y, z, X, Y, Z, periodic_bits, p,     \
                   u[site], u[N + site], u[2 * N + site]);                                      \
  }

ADE_STEP_KERNEL(ade_step_srt_kernel, ADE_SRT)
ADE_STEP_KERNEL(ade_step_mrt_kernel, ADE_MRT)
ADE_STEP_KERNEL(ade_step_clbm_kernel, ADE_CLBM)
ADE_STEP_KERNEL(ade_step_clbm_rs_kernel, ADE_CLBM_RS)

namespace {

using AdeKernel = void (*)(const float*, float*, const uint8_t*, const float*, const float*,
                           const uint8_t*, float*, int, int, int, ADEParams);

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown variant.  pbits (periodic axes):
// bit 0 x, bit 1 y, bit 2 z.  variant: 0 SRT, 1 MRT, 2 CLBM, 3 CLBM-RS.
// nu_field and tflags may be null; omega is used where nu_field is null.
extern "C" int tnl_lbm_ade_step(const float* g, float* gout, const uint8_t* map, const float* u,
                                const float* nu_field, const uint8_t* tflags, float* phi, int X,
                                int Y, int Z, int pbits, int variant, float omega, float phi_in,
                                float tcoef, void* stream) {
  static const AdeKernel kernels[] = {ade_step_srt_kernel, ade_step_mrt_kernel,
                                      ade_step_clbm_kernel, ade_step_clbm_rs_kernel};
  if (variant < 0 || variant > 3) return static_cast<int>(cudaErrorInvalidValue);
  const ADEParams p{omega, phi_in, tcoef};
  const int block = Z >= ADE_THREADS ? ADE_THREADS : ((Z + 31) / 32) * 32;
  const dim3 grid((Z + block - 1) / block, Y, X);
  kernels[variant]<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      g, gout, map, u, nu_field, tflags, phi, Y, Z, pbits, p);
  return static_cast<int>(cudaGetLastError());
}

// The haloed step of the sharded lattice (JAX make_fused_ade_step with
// prepadded and local_shape, run per shard by parallel/sharded.py
// make_sharded_fused_ade_step): one thread per site of the X x Y x Z block,
// reading the haloed block [7, X+4, Y+2, Z] (ade_site.cuh ade_halo_site).
// The TPU layout's six extra y alignment rows have no counterpart.  Bound:
// the block's 73 B/site (77 with a nu field) plus the ring's reads.
#define ADE_HALO_KERNEL(NAME, COLL)                                                             \
  extern "C" __global__ void __launch_bounds__(ADE_THREADS)                                    \
      NAME(const float* __restrict__ g, float* __restrict__ gout,                               \
           const uint8_t* __restrict__ map, const float* __restrict__ u,                        \
           const float* __restrict__ nu_field, const uint8_t* __restrict__ tflags,              \
           float* __restrict__ phi, int Y, int Z, int periodic_z, ADEParams p) {                \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                        \
    if (z >= Z) return;                                                                         \
    const int x = blockIdx.z, y = blockIdx.y, X = gridDim.z;                                    \
    const int64_t N = (int64_t)X * Y * Z;                                                       \
    const int64_t site = ((int64_t)x * Y + y) * Z + z;                                          \
    ade_halo_site<COLL>(g, gout, map, nu_field, tflags, phi, x, y, z, X, Y, Z, periodic_z != 0, \
                        p, u[site], u[N + site], u[2 * N + site]);                              \
  }

ADE_HALO_KERNEL(ade_halo_srt_kernel, ADE_SRT)
ADE_HALO_KERNEL(ade_halo_mrt_kernel, ADE_MRT)
ADE_HALO_KERNEL(ade_halo_clbm_kernel, ADE_CLBM)
ADE_HALO_KERNEL(ade_halo_clbm_rs_kernel, ADE_CLBM_RS)

// Launches the haloed step on `stream`: g is the haloed block [7, X+4, Y+2,
// Z]; gout, map, u, nu_field, tflags and phi the block's own; periodic_z
// whether z wraps; the rest as tnl_lbm_ade_step's.
extern "C" int tnl_lbm_ade_step_halo(const float* g, float* gout, const uint8_t* map,
                                     const float* u, const float* nu_field, const uint8_t* tflags,
                                     float* phi, int X, int Y, int Z, int periodic_z, int variant,
                                     float omega, float phi_in, float tcoef, void* stream) {
  static const AdeKernel kernels[] = {ade_halo_srt_kernel, ade_halo_mrt_kernel,
                                      ade_halo_clbm_kernel, ade_halo_clbm_rs_kernel};
  if (variant < 0 || variant > 3 || X < 1 || Y < 1 || Z < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const ADEParams p{omega, phi_in, tcoef};
  const int block = Z >= ADE_THREADS ? ADE_THREADS : ((Z + 31) / 32) * 32;
  const dim3 grid((Z + block - 1) / block, Y, X);
  kernels[variant]<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      g, gout, map, u, nu_field, tflags, phi, Y, Z, periodic_z, p);
  return static_cast<int>(cudaGetLastError());
}
