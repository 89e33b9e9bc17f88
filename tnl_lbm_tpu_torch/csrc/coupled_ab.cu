// One-kernel coupled NSE+ADE A-B step in float32, one thread per site.
//
// Replaces the Pallas kernel of tnl_lbm_tpu/kernels/fused_coupled.py
// make_fused_coupled_step (pallas_call at :179), the reference's coupled
// kernel (kernels.h:102-176).  Per site: the D3Q27 A-B update of the A-B
// step (lbm_site.cuh ab_site, as ab_step.cu runs it) writes f, rho and u;
// then the D3Q7 update (ade_site.cuh ade_site, as ade_step.cu runs it) is
// advected by the velocity still in registers.  The NSE stores come first
// in the source, so the 27 NSE DFs are dead while the ADE half runs.  The
// two lattices have their own maps and periodic axes on one grid.
//
// Instances: the three NSE variants of the A-B step (CUM_WELL; CUM with
// eq_quadratic; CUM with eq_inv_cum) times the four ADE collisions.
//
// Bound: HBM bytes.  Per site and step: the A-B step's 233 B plus the ADE
// half's 7 f32 in and out, its map and phi (61 B): 294 B/site (298 with a
// nu field), against 306 B for the A-B step followed by the ADE step,
// which reads u back.  Registers: the ADE half adds little to the cascade's
// live range, since it starts after the NSE stores.  No shared memory.

#include <cuda_runtime.h>

#include "ade_site.cuh"
#include "lbm_site.cuh"

using namespace lbm;

// threads per block, along z
constexpr int COUPLED_THREADS = 128;

template <bool WELL, int EQ, int COLL>
__device__ __forceinline__ void coupled_body(const float* __restrict__ f, float* __restrict__ fout,
                                             const uint8_t* __restrict__ map,
                                             float* __restrict__ rho, float* __restrict__ u,
                                             const float* __restrict__ g,
                                             float* __restrict__ gout,
                                             const uint8_t* __restrict__ amap,
                                             const float* __restrict__ nu_field,
                                             const uint8_t* __restrict__ tflags,
                                             float* __restrict__ phi, int Y, int Z, int pbits,
                                             int apbits, const ABParams& p,
                                             const ADEParams& ap) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  if (z >= Z) return;
  const int x = blockIdx.z, y = blockIdx.y, X = gridDim.z;
  float ux, uy, uz;
  ab_site<WELL, EQ>(f, fout, map, rho, u, x, y, z, X, Y, Z, pbits, p, ux, uy, uz);
  ade_site<COLL>(g, gout, amap, nu_field, tflags, phi, x, y, z, X, Y, Z, apbits, ap, ux, uy, uz);
}

#define COUPLED_KERNEL(NAME, WELL, EQ, COLL)                                                    \
  extern "C" __global__ void __launch_bounds__(COUPLED_THREADS)                                \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                               \
           const uint8_t* __restrict__ map, float* __restrict__ rho, float* __restrict__ u,     \
           const float* __restrict__ g, float* __restrict__ gout,                               \
           const uint8_t* __restrict__ amap, const float* __restrict__ nu_field,                \
           const uint8_t* __restrict__ tflags, float* __restrict__ phi, int Y, int Z,           \
           int pbits, int apbits, ABParams p, ADEParams ap) {                                   \
    coupled_body<WELL, EQ, COLL>(f, fout, map, rho, u, g, gout, amap, nu_field, tflags, phi, Y, \
                                 Z, pbits, apbits, p, ap);                                      \
  }

COUPLED_KERNEL(coupled_cum_well_srt_kernel, true, EQ_WELL, ADE_SRT)
COUPLED_KERNEL(coupled_cum_well_mrt_kernel, true, EQ_WELL, ADE_MRT)
COUPLED_KERNEL(coupled_cum_well_clbm_kernel, true, EQ_WELL, ADE_CLBM)
COUPLED_KERNEL(coupled_cum_well_clbm_rs_kernel, true, EQ_WELL, ADE_CLBM_RS)
COUPLED_KERNEL(coupled_cum_quad_srt_kernel, false, EQ_QUAD, ADE_SRT)
COUPLED_KERNEL(coupled_cum_quad_mrt_kernel, false, EQ_QUAD, ADE_MRT)
COUPLED_KERNEL(coupled_cum_quad_clbm_kernel, false, EQ_QUAD, ADE_CLBM)
COUPLED_KERNEL(coupled_cum_quad_clbm_rs_kernel, false, EQ_QUAD, ADE_CLBM_RS)
COUPLED_KERNEL(coupled_cum_invcum_srt_kernel, false, EQ_INVCUM, ADE_SRT)
COUPLED_KERNEL(coupled_cum_invcum_mrt_kernel, false, EQ_INVCUM, ADE_MRT)
COUPLED_KERNEL(coupled_cum_invcum_clbm_kernel, false, EQ_INVCUM, ADE_CLBM)
COUPLED_KERNEL(coupled_cum_invcum_clbm_rs_kernel, false, EQ_INVCUM, ADE_CLBM_RS)

namespace {

using CoupledKernel = void (*)(const float*, float*, const uint8_t*, float*, float*, const float*,
                               float*, const uint8_t*, const float*, const uint8_t*, float*, int,
                               int, int, int, ABParams, ADEParams);

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown variant.  pbits / apbits: the
// periodic axes of the NSE / ADE lattice (bit 0 x, bit 1 y, bit 2 z).
// nse_variant: 0 CUM_WELL, 1 CUM + eq_quadratic, 2 CUM + eq_inv_cum (as
// tnl_lbm_ab_step); ade_variant: 0 SRT, 1 MRT, 2 CLBM, 3 CLBM-RS (as
// tnl_lbm_ade_step).  nu_field and tflags may be null.
extern "C" int tnl_lbm_coupled_ab(const float* f, float* fout, const uint8_t* map, float* rho,
                                  float* u, const float* g, float* gout, const uint8_t* amap,
                                  const float* nu_field, const uint8_t* tflags, float* phi,
                                  int X, int Y, int Z, int pbits, int apbits, int nse_variant,
                                  int ade_variant, float nu, float fx, float fy, float fz,
                                  float uin_x, float uin_y, float uin_z, int neumaier,
                                  float omega_ade, float phi_in, float tcoef, void* stream) {
  static const CoupledKernel kernels[3][4] = {
      {coupled_cum_well_srt_kernel, coupled_cum_well_mrt_kernel, coupled_cum_well_clbm_kernel,
       coupled_cum_well_clbm_rs_kernel},
      {coupled_cum_quad_srt_kernel, coupled_cum_quad_mrt_kernel, coupled_cum_quad_clbm_kernel,
       coupled_cum_quad_clbm_rs_kernel},
      {coupled_cum_invcum_srt_kernel, coupled_cum_invcum_mrt_kernel,
       coupled_cum_invcum_clbm_kernel, coupled_cum_invcum_clbm_rs_kernel}};
  if (nse_variant < 0 || nse_variant > 2 || ade_variant < 0 || ade_variant > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const ABParams p{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier};
  const ADEParams ap{omega_ade, phi_in, tcoef};
  const int block = Z >= COUPLED_THREADS ? COUPLED_THREADS : ((Z + 31) / 32) * 32;
  const dim3 grid((Z + block - 1) / block, Y, X);
  kernels[nse_variant][ade_variant]<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      f, fout, map, rho, u, g, gout, amap, nu_field, tflags, phi, Y, Z, pbits, apbits, p, ap);
  return static_cast<int>(cudaGetLastError());
}
