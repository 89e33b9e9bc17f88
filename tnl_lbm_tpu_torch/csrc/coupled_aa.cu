// The A-A coupled NSE+ADE pair in float32: an even and an odd kernel, one
// thread per site.
//
// Replaces the Pallas kernels of tnl_lbm_tpu/kernels/fused_coupled.py
// make_fused_coupled_step_aa (even_kernel, pallas_call at :336; odd_kernel,
// pallas_call at :489): both lattices advance in one launch per parity with
// the velocity handed over in registers, as the A-B coupled kernel
// (coupled_ab.cu) does, on the A-A memory pattern.
//
// - Even (in place on f and g): the D3Q27 even site update of the A-A even
//   step (lbm_site.cuh aa_even_site: same-site reads, opposite-slot
//   writes), then the D3Q7 even update (ade_site.cuh ade_aa_even_site)
//   driven by the velocity still in registers.  Halo-free.
// - Odd (out of place, f -> fout and g -> gout): the D3Q27 odd site update
//   of the A-A odd step (aa_odd_site: pull of the opposite components from
//   s - c_q, the one-writer edge-replicated push), then the D3Q7 odd update
//   (ade_aa_odd_site: pull of g[aopp q] from s - c_q, the same push rule
//   per D3Q7 direction) with the site's own nu.  The TPU kernel's nu ring
//   has no counterpart: a thread reads nu at its own source site.
//
// The NSE stores come first in the source, so the 27 NSE DFs are dead
// while the ADE half runs.  The two lattices have their own maps and
// periodic axes on one grid; a push aimed at a NOTHING site of its own
// lattice's map is dropped (two rules: the maps differ).  Conjugate
// transfer codes and OUTFLOW_PE are refused by the wrapper, as the JAX
// kernel refuses them; so is OUTFLOW_RIGHT_INTERP on the NSE map.
//
// Instances: the three NSE variants of the A-B step (CUM_WELL; CUM with
// eq_quadratic; CUM with eq_inv_cum) times the four ADE collisions, per
// parity.
//
// Bound: HBM bytes.  Per site and parity: the A-A step's 233 B plus the
// ADE half's 7 f32 in and out, its map and phi (61 B): 294 B/site (298
// with a nu field), as the A-B coupled kernel.  No shared memory.

#include <cuda_runtime.h>

#include "ade_site.cuh"
#include "lbm_site.cuh"

using namespace lbm;

// threads per block, along z
constexpr int COUPLED_THREADS = 128;

template <bool WELL, int EQ, int COLL>
__device__ __forceinline__ void coupled_even_body(float* __restrict__ f,
                                                  const uint8_t* __restrict__ map,
                                                  float* __restrict__ rho, float* __restrict__ u,
                                                  float* __restrict__ g,
                                                  const uint8_t* __restrict__ amap,
                                                  const float* __restrict__ nu_field,
                                                  float* __restrict__ phi, int Y, int Z,
                                                  const ABParams& p, const ADEParams& ap) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  if (z >= Z) return;
  const int64_t N = (int64_t)gridDim.z * Y * Z;
  const int64_t site = ((int64_t)blockIdx.z * Y + blockIdx.y) * Z + z;
  float ux, uy, uz;
  aa_even_site<WELL, EQ>(f, map, rho, u, site, N, p, ux, uy, uz);
  ade_aa_even_site<COLL>(g, amap, nu_field, phi, site, N, ap, ux, uy, uz);
}

template <bool WELL, int EQ, int COLL>
__device__ __forceinline__ void coupled_odd_body(
    const float* __restrict__ f, float* __restrict__ fout, const uint8_t* __restrict__ map,
    float* __restrict__ rho, float* __restrict__ u, const float* __restrict__ g,
    float* __restrict__ gout, const uint8_t* __restrict__ amap,
    const float* __restrict__ nu_field, float* __restrict__ phi, int Y, int Z, int pbits,
    int apbits, int has_nothing, int has_ade_nothing, const ABParams& p, const ADEParams& ap) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  if (z >= Z) return;
  const int x = blockIdx.z, y = blockIdx.y, X = gridDim.z;
  float ux, uy, uz;
  aa_odd_site<WELL, EQ, false>(f, fout, map, rho, u, x, y, z, X, Y, Z, pbits, has_nothing != 0,
                               p, ux, uy, uz);
  ade_aa_odd_site<COLL>(g, gout, amap, nu_field, phi, x, y, z, X, Y, Z, apbits,
                        has_ade_nothing != 0, ap, ux, uy, uz);
}

#define COUPLED_AA_KERNELS(NAME, WELL, EQ, COLL)                                              \
  extern "C" __global__ void __launch_bounds__(COUPLED_THREADS)                              \
      coupled_aa_even_##NAME##_kernel(                                                        \
          float* __restrict__ f, const uint8_t* __restrict__ map, float* __restrict__ rho,   \
          float* __restrict__ u, float* __restrict__ g, const uint8_t* __restrict__ amap,    \
          const float* __restrict__ nu_field, float* __restrict__ phi, int Y, int Z,         \
          ABParams p, ADEParams ap) {                                                         \
    coupled_even_body<WELL, EQ, COLL>(f, map, rho, u, g, amap, nu_field, phi, Y, Z, p, ap);  \
  }                                                                                           \
  extern "C" __global__ void __launch_bounds__(COUPLED_THREADS)                              \
      coupled_aa_odd_##NAME##_kernel(                                                         \
          const float* __restrict__ f, float* __restrict__ fout,                              \
          const uint8_t* __restrict__ map, float* __restrict__ rho, float* __restrict__ u,   \
          const float* __restrict__ g, float* __restrict__ gout,                              \
          const uint8_t* __restrict__ amap, const float* __restrict__ nu_field,              \
          float* __restrict__ phi, int Y, int Z, int pbits, int apbits, int has_nothing,     \
          int has_ade_nothing, ABParams p, ADEParams ap) {                                    \
    coupled_odd_body<WELL, EQ, COLL>(f, fout, map, rho, u, g, gout, amap, nu_field, phi, Y,  \
                                     Z, pbits, apbits, has_nothing, has_ade_nothing, p, ap);  \
  }

COUPLED_AA_KERNELS(cum_well_srt, true, EQ_WELL, ADE_SRT)
COUPLED_AA_KERNELS(cum_well_mrt, true, EQ_WELL, ADE_MRT)
COUPLED_AA_KERNELS(cum_well_clbm, true, EQ_WELL, ADE_CLBM)
COUPLED_AA_KERNELS(cum_well_clbm_rs, true, EQ_WELL, ADE_CLBM_RS)
COUPLED_AA_KERNELS(cum_quad_srt, false, EQ_QUAD, ADE_SRT)
COUPLED_AA_KERNELS(cum_quad_mrt, false, EQ_QUAD, ADE_MRT)
COUPLED_AA_KERNELS(cum_quad_clbm, false, EQ_QUAD, ADE_CLBM)
COUPLED_AA_KERNELS(cum_quad_clbm_rs, false, EQ_QUAD, ADE_CLBM_RS)
COUPLED_AA_KERNELS(cum_invcum_srt, false, EQ_INVCUM, ADE_SRT)
COUPLED_AA_KERNELS(cum_invcum_mrt, false, EQ_INVCUM, ADE_MRT)
COUPLED_AA_KERNELS(cum_invcum_clbm, false, EQ_INVCUM, ADE_CLBM)
COUPLED_AA_KERNELS(cum_invcum_clbm_rs, false, EQ_INVCUM, ADE_CLBM_RS)

namespace {

using EvenKernel = void (*)(float*, const uint8_t*, float*, float*, float*, const uint8_t*,
                            const float*, float*, int, int, ABParams, ADEParams);
using OddKernel = void (*)(const float*, float*, const uint8_t*, float*, float*, const float*,
                           float*, const uint8_t*, const float*, float*, int, int, int, int, int,
                           int, ABParams, ADEParams);

#define KERNEL_ROW(KIND, NSE)                                                                 \
  {coupled_aa_##KIND##_##NSE##_srt_kernel, coupled_aa_##KIND##_##NSE##_mrt_kernel,            \
   coupled_aa_##KIND##_##NSE##_clbm_kernel, coupled_aa_##KIND##_##NSE##_clbm_rs_kernel}

const EvenKernel kEven[3][4] = {KERNEL_ROW(even, cum_well), KERNEL_ROW(even, cum_quad),
                                KERNEL_ROW(even, cum_invcum)};
const OddKernel kOdd[3][4] = {KERNEL_ROW(odd, cum_well), KERNEL_ROW(odd, cum_quad),
                              KERNEL_ROW(odd, cum_invcum)};

#undef KERNEL_ROW

}  // namespace

// Launches one parity on `stream`; returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for an unknown variant.  parity 0 (even)
// updates f and g in place and ignores fout and gout; parity 1 (odd) reads
// f and g and writes fout and gout, second buffers.  pbits / apbits: the
// periodic axes of the NSE / ADE lattice (bit 0 x, bit 1 y, bit 2 z);
// has_nothing / has_ade_nothing: the NSE / ADE map holds NOTHING sites.
// nse_variant: 0 CUM_WELL, 1 CUM + eq_quadratic, 2 CUM + eq_inv_cum (as
// tnl_lbm_ab_step); ade_variant: 0 SRT, 1 MRT, 2 CLBM, 3 CLBM-RS (as
// tnl_lbm_ade_step).  nu_field may be null (then omega_ade applies).
extern "C" int tnl_lbm_coupled_aa(float* f, float* fout, const uint8_t* map, float* rho,
                                  float* u, float* g, float* gout, const uint8_t* amap,
                                  const float* nu_field, float* phi, int X, int Y, int Z,
                                  int parity, int pbits, int apbits, int has_nothing,
                                  int has_ade_nothing, int nse_variant, int ade_variant,
                                  float nu, float fx, float fy, float fz, float uin_x,
                                  float uin_y, float uin_z, int neumaier, float omega_ade,
                                  float phi_in, void* stream) {
  if (nse_variant < 0 || nse_variant > 2 || ade_variant < 0 || ade_variant > 3 ||
      (parity != 0 && parity != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const ABParams p{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier};
  const ADEParams ap{omega_ade, phi_in, 0.0f};
  const int block = Z >= COUPLED_THREADS ? COUPLED_THREADS : ((Z + 31) / 32) * 32;
  const dim3 grid((Z + block - 1) / block, Y, X);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parity == 0)
    kEven[nse_variant][ade_variant]<<<grid, block, 0, s>>>(f, map, rho, u, g, amap, nu_field,
                                                           phi, Y, Z, p, ap);
  else
    kOdd[nse_variant][ade_variant]<<<grid, block, 0, s>>>(f, fout, map, rho, u, g, gout, amap,
                                                          nu_field, phi, Y, Z, pbits, apbits,
                                                          has_nothing, has_ade_nothing, p, ap);
  return static_cast<int>(cudaGetLastError());
}
