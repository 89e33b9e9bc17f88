// Non-Newtonian body force F = 2 (nu_eff - nu) rho div(S) in float32 (B9).
//
// Replaces the Pallas kernel of tnl_lbm_tpu/kernels/fused_nn.py
// make_nn_force_kernel (kernel :111, pallas_call :232), the reference's
// cudaLBMKernelStress and forcing pass (nonNewtonian.h:216-391, 690-788).
// The strain-rate tensor S from u and the fluid mask (map == FLUID: INFLOW,
// OUTFLOW and NOTHING sites are not fluid to the stencil), gamma and nu_eff
// (Carreau-Yasuda or Casson), the wall-aware divergence of S; F = 0 away
// from FLUID sites.  Its plain version is the forcing hook of
// ops/non_newtonian.py on whole tensors.
//
// The rule that makes it match the plain hook: clamp or wrap the
// coordinate, never the value.  Every read of u, of the mask and of S at an
// offset goes to the neighbour coordinate under the hook's periodicity
// (nn_bits: wrapped on a periodic axis, clamped to the edge otherwise), and
// S at a neighbour is S of that clamped or wrapped site - both the hook's
// _pad1(u) and its separate _pad1(S) edge replication.  The hook's
// periodicity is its own, independent of the domain's.
//
// Design (nn_site.cuh, the tile B10 shares): a block of 256 threads owns a
// 4 x 8 x 32 tile, z fastest; it loads u and the mask on the tile and a
// 2-site ring into shared memory at the canonical coordinates, evaluates S
// on the tile and a 1-site ring there, and writes F of the tile sites.
//
// Bound: HBM bytes.  Per site rho (4 B) and u (12 B) and the map (1 B) are
// read once and F (12 B) written: 29 B/site.  The rings read u 3.375 times
// per site, mostly from L2; the loads of a warp are runs along z.

#include <cuda_runtime.h>

#include <cstdint>

#include "lbm_site.cuh"
#include "nn_site.cuh"

extern "C" __global__ void __launch_bounds__(nn::TILE_THREADS)
    nn_force_kernel(const float* __restrict__ rho, const float* __restrict__ u,
                    const uint8_t* __restrict__ map, float* __restrict__ F, int X, int Y, int Z,
                    int nn_bits, nn::Rheology r) {
  extern __shared__ float smem[];
  const nn::Tile t = nn::tile(smem, X, Y, Z, nn_bits);
  const int64_t N = (int64_t)X * Y * Z;
  for (int i = threadIdx.x; i < nn::NU_SLOTS; i += blockDim.x) {
    int c[3], j;
    nn::u_slot(t, i, c, j);
    const int64_t s = ((int64_t)c[0] * Y + c[1]) * Z + c[2];
#pragma unroll
    for (int b = 0; b < 3; ++b) t.u[b * nn::NU_SLOTS + i] = u[b * N + s];
    t.fluid[i] = map[s] == lbm::GEO_FLUID;
  }
  __syncthreads();
  nn::tile_strain(t);
  __syncthreads();
  for (int j = threadIdx.x; j < nn::NT; j += blockDim.x) {
    int c[3];
    if (!nn::tile_site(t, j, c)) continue;
    const int64_t s = ((int64_t)c[0] * Y + c[1]) * Z + c[2];
    float out[3];
    nn::tile_force(t, r, j, rho[s], out);
#pragma unroll
    for (int b = 0; b < 3; ++b) F[b * N + s] = out[b];
  }
}

// Launches on `stream`; returns cudaGetLastError() of the launch.  nn_bits:
// the hook's periodic axes (bit 0 x, bit 1 y, bit 2 z); model 0
// Carreau-Yasuda (nu0 - nu, lambda, a, (n - 1) / a), 1 Casson (k0, k1).
extern "C" int tnl_lbm_nn_force(const float* rho, const float* u, const uint8_t* map, float* F,
                                int X, int Y, int Z, int nn_bits, int model, float nu,
                                float nu0_minus_nu, float lam, float a, float expo, float k0,
                                float k1, void* stream) {
  if (model != nn::CARREAU_YASUDA && model != nn::CASSON)
    return static_cast<int>(cudaErrorInvalidValue);
  const nn::Rheology r{model, nu, nu0_minus_nu, lam, a, expo, k0, k1};
  const cudaError_t err = cudaFuncSetAttribute(
      nn_force_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nn::TILE_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Z + nn::TZ - 1) / nn::TZ, (Y + nn::TY - 1) / nn::TY, (X + nn::TX - 1) / nn::TX);
  nn_force_kernel<<<grid, nn::TILE_THREADS, nn::TILE_SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(rho, u, map, F, X, Y, Z, nn_bits, r);
  return static_cast<int>(cudaGetLastError());
}
