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
// Design (nn_site.cuh, the march B10 shares): a block of 256 threads owns an
// 8 x 32 y-z column tile and walks an x segment of at most 32 planes, one
// step a plane and one block barrier a step: it loads u and the mask of the
// incoming plane on the tile and a 2-site y-z ring, at the canonical
// coordinates, into registers, evaluates S on the plane two behind (the
// tile and a 1-site ring) and F of the plane four behind, then stores the
// loaded plane into the u ring, so the loads are in flight behind the
// step's arithmetic.  69 424 B of shared memory: three blocks per SM.
//
// Bound: HBM bytes.  Per site rho (4 B) and u (12 B) and the map (1 B) are
// read once and F (12 B) written: 29 B/site.  The u ring reads u 1.69 times
// per site (432 slots for 256 sites) plus 4 planes per segment, the slots
// beyond the tile mostly from L2; a warp's loads are runs along z.  What
// holds it on an H100 (PERF.md, tests/nn_ablation.py): the S and F
// arithmetic and its shared-memory reads take about half of its time and
// the march's loads, stores and barriers the other half, one after the
// other; staging u by cp.async two planes ahead gained nothing.

#include <cuda_runtime.h>

#include <cstdint>

#include "lbm_site.cuh"

#define NN_TY 8  // the column tile: 8 x 32 sites, one thread each
#include "nn_site.cuh"


// The march of a block.  HALO (B9 halo): u and the map hold the shard's
// block with a 2-wide x/y halo, [3, X+4, Y+4, Z] and [X+4, Y+4, Z], rho and F
// the block [X, Y, Z]; h the halo's geometry (nn_site.cuh Halo).
template <bool HALO>
__device__ __forceinline__ void nn_force_march(const float* __restrict__ rho,
                                               const float* __restrict__ u,
                                               const uint8_t* __restrict__ map,
                                               float* __restrict__ F, int X, int Y, int Z,
                                               int nn_bits, int seg_len, const nn::Rheology& r,
                                               const nn::Halo& h) {
  extern __shared__ __align__(16) float smem[];
  const nn::March m = nn::march<HALO>(smem, false, X, Y, Z, nn_bits, seg_len, h);
  const int64_t YZ = (int64_t)Y * Z, N = X * YZ;
  // the strides of u and the map: the haloed block's in the haloed mode
  const int64_t YZu = HALO ? (int64_t)(Y + 2 * h.H) * Z : YZ;
  const int64_t Nu = HALO ? (int64_t)(X + 2 * h.H) * YZu : N;
  const int L = m.xe - m.xs;
  int ly, lz;
  const bool mine = nn::tile_site(m, ly, lz);
  const int64_t tile_yz = (int64_t)(m.y0 + ly) * Z + m.z0 + lz;
  for (int j = 0; j < L + nn::F_LAG + 2; ++j) {
    // u and the mask of plane j, loaded now and stored after S and F
    const bool load = j < L + 4;
    float uv[nn::U_PER_THREAD][3];
    bool fl[nn::U_PER_THREAD];
    if (load) {
      const int64_t xo = (int64_t)nn::plane_x<HALO>(m, j) * YZu;
#pragma unroll
      for (int k = 0; k < nn::U_PER_THREAD; ++k) {
        const int i = nn::u_slot_of(threadIdx.x, k);
        if (i >= nn::U_SLOTS) continue;
        const unsigned yz = m.uyz[i];
        const int64_t s = xo + (int64_t)(yz >> 16) * Z + (yz & 0xffff);
#pragma unroll
        for (int b = 0; b < 3; ++b) uv[k][b] = u[b * Nu + s];
        fl[k] = map[s] == lbm::GEO_FLUID;
      }
    }
    const int p = j - nn::F_LAG;
    const bool force = p >= 2 && p <= L + 1 && mine;
    const int64_t s = (m.xs + p - 2) * YZ + tile_yz;
    const float rho_s = force ? rho[s] : 0.0f;
    const int q = j - nn::S_LAG;
    if (q >= 1 && q <= L + 2) nn::strain_plane(m, q);
    if (force) {
      float out[3];
      nn::force_at<HALO>(m, r, p, m.xs + p - 2, ly, lz, rho_s, out);
#pragma unroll
      for (int b = 0; b < 3; ++b) F[b * N + s] = out[b];
    }
    if (load) {
#pragma unroll
      for (int k = 0; k < nn::U_PER_THREAD; ++k) {
        const int i = nn::u_slot_of(threadIdx.x, k);
        if (i < nn::U_SLOTS) nn::put_u(m, j, i, uv[k][0], uv[k][1], uv[k][2], fl[k]);
      }
    }
    __syncthreads();
  }
}

extern "C" __global__ void __launch_bounds__(nn::THREADS, nn::FORCE_BLOCKS_PER_SM)
    nn_force_kernel(const float* __restrict__ rho, const float* __restrict__ u,
                    const uint8_t* __restrict__ map, float* __restrict__ F, int X, int Y, int Z,
                    int nn_bits, int seg_len, nn::Rheology r) {
  nn_force_march<false>(rho, u, map, F, X, Y, Z, nn_bits, seg_len, r, nn::Halo{});
}

// B9 halo: the march over a shard's block (nn_force_march<true>).
extern "C" __global__ void __launch_bounds__(nn::THREADS, nn::FORCE_BLOCKS_PER_SM)
    nn_force_halo_kernel(const float* __restrict__ rho, const float* __restrict__ u,
                         const uint8_t* __restrict__ map, float* __restrict__ F, int X, int Y,
                         int Z, int nn_bits, int seg_len, nn::Rheology r, nn::Halo h) {
  nn_force_march<true>(rho, u, map, F, X, Y, Z, nn_bits, seg_len, r, h);
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
  if (Y > 65535 || Z > 65535) return static_cast<int>(cudaErrorInvalidValue);  // y << 16 | z
  const nn::Rheology r{model, nu, nu0_minus_nu, lam, a, expo, k0, k1};
  const cudaError_t err = cudaFuncSetAttribute(
      nn_force_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nn::FORCE_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const nn::Launch l = nn::launch(X, Y, Z, nn::FORCE_BLOCKS_PER_SM);
  nn_force_kernel<<<l.blocks, nn::THREADS, nn::FORCE_SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(rho, u, map, F, X, Y, Z, nn_bits,
                                                         l.seg_len, r);
  return static_cast<int>(cudaGetLastError());
}

// B9 halo on `stream`: the NN force on a shard's block of X x Y x Z sites
// from u [3, X+4, Y+4, Z] and the map [X+4, Y+4, Z] with their 2-wide x/y
// halos (u* one site beyond the block gives S there, S one beyond gives F)
// and rho [X, Y, Z], into F [3, X, Y, Z].  nn_bits: the hook's periodic
// axes (z alone is read: x and y come from the halo); gbits: the block's
// closed faces (bit 0 low x, 1 high x, 2 low y, 3 high y), faces of the
// domain on which the hook does not wrap, where u, the mask and S
// edge-replicate as in the unsharded kernel.  Returns cudaGetLastError().
extern "C" int tnl_lbm_nn_force_halo(const float* rho, const float* u, const uint8_t* map,
                                     float* F, int X, int Y, int Z, int nn_bits, int gbits,
                                     int model, float nu, float nu0_minus_nu, float lam, float a,
                                     float expo, float k0, float k1, void* stream) {
  if (model != nn::CARREAU_YASUDA && model != nn::CASSON)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Y + 4 > 65535 || Z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const nn::Rheology r{model, nu, nu0_minus_nu, lam, a, expo, k0, k1};
  const cudaError_t err = cudaFuncSetAttribute(
      nn_force_halo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nn::FORCE_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const nn::Halo h{2, 2, 0, 0, X, Y, gbits};
  const nn::Launch l = nn::launch(X, Y, Z, nn::FORCE_BLOCKS_PER_SM);
  nn_force_halo_kernel<<<l.blocks, nn::THREADS, nn::FORCE_SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(rho, u, map, F, X, Y, Z, nn_bits,
                                                              l.seg_len, r, h);
  return static_cast<int>(cudaGetLastError());
}

// B9's launch geometry at a shape (nn_site.cuh launch_info), for
// tnl_lbm_nn_info in nn_step.cu.
int nn_force_info(int X, int Y, int Z, int* out) {
  return nn::launch_info(X, Y, Z, nn::FORCE_BLOCKS_PER_SM, nn::FORCE_SMEM_BYTES, out);
}
