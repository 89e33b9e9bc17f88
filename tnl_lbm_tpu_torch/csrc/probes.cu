// Bandwidth probes of the A-A kernels, float32 state [27, X, Y, Z].
//
// copy_permute_kernel replaces scripts/profile_floor.py run_case (Pallas
// kernel at :24, pallas_call at :36): the even step's I/O with no
// collision, fout[q] = f[Q-1-q], rho = the sum of the permuted rows in
// order, u = (rho, rho, rho).  One thread per site, coalesced along z, as
// aa_even.cu; it measures the card's floor for 27 + 27 f32 and 16 B of
// macro per site (232 B/site).
//
// pair_pipeline_kernel and pair_compute_only_kernel replace
// scripts/probe_pair2_pipeline.py make (:20, pallas_call :73) and
// make_compute_only (:113, pallas_call :151).  They keep aa_pair.cu's grid,
// tile and one-site halo window (pair_window.cuh; wrap or clamp, as there)
// and replace its two collisions with `passes` rounds of
// x * 1.000001 + 1e-12 on the window's interior.  pair_pipeline loads every
// window into shared memory and writes every interior: the pair's memory
// traffic.  pair_compute_only loads and writes only block 0's tile; the
// other blocks compute on whatever their shared memory holds and store the
// result back to it: the pair's grid and arithmetic with no traffic.
// Multiply and add round separately (no FMA contraction), as the plain
// versions do.

#include <cuda_runtime.h>

#include "lbm_site.cuh"
#include "pair_window.cuh"

using namespace lbm;
using namespace lbm::pair;

namespace {

__device__ __forceinline__ float affine(float x, int passes) {
  for (int i = 0; i < passes; ++i) x = __fadd_rn(__fmul_rn(x, 1.000001f), 1e-12f);
  return x;
}

// Copies block (bx, by, bz)'s window of f into win[q][window site].
__device__ __forceinline__ void load_window(const float* __restrict__ f, float* win, int bx,
                                            int by, int bz, int X, int Y, int Z,
                                            int periodic_bits) {
  const int64_t N = (int64_t)X * Y * Z;
  for (int w = threadIdx.x; w < WSITES; w += THREADS) {
    const int64_t site = window_site(w, bx, by, bz, X, Y, Z, periodic_bits);
    if (site < 0) continue;
#pragma unroll
    for (int q = 0; q < Q; ++q) win[q * WSITES + w] = f[q * N + site];
  }
}

}  // namespace

extern "C" __global__ void __launch_bounds__(128)
copy_permute_kernel(const float* __restrict__ f, float* __restrict__ fout,
                    float* __restrict__ rho, float* __restrict__ u, int Y, int Z,
                    int with_macro) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  if (z >= Z) return;
  const int64_t N = (int64_t)gridDim.z * Y * Z;
  const int64_t site = ((int64_t)blockIdx.z * Y + blockIdx.y) * Z + z;
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float r = f[(Q - 1 - q) * N + site];
    fout[q * N + site] = r;
    s = q == 0 ? r : s + r;
  }
  if (with_macro) {
    rho[site] = s;
    u[site] = s;
    u[N + site] = s;
    u[2 * N + site] = s;
  }
}

extern "C" __global__ void __launch_bounds__(THREADS, 1)
pair_pipeline_kernel(const float* __restrict__ f, float* __restrict__ fout, int X, int Y,
                     int Z, int periodic_bits, int passes) {
  extern __shared__ float win[];
  load_window(f, win, blockIdx.x, blockIdx.y, blockIdx.z, X, Y, Z, periodic_bits);
  __syncthreads();
  const TileSite t;
  const int x = blockIdx.z * TX + t.lx, y = blockIdx.y * TY + t.ly, z = blockIdx.x * TZ + t.lz;
  if (x >= X || y >= Y || z >= Z) return;
  const int64_t N = (int64_t)X * Y * Z;
  const int64_t site = ((int64_t)x * Y + y) * Z + z;
#pragma unroll
  for (int q = 0; q < Q; ++q) fout[q * N + site] = affine(win[q * WSITES + t.w], passes);
}

// tile: [27, min(TX, X), min(TY, Y), min(TZ, Z)], block 0's tile.
extern "C" __global__ void __launch_bounds__(THREADS, 1)
pair_compute_only_kernel(const float* __restrict__ f, float* __restrict__ tile, int X, int Y,
                         int Z, int passes) {
  extern __shared__ float win[];
  const bool first = blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0;
  if (first) load_window(f, win, 0, 0, 0, X, Y, Z, 0);
  __syncthreads();
  const TileSite t;
  volatile float* vwin = win;  // the result stays in shared memory, as in VMEM
#pragma unroll
  for (int q = 0; q < Q; ++q) vwin[q * WSITES + t.w] = affine(win[q * WSITES + t.w], passes);
  const int nx = min(TX, X), ny = min(TY, Y), nz = min(TZ, Z);
  if (!first || t.lx >= nx || t.ly >= ny || t.lz >= nz) return;
  const int64_t n = (int64_t)nx * ny * nz;
  const int64_t site = ((int64_t)t.lx * ny + t.ly) * nz + t.lz;
#pragma unroll
  for (int q = 0; q < Q; ++q) tile[q * n + site] = vwin[q * WSITES + t.w];
}

namespace {

// The window needs more shared memory than the 48 KB default.
cudaError_t opt_in(const void* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

}  // namespace

// Each launches on `stream` and returns the CUDA error of the launch.
extern "C" int tnl_lbm_copy_permute(const float* f, float* fout, float* rho, float* u, int X,
                                    int Y, int Z, int with_macro, void* stream) {
  const int block = Z >= 128 ? 128 : ((Z + 31) / 32) * 32;
  const dim3 grid((Z + block - 1) / block, Y, X);
  copy_permute_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      f, fout, rho, u, Y, Z, with_macro);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tnl_lbm_pair_pipeline(const float* f, float* fout, int X, int Y, int Z,
                                     int periodic_bits, int passes, void* stream) {
  static const cudaError_t opted = opt_in(reinterpret_cast<const void*>(pair_pipeline_kernel));
  if (opted != cudaSuccess) return static_cast<int>(opted);
  pair_pipeline_kernel<<<grid(X, Y, Z), THREADS, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(f, fout, X, Y, Z, periodic_bits,
                                                              passes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tnl_lbm_pair_compute_only(const float* f, float* tile, int X, int Y, int Z,
                                         int passes, void* stream) {
  static const cudaError_t opted = opt_in(reinterpret_cast<const void*>(pair_compute_only_kernel));
  if (opted != cudaSuccess) return static_cast<int>(opted);
  pair_compute_only_kernel<<<grid(X, Y, Z), THREADS, SMEM_BYTES,
                             static_cast<cudaStream_t>(stream)>>>(f, tile, X, Y, Z, passes);
  return static_cast<int>(cudaGetLastError());
}
