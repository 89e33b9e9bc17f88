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
//
// element_pipeline_kernel replaces scripts/probe_element_pipeline.py make
// (Pallas kernel at :21, pallas_call at :32): every (tx, ty) tile of a
// padded [27, X+4, Y+16, Z] state reads its overlapping (tx+4, ty+16)
// window, runs `passes` rounds of the affine map on the tile's interior
// and writes it to the same place of the output, whose ring is left
// unwritten as the Pallas kernel leaves it.  The window is staged through
// shared memory with cp.async, 16 bytes per copy, double-buffered over
// z chunks (one block per tile and component), and the passes run from
// shared memory, so the question of the script - do the staged copies and
// the compute overlap - is asked of this card: compare passes 0, 20 and
// 60 with pair_compute_only's compute-only time.  Bound: HBM bytes, the
// state read once and the interior written once (216 B/site); the
// overlapping windows read (tx+4)(ty+16)/(tx ty) times the interior, from
// L2 where the neighbouring tiles' blocks run close together.
//
// window_copy_kernel<LOAD> replaces scripts/probe_dma_align.py make_copy
// (Pallas kernel at :23, pallas_call at :50): tiles of TX x TY = 16 x 32
// sites; each block copies its [TX+4, wy, Z] window of one component,
// whose y rows start at j TY + y_off, one x plane at a time into shared
// memory at row dst_off, then writes the plane's interior rows - those of
// fpad[:, 2:X+2, 8:Y+8, :] - to the [27, X, Y, Z] output.  On the TPU a y
// offset moved the window's start within an (8, 128) tile, which its DMA
// engine may refuse.  On this card a y offset moves the window by whole
// rows of Z * 4 bytes, so it changes no 16-byte alignment: the variants
// differ only in the window's size.  What the probe measures here is the
// load path: LOAD_4B (plain 4-byte loads), LOAD_16B (16-byte loads) or
// LOAD_TMA (one bulk copy of the plane's wy Z floats, completed on an
// mbarrier).  The stores and the output are the same in all three.
// Bound: HBM bytes, the interior read once and written once (216 B/site).

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

// threads per block of the window probes
constexpr int WTHREADS = 256;
// tile of the alignment probe (scripts/probe_dma_align.py TX, TY)
constexpr int ATX = 16, ATY = 32;
// dynamic shared memory the window probes may ask for
constexpr int WINDOW_SMEM_MAX = 200 * 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

}  // namespace

// grid (X / tx, Y / ty, 27); dynamic shared memory: two stages of
// (tx+4) (ty+16) zc floats.  fpad and out: [27, X+4, Y+16, Z]; Z % zc == 0,
// zc % 4 == 0.
extern "C" __global__ void __launch_bounds__(WTHREADS)
element_pipeline_kernel(const float* __restrict__ fpad, float* __restrict__ out, int X, int Y,
                        int Z, int tx, int ty, int zc, int passes) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  const int wx = tx + 4, wy = ty + 16, XP = X + 4, YP = Y + 16;
  const int stage = wx * wy * zc;
  const int x0 = blockIdx.x * tx, y0 = blockIdx.y * ty;
  const int64_t qbase = (int64_t)blockIdx.z * XP * YP * Z;
  const int vecs = zc / 4, nvec = wx * wy * vecs, nchunks = Z / zc, nout = tx * ty * zc;
  auto issue = [&](int c) {
    float* dst = buf + (c & 1) * stage;
    for (int k = threadIdx.x; k < nvec; k += WTHREADS) {
      const int v = k % vecs, r = k / vecs;
      const int ly = r % wy, lx = r / wy;
      cp_async16(dst + r * zc + 4 * v,
                 fpad + qbase + ((int64_t)(x0 + lx) * YP + (y0 + ly)) * Z + c * zc + 4 * v);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  issue(0);
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      issue(c + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* win = buf + (c & 1) * stage;
    for (int k = threadIdx.x; k < nout; k += WTHREADS) {
      const int lz = k % zc, r = k / zc;
      const int ly = r % ty, lx = r / ty;
      out[qbase + ((int64_t)(x0 + 2 + lx) * YP + (y0 + 8 + ly)) * Z + c * zc + lz] =
          affine(win[((lx + 2) * wy + (ly + 8)) * zc + lz], passes);
    }
    __syncthreads();  // the next issue overwrites this stage
  }
}

constexpr int LOAD_4B = 0, LOAD_16B = 1, LOAD_TMA = 2;

// grid (X / 16, Y / 32, 27); dynamic shared memory: (dst_off + wy) Z floats.
// fpad: [27, X+4, Y+16, Z], out: [27, X, Y, Z]; Z % 4 == 0, and the window
// covers its tile's interior rows (the wrapper checks).
template <int LOAD>
__device__ __forceinline__ void window_copy(const float* __restrict__ fpad,
                                            float* __restrict__ out, int X, int Y, int Z,
                                            int y_off, int wy, int dst_off) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bar;
  float* buf = reinterpret_cast<float*>(smem4);
  const int XP = X + 4, YP = Y + 16, q = blockIdx.z;
  const int i = blockIdx.x, j = blockIdx.y;
  const int n = wy * Z;  // floats per plane, contiguous in fpad
  float* dst = buf + dst_off * Z;
  // the interior rows sit at dst_off + (8 - y_off) of the buffer
  const float4* interior = reinterpret_cast<const float4*>(buf + (dst_off + 8 - y_off) * Z);
  if (LOAD == LOAD_TMA && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(&bar)), "r"(1u)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t parity = 0;
  for (int lx = 0; lx < ATX + 4; ++lx) {
    const float* src = fpad + (((int64_t)q * XP + i * ATX + lx) * YP + j * ATY + y_off) * Z;
    if constexpr (LOAD == LOAD_4B) {
      for (int k = threadIdx.x; k < n; k += WTHREADS) dst[k] = src[k];
      __syncthreads();
    } else if constexpr (LOAD == LOAD_16B) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (int k = threadIdx.x; k < n / 4; k += WTHREADS) d4[k] = s4[k];
      __syncthreads();
    } else {
      const uint32_t b = smem_addr(&bar);
      if (threadIdx.x == 0) {
        const uint32_t bytes = static_cast<uint32_t>(n) * 4u;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                     "r"(bytes)
                     : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(smem_addr(dst)),
            "l"(src), "r"(bytes), "r"(b)
            : "memory");
      }
      mbar_wait(b, parity);
      parity ^= 1u;
    }
    if (lx >= 2 && lx < ATX + 2) {
      float4* o = reinterpret_cast<float4*>(
          out + (((int64_t)q * X + i * ATX + lx - 2) * Y + j * ATY) * Z);
      for (int k = threadIdx.x; k < ATY * Z / 4; k += WTHREADS) o[k] = interior[k];
    }
    __syncthreads();  // the next plane overwrites the buffer
    if constexpr (LOAD == LOAD_TMA) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
}

#define WINDOW_COPY_KERNEL(NAME, LOAD)                                                        \
  extern "C" __global__ void __launch_bounds__(WTHREADS)                                     \
      NAME(const float* __restrict__ fpad, float* __restrict__ out, int X, int Y, int Z,      \
           int y_off, int wy, int dst_off) {                                                  \
    window_copy<LOAD>(fpad, out, X, Y, Z, y_off, wy, dst_off);                                \
  }

WINDOW_COPY_KERNEL(window_copy_ld4_kernel, LOAD_4B)
WINDOW_COPY_KERNEL(window_copy_ld16_kernel, LOAD_16B)
WINDOW_COPY_KERNEL(window_copy_tma_kernel, LOAD_TMA)

namespace {

// The window needs more shared memory than the 48 KB default.
cudaError_t opt_in(const void* kernel, int bytes = SMEM_BYTES) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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

// fpad, out: [27, X+4, Y+16, Z]; X % tx == 0, Y % ty == 0, Z % zc == 0,
// zc % 4 == 0 and two stages within WINDOW_SMEM_MAX (the wrapper checks).
extern "C" int tnl_lbm_element_pipeline(const float* fpad, float* out, int X, int Y, int Z,
                                        int tx, int ty, int zc, int passes, void* stream) {
  static const cudaError_t opted =
      opt_in(reinterpret_cast<const void*>(element_pipeline_kernel), WINDOW_SMEM_MAX);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const int smem = 2 * (tx + 4) * (ty + 16) * zc * (int)sizeof(float);
  if (smem > WINDOW_SMEM_MAX || zc % 4 != 0 || Z % zc != 0 || X % tx != 0 || Y % ty != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  element_pipeline_kernel<<<dim3(X / tx, Y / ty, Q), WTHREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(fpad, out, X, Y, Z, tx, ty, zc,
                                                                 passes);
  return static_cast<int>(cudaGetLastError());
}

// load: 0 plain 4-byte loads, 1 16-byte loads, 2 a bulk copy (TMA).  fpad:
// [27, X+4, Y+16, Z], out: [27, X, Y, Z]; X % 16 == 0, Y % 32 == 0,
// Z % 4 == 0, 0 <= y_off <= 8, y_off + wy <= 48 and 8 - y_off + 32 <= wy
// (the window covers its tile; the wrapper checks and names the fault).
extern "C" int tnl_lbm_window_copy(const float* fpad, float* out, int X, int Y, int Z,
                                   int y_off, int wy, int dst_off, int load, void* stream) {
  using Kernel = void (*)(const float*, float*, int, int, int, int, int, int);
  static const Kernel kernels[3] = {window_copy_ld4_kernel, window_copy_ld16_kernel,
                                    window_copy_tma_kernel};
  static const cudaError_t opted[3] = {
      opt_in(reinterpret_cast<const void*>(window_copy_ld4_kernel), WINDOW_SMEM_MAX),
      opt_in(reinterpret_cast<const void*>(window_copy_ld16_kernel), WINDOW_SMEM_MAX),
      opt_in(reinterpret_cast<const void*>(window_copy_tma_kernel), WINDOW_SMEM_MAX)};
  if (load < 0 || load > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (opted[load] != cudaSuccess) return static_cast<int>(opted[load]);
  const int smem = (dst_off + wy) * Z * (int)sizeof(float);
  if (smem > WINDOW_SMEM_MAX || X % ATX != 0 || Y % ATY != 0 || Z % 4 != 0 || y_off < 0 ||
      y_off > 8 || dst_off < 0 || y_off + wy > ATY + 16 || 8 - y_off + ATY > wy)
    return static_cast<int>(cudaErrorInvalidValue);
  kernels[load]<<<dim3(X / ATX, Y / ATY, Q), WTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      fpad, out, X, Y, Z, y_off, wy, dst_off);
  return static_cast<int>(cudaGetLastError());
}
