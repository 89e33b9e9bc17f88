// One-kernel A-A pair for D3Q27 CUM_WELL: two lattice steps (even, then
// odd) per launch, state stored in float32, float16 or bfloat16, every
// operation in float32.
//
// Replaces the Pallas kernel of tnl_lbm_tpu/kernels/fused_aa.py
// make_fused_pair2_aa (kernel at :794, pallas_call at :1115).  Per call
// f_out = narrow(odd(even(widen(f_in)))), with rho and u from the odd
// sub-step; even and odd are the per-step kernels' functions (aa_even.cu,
// aa_odd.cu) and their plain versions even_step_plain / odd_step_plain.
//
// Design (pair_window.cuh).  A block owns an output tile of 4 x 4 x 32
// sites (z fastest).  It runs the even sub-step on the tile and its
// one-site halo (the window) and keeps that output in shared memory as
// float32 structure of arrays, ev[q][window site], so the intermediate
// never touches HBM and is never rounded to the store type
// (fused_aa.py:987-999).  Window sites outside a non-periodic domain take
// the even output of the clamped site, and periodic axes wrap: that is
// pad_halo of the even output, what the odd sub-step reads
// (fused_aa.py:1001-1025; along z the clamp at the true extent of
// _zshift).  The even output sits in the post-permutation slot order
// (out_perm = opp), so the odd read is aa_odd.cu's, ev[opp q](s - c_q).
// NOTHING sites keep their DFs through the even sub-step.  After one
// barrier the odd sub-step runs on the tile's own sites and scatters with
// aa_odd.cu's one-writer rule (push_targets), so the odd ring is not
// recomputed; pushes aimed at NOTHING sites are dropped and those sites
// write their even output back (fused_aa.py:1064-1069), which narrows to
// the stored bits exactly.  Blocks read their neighbours' sites, so the
// kernel reads f_in and writes a second buffer.  Only the final store
// narrows, with round-to-nearest-even like torch's .to().
//
// Bound: HBM bytes, one read and one write of f per two steps (216 B/site
// in float32, 108 B with 16-bit storage), plus the map and, for the odd
// sub-step, 16 B of rho and u.  Loads and stores are coalesced along z.
// The window re-reads 1224 / 512 = 2.4x the tile's sites (mostly from L2)
// and recomputes the even collision as often.  The window's 132 KB of
// shared memory leave one block of 512 threads per SM, whose loads and
// arithmetic do not overlap; a design that marches along x with a ring of
// three window planes recomputes only 1.3x, but without asynchronous
// copies it measured slower on an H100.  Offsets are 64-bit; partial tiles
// are masked.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "lbm_site.cuh"
#include "pair_window.cuh"

using namespace lbm;
using namespace lbm::pair;

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename S>
__device__ __forceinline__ S narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half narrow<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename S>
__device__ __forceinline__ void aa_pair_body(const S* __restrict__ f, S* __restrict__ fout,
                                             const uint8_t* __restrict__ map,
                                             float* __restrict__ rho_out,
                                             float* __restrict__ u_out, int X, int Y, int Z,
                                             int periodic_bits, int has_nothing,
                                             int with_macro, SiteParams p) {
  extern __shared__ float ev[];  // [Q][WSITES]
  const int64_t N = (int64_t)X * Y * Z;

  // ---- even sub-step on the window: same-site read, opposite-slot result
  for (int w = threadIdx.x; w < WSITES; w += THREADS) {
    const int64_t site = window_site(w, blockIdx.x, blockIdx.y, blockIdx.z, X, Y, Z,
                                     periodic_bits);
    if (site < 0) continue;
    const uint8_t m = map[site];
    float v[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = widen(f[q * N + site]);
    if (m == GEO_NOTHING) {
#pragma unroll
      for (int q = 0; q < Q; ++q) ev[q * WSITES + w] = v[q];
    } else {
      float rho, ux, uy, uz;
      stream_bc_collide(v, m, p, rho, ux, uy, uz);
#pragma unroll
      for (int q = 0; q < Q; ++q) ev[q * WSITES + w] = v[opp(q)];
    }
  }
  __syncthreads();

  // ---- odd sub-step on the tile's own sites: neighbour pull, collide, push
  const TileSite t;
  const int x = blockIdx.z * TX + t.lx, y = blockIdx.y * TY + t.ly, z = blockIdx.x * TZ + t.lz;
  if (x >= X || y >= Y || z >= Z) return;
  const bool px = periodic_bits & 1, py = periodic_bits & 2, pz = periodic_bits & 4;
  const int64_t sx = (int64_t)Y * Z, sy = Z;
  const int64_t site = x * sx + y * sy + z;
  float v[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q)
    v[q] = ev[opp(q) * WSITES + t.w - cx(q) * (WY * WZ) - cy(q) * WZ - cz(q)];
  const uint8_t m = map[site];
  float rho, ux, uy, uz;
  stream_bc_collide(v, m, p, rho, ux, uy, uz);

  // pushes aimed at a NOTHING site are dropped: its own thread restores it
  auto push = [&](int q, int64_t dst) {
    if (!(has_nothing && map[dst] == GEO_NOTHING)) fout[q * N + dst] = narrow<S>(v[q]);
  };
  // rows away from the x and y faces: only z needs the edge-replication rule
  if (x > 0 && x < X - 1 && y > 0 && y < Y - 1) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      int tz0, tz1;
      push_targets(z, cz(q), Z, pz, tz0, tz1);
      const int64_t row = site - z + cx(q) * sx + cy(q) * sy;
      if (tz0 >= 0) push(q, row + tz0);
      if (tz1 >= 0) push(q, row + tz1);
    }
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      int tx[2], ty[2], tz[2];
      push_targets(x, cx(q), X, px, tx[0], tx[1]);
      push_targets(y, cy(q), Y, py, ty[0], ty[1]);
      push_targets(z, cz(q), Z, pz, tz[0], tz[1]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            if (tx[i] >= 0 && ty[j] >= 0 && tz[k] >= 0)
              push(q, ((int64_t)tx[i] * Y + ty[j]) * Z + tz[k]);
    }
  }
  if (m == GEO_NOTHING) {
#pragma unroll
    for (int q = 0; q < Q; ++q) fout[q * N + site] = narrow<S>(ev[q * WSITES + t.w]);
  }
  if (with_macro) {
    rho_out[site] = rho;
    u_out[site] = ux;
    u_out[N + site] = uy;
    u_out[2 * N + site] = uz;
  }
}

}  // namespace

#define AA_PAIR_KERNEL(NAME, S)                                                              \
  extern "C" __global__ void __launch_bounds__(THREADS, 1)                                  \
      NAME(const S* __restrict__ f, S* __restrict__ fout, const uint8_t* __restrict__ map,  \
           float* __restrict__ rho, float* __restrict__ u, int X, int Y, int Z,             \
           int periodic_bits, int has_nothing, int with_macro, SiteParams p) {              \
    aa_pair_body<S>(f, fout, map, rho, u, X, Y, Z, periodic_bits, has_nothing, with_macro, \
                    p);                                                                     \
  }

AA_PAIR_KERNEL(aa_pair_f32_kernel, float)
AA_PAIR_KERNEL(aa_pair_f16_kernel, __half)
AA_PAIR_KERNEL(aa_pair_bf16_kernel, __nv_bfloat16)

namespace {

template <typename S>
using PairKernel = void (*)(const S*, S*, const uint8_t*, float*, float*, int, int, int, int,
                            int, int, SiteParams);

template <typename S>
int launch(PairKernel<S> kernel, const void* f, void* fout, const uint8_t* map, float* rho,
           float* u, int X, int Y, int Z, int periodic_bits, int has_nothing, int with_macro,
           const SiteParams& p, cudaStream_t stream) {
  static bool opted_in = false;  // the window needs more than the 48 KB default
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  kernel<<<grid(X, Y, Z), THREADS, SMEM_BYTES, stream>>>(
      static_cast<const S*>(f), static_cast<S*>(fout), map, rho, u, X, Y, Z, periodic_bits,
      has_nothing, with_macro, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one block (the window), in bytes.
extern "C" int tnl_lbm_aa_pair_smem_bytes() { return SMEM_BYTES; }

// Launches on `stream`; returns the CUDA error of the launch (0 on success).
// store: 0 float32, 1 float16, 2 bfloat16.  periodic_bits: bit 0 x, 1 y,
// 2 z.  rho and u may be null when with_macro is 0.
extern "C" int tnl_lbm_aa_pair(const void* f, void* fout, const uint8_t* map, float* rho,
                               float* u, int X, int Y, int Z, int periodic_bits,
                               int has_nothing, int with_macro, int store, float nu, float fx,
                               float fy, float fz, int neumaier, void* stream) {
  const SiteParams p{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, neumaier};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (store) {
    case 0:
      return launch<float>(aa_pair_f32_kernel, f, fout, map, rho, u, X, Y, Z, periodic_bits,
                           has_nothing, with_macro, p, s);
    case 1:
      return launch<__half>(aa_pair_f16_kernel, f, fout, map, rho, u, X, Y, Z, periodic_bits,
                            has_nothing, with_macro, p, s);
    case 2:
      return launch<__nv_bfloat16>(aa_pair_bf16_kernel, f, fout, map, rho, u, X, Y, Z,
                                   periodic_bits, has_nothing, with_macro, p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
