// The full-set A-A pair (B1b, aa_pair_full.cu) for the collisions of
// collisions.cuh: the same x-march (pair_march.cuh pair_march) over the even
// and odd steps' site updates (lbm_site.cuh site_collide) with the
// collision C, the equilibrium kind of the boundary sites read at run time
// (CollParams::eq, EQ_DYN; the well-conditioned collisions take the well
// equilibrium) and KBC's variant bits (CollParams::kbc).  Included by one
// source per collision family (pair_coll_srt.cu, pair_coll_clbm.cu,
// pair_coll_kbc.cu), so that the families compile in parallel.
//
// Replaces, beside aa_pair_full.cu's cumulant instances, the same Pallas
// kernels: tnl_lbm_tpu/kernels/fused_aa.py make_fused_pair_aa (:1183; even
// pallas_call :1274, odd :287), whose bodies call the config's collision
// (_stream_bc_collide, :1254).  The geometry, the ring (OUT_GROUPS groups
// of each class: an OUTFLOW_RIGHT site pulls all of plane o - 1) and the
// shared memory are the full-set cumulant instances' (OUT_SMEM_BYTES,
// 148 580 B), at 608 threads a block: 104 registers a thread at most, so
// the longer collisions spill (the ptxas report, PERF.md).
//
// Bound: HBM bytes, one read and one write of f per pair, the map, rho and
// u: 233 B/site.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "collisions.cuh"
#include "lbm_site.cuh"
#include "pair_march.cuh"

namespace lbm {
namespace march {

// The site updates of collision C on storage WELL.
template <bool WELL, class C>
struct CollSite {
  using Store = float;
  using Params = CollParams;
  static constexpr bool STAGED = false, OUTFLOW = true;
  static constexpr int EQ = WELL ? EQ_WELL : EQ_DYN;
  __device__ static __forceinline__ void even(float (&v)[Q], uint8_t m, const CollParams& p) {
    float rho, ux, uy, uz;
    site_collide<WELL, EQ, C>(v, m, p, rho, ux, uy, uz);
  }
  __device__ static __forceinline__ void odd(float (&v)[Q], uint8_t m, const CollParams& p,
                                             float& rho, float& ux, float& uy, float& uz) {
    site_collide<WELL, EQ, C>(v, m, p, rho, ux, uy, uz);
  }
};

using PairCollKernel = void (*)(const float*, float*, const uint8_t*, float*, float*, int, int,
                                int, int, int, int, int, CollParams);

// Launch collision `coll` of a family's table on `stream`; the arguments
// after kbc as tnl_lbm_aa_pair_full's.  `opted` holds each kernel's
// dynamic shared memory opt-in (cudaErrorNotReady until asked).  Returns the
// CUDA error of the launch, or cudaErrorInvalidValue for an unknown
// collision or equilibrium kind, rho and u not both given or both null, or
// a plane of 2^31 sites or more.
inline int launch_pair_coll(const PairCollKernel* table, cudaError_t* opted, int ncoll, int coll,
                            int eq, int kbc, const float* f, float* fout, const uint8_t* map,
                            float* rho, float* u, int X, int Y, int Z, int periodic_bits,
                            int has_nothing, int with_macro, float nu, float fx, float fy,
                            float fz, float uin_x, float uin_y, float uin_z, int neumaier,
                            int seg_len, void* stream) {
  if (coll < 0 || coll >= ncoll || eq < EQ_QUAD || eq > EQ_ENTROPIC ||
      (rho == nullptr) != (u == nullptr) || (with_macro != 0) != (rho != nullptr) ||
      (int64_t)Y * Z > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (opted[coll] == cudaErrorNotReady)
    opted[coll] = cudaFuncSetAttribute(table[coll], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       OUT_SMEM_BYTES);
  if (opted[coll] != cudaSuccess) return static_cast<int>(opted[coll]);
  if (seg_len <= 0) seg_len = auto_seg_len(X, Y, Z);
  const CollParams p{{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier},
                     nu, eq, kbc};
  const int blocks = column_tiles(Y, Z) * ((X + seg_len - 1) / seg_len);
  table[coll]<<<blocks, THREADS, OUT_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      f, fout, map, rho, u, X, Y, Z, periodic_bits, has_nothing, with_macro, seg_len, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace march
}  // namespace lbm

// The pair kernel of collision C on storage WELL, named aa_pair_full_<TAG>_kernel
// so that the -Xptxas -v report reads per instance.
#define PAIR_COLL_KERNEL(TAG, C, WELL)                                                        \
  extern "C" __global__ void __launch_bounds__(lbm::march::THREADS, 1)                       \
      aa_pair_full_##TAG##_kernel(const float* __restrict__ f, float* __restrict__ fout,      \
                                  const uint8_t* __restrict__ map, float* __restrict__ rho,  \
                                  float* __restrict__ u, int X, int Y, int Z,                \
                                  int periodic_bits, int has_nothing, int with_macro,        \
                                  int seg_len, lbm::CollParams p) {                           \
    lbm::march::pair_march<lbm::march::CollSite<WELL, C>>(                                    \
        f, fout, map, rho, u, X, Y, Z, periodic_bits, has_nothing, with_macro, seg_len, 0, p); \
  }

// The C entry of a family: NAME(coll, eq, kbc, f, fout, map, rho, u, X, Y,
// Z, periodic_bits, has_nothing, with_macro, nu, fx, fy, fz, uin_x, uin_y,
// uin_z, neumaier, seg_len, stream) over TABLE, whose entries are the
// family's pair kernels in collision order.
#define PAIR_COLL_ENTRY(NAME, TABLE)                                                            \
  extern "C" int NAME(int coll, int eq, int kbc, const float* f, float* fout,                   \
                      const uint8_t* map, float* rho, float* u, int X, int Y, int Z,             \
                      int periodic_bits, int has_nothing, int with_macro, float nu, float fx,    \
                      float fy, float fz, float uin_x, float uin_y, float uin_z, int neumaier,   \
                      int seg_len, void* stream) {                                              \
    constexpr int n = sizeof(TABLE) / sizeof(TABLE[0]);                                         \
    static cudaError_t opted[n];                                                                \
    static bool init = false;                                                                   \
    if (!init) {                                                                                \
      for (int k = 0; k < n; ++k) opted[k] = cudaErrorNotReady;                                 \
      init = true;                                                                              \
    }                                                                                           \
    return lbm::march::launch_pair_coll(TABLE, opted, n, coll, eq, kbc, f, fout, map, rho, u,   \
                                        X, Y, Z, periodic_bits, has_nothing, with_macro, nu,    \
                                        fx, fy, fz, uin_x, uin_y, uin_z, neumaier, seg_len,     \
                                        stream);                                                \
  }
