// The per-step kernels' instances of the collisions of collisions.cuh: the
// A-B step (B4, ab_step.cu's site update ab_site), the A-A even step (B2,
// aa_even_site) and the A-A odd step (B3, aa_odd_site), one thread per
// site, each with the full boundary set of its pattern.  Included by one
// source per collision family (coll_srt.cu, coll_clbm.cu, coll_kbc.cu), so
// that the families compile in parallel.
//
// Replaces, beside ab_step.cu, aa_even.cu and aa_odd.cu, the same Pallas
// kernels: tnl_lbm_tpu/kernels/fused.py make_fused_step (pallas_call at
// :585) and fused_aa.py make_fused_step_aa (even :408, odd :287), whose
// bodies call the config's collision (fused.py:355).  Lean mode only (the
// step, without a per-site force).  The equilibrium kind of the boundary
// sites (INFLOW, OUTFLOW_EQ, OUTFLOW_RIGHT_INTERP) is a run-time argument
// (CollParams::eq, lbm_site.cuh EQ_DYN) on total DFs; the well-conditioned
// collisions take the well equilibrium.  KBC's variant is a run-time
// argument (CollParams::kbc).
//
// Bound: HBM bytes, as ab_step.cu's: 233 B/site and step (27 f32 in and
// out, the map, rho and u), KBC's too: a FLUID site issues 344-587 FP32
// slots under the other collisions and 649-902 under KBC's variants
// (tests/collision_site_ops.py), at most 0.45 ms of FP32 issue at 256^3 on
// an H100 (132 SMs, 1 980 MHz) against 1.17 ms of bytes at 3.35 TB/s.
// threadIdx.x runs along z; no shared memory.

#pragma once

#include <cuda_runtime.h>

#include "collisions.cuh"
#include "lbm_site.cuh"

namespace lbm {

// threads per block, along z
constexpr int COLL_THREADS = 128;

// One signature for the three patterns.  A-B and odd: f -> fout; even: in
// place on fout (f unused).
using CollKernel = void (*)(const float*, float*, const uint8_t*, float*, float*, int, int, int,
                            int, CollParams);

}  // namespace lbm

// The A-B, even and odd kernels of collision C on storage WELL, named
// ab_step_<TAG>_kernel, aa_even_<TAG>_kernel, aa_odd_<TAG>_kernel so that the
// -Xptxas -v report reads per instance.
#define COLL_KERNELS(TAG, C, WELL)                                                            \
  extern "C" __global__ void __launch_bounds__(lbm::COLL_THREADS) ab_step_##TAG##_kernel(    \
      const float* __restrict__ f, float* __restrict__ fout, const uint8_t* __restrict__ map, \
      float* __restrict__ rho, float* __restrict__ u, int Y, int Z, int periodic_bits,        \
      int has_nothing, lbm::CollParams p) {                                                     \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                      \
    if (z >= Z) return;                                                                       \
    float ux, uy, uz;                                                                         \
    lbm::ab_site<WELL, WELL ? lbm::EQ_WELL : lbm::EQ_DYN, false, C>(                          \
        f, fout, map, rho, u, blockIdx.z, blockIdx.y, z, gridDim.z, Y, Z, periodic_bits, p,   \
        ux, uy, uz);                                                                          \
  }                                                                                           \
  extern "C" __global__ void __launch_bounds__(lbm::COLL_THREADS) aa_even_##TAG##_kernel(    \
      const float* __restrict__ f, float* __restrict__ fout, const uint8_t* __restrict__ map, \
      float* __restrict__ rho, float* __restrict__ u, int Y, int Z, int periodic_bits,        \
      int has_nothing, lbm::CollParams p) {                                                     \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                      \
    if (z >= Z) return;                                                                       \
    const int64_t N = (int64_t)gridDim.z * Y * Z;                                             \
    const int64_t site = ((int64_t)blockIdx.z * Y + blockIdx.y) * Z + z;                      \
    float ux, uy, uz;                                                                         \
    lbm::aa_even_site<WELL, WELL ? lbm::EQ_WELL : lbm::EQ_DYN, false, C>(                     \
        fout, map, rho, u, site, N, p, ux, uy, uz);                                           \
  }                                                                                           \
  extern "C" __global__ void __launch_bounds__(lbm::COLL_THREADS) aa_odd_##TAG##_kernel(     \
      const float* __restrict__ f, float* __restrict__ fout, const uint8_t* __restrict__ map, \
      float* __restrict__ rho, float* __restrict__ u, int Y, int Z, int periodic_bits,        \
      int has_nothing, lbm::CollParams p) {                                                     \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                      \
    if (z >= Z) return;                                                                       \
    float ux, uy, uz;                                                                         \
    lbm::aa_odd_site<WELL, WELL ? lbm::EQ_WELL : lbm::EQ_DYN, false, false, C>(               \
        f, fout, map, rho, u, blockIdx.z, blockIdx.y, z, gridDim.z, Y, Z, periodic_bits,      \
        has_nothing != 0, p, ux, uy, uz);                                                     \
  }

namespace lbm {

// Launch pattern (0 A-B, 1 even, 2 odd) of collision `coll` from a family's
// table on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown pattern, collision or equilibrium
// kind.  pbits (periodic axes): bit 0 x, bit 1 y, bit 2 z.
inline int launch_coll(const CollKernel (*table)[3], int ncoll, int pattern, int coll, int eq,
                       int kbc, const float* f, float* fout, const uint8_t* map, float* rho,
                       float* u, int X, int Y, int Z, int pbits, int has_nothing, float nu,
                       float fx, float fy, float fz, float uin_x, float uin_y, float uin_z,
                       int neumaier, void* stream) {
  if (pattern < 0 || pattern > 2 || coll < 0 || coll >= ncoll || eq < EQ_QUAD ||
      eq > EQ_ENTROPIC || fout == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const CollParams p{{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier},
                     nu, eq, kbc};
  const int block = Z >= COLL_THREADS ? COLL_THREADS : ((Z + 31) / 32) * 32;
  const dim3 grid((Z + block - 1) / block, Y, X);
  table[coll][pattern]<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      f, fout, map, rho, u, Y, Z, pbits, has_nothing, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lbm

// The C entry of a family: NAME(pattern, coll, eq, kbc, f, fout, map, rho,
// u, X, Y, Z, pbits, has_nothing, nu, fx, fy, fz, uin_x, uin_y, uin_z,
// neumaier, stream) over TABLE, whose rows are the family's collisions.
#define COLL_ENTRY(NAME, TABLE)                                                                \
  extern "C" int NAME(int pattern, int coll, int eq, int kbc, const float* f, float* fout,    \
                      const uint8_t* map, float* rho, float* u, int X, int Y, int Z, int pbits, \
                      int has_nothing, float nu, float fx, float fy, float fz, float uin_x,    \
                      float uin_y, float uin_z, int neumaier, void* stream) {                  \
    return lbm::launch_coll(TABLE, sizeof(TABLE) / sizeof(TABLE[0]), pattern, coll, eq, kbc,   \
                            f, fout, map, rho, u, X, Y, Z, pbits, has_nothing, nu, fx, fy, fz, \
                            uin_x, uin_y, uin_z, neumaier, stream);                            \
  }
