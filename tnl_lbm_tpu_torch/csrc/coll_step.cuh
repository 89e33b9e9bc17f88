// The per-step kernels' instances of the collisions of collisions.cuh: the
// A-B step (B4, ab_step.cu's site update ab_site), the A-A even step (B2,
// aa_even_site) and the A-A odd step (B3, aa_odd_site), one thread per
// site, each with the full boundary set of its pattern, in two modes: the
// step, and the step with a per-site force (force_field, the hooked
// pipeline's third phase: the field plus the homogeneous force at every
// site, lbm_site.cuh site_params).  Included by one source per collision
// family (coll_srt.cu, coll_clbm.cu, coll_kbc.cu), so that the families
// compile in parallel.
//
// Replaces, beside ab_step.cu, aa_even.cu and aa_odd.cu, the same Pallas
// kernels: tnl_lbm_tpu/kernels/fused.py make_fused_step (pallas_call at
// :585) and fused_aa.py make_fused_step_aa (even :408, odd :287), whose
// bodies call the config's collision (fused.py:355), with the force tile as
// its force under force_field (fused.py:351-355).  The equilibrium kind of
// the boundary sites (INFLOW, OUTFLOW_EQ, OUTFLOW_RIGHT_INTERP) is a
// run-time argument (CollParams::eq, lbm_site.cuh EQ_DYN) on total DFs; the
// well-conditioned collisions take the well equilibrium.  KBC's variant is
// a run-time argument (CollParams::kbc).
//
// Bound: HBM bytes, as ab_step.cu's: 233 B/site and step (27 f32 in and
// out, the map, rho and u; 245 B with the field), KBC's too: a FLUID site
// issues 344-587 FP32 slots under the other collisions and 649-902 under
// KBC's variants (tests/collision_site_ops.py), at most 0.45 ms of FP32
// issue at 256^3 on an H100 (132 SMs, 1 980 MHz) against 1.17 ms of bytes
// at 3.35 TB/s.  threadIdx.x runs along z; no shared memory.

#pragma once

#include <cuda_runtime.h>

#include "collisions.cuh"
#include "lbm_site.cuh"

namespace lbm {

// threads per block, along z
constexpr int COLL_THREADS = 128;

// One signature for the three patterns.  A-B and odd: f -> fout; even: in
// place on fout (f unused).  The force_field kernels take the field last.
using CollKernel = void (*)(const float*, float*, const uint8_t*, float*, float*, int, int, int,
                            int, CollParams);
using CollFFKernel = void (*)(const float*, float*, const uint8_t*, float*, float*, int, int,
                              int, int, CollParams, const float*);

// A family's row for one collision: its A-B, even and odd kernels, the
// step's and the force_field ones.
struct CollRow {
  CollKernel step[3];
  CollFFKernel ff[3];
};

}  // namespace lbm

// The site update of pattern PAT (ab, even, odd) with per-site force FF, the
// kernel's body after its z check; FIELD is the force pointer (nullptr or ff).
#define COLL_BODY_ab(C, WELL, FF, FIELD)                                                      \
  float ux, uy, uz;                                                                           \
  lbm::ab_site<WELL, WELL ? lbm::EQ_WELL : lbm::EQ_DYN, FF, C>(                               \
      f, fout, map, rho, u, blockIdx.z, blockIdx.y, z, gridDim.z, Y, Z, periodic_bits, p, ux,  \
      uy, uz, FIELD);
#define COLL_BODY_even(C, WELL, FF, FIELD)                                                    \
  const int64_t N = (int64_t)gridDim.z * Y * Z;                                               \
  const int64_t site = ((int64_t)blockIdx.z * Y + blockIdx.y) * Z + z;                        \
  float ux, uy, uz;                                                                           \
  lbm::aa_even_site<WELL, WELL ? lbm::EQ_WELL : lbm::EQ_DYN, FF, C>(fout, map, rho, u, site,  \
                                                                    N, p, ux, uy, uz, FIELD);
#define COLL_BODY_odd(C, WELL, FF, FIELD)                                                     \
  float ux, uy, uz;                                                                           \
  lbm::aa_odd_site<WELL, WELL ? lbm::EQ_WELL : lbm::EQ_DYN, false, FF, C>(                    \
      f, fout, map, rho, u, blockIdx.z, blockIdx.y, z, gridDim.z, Y, Z, periodic_bits,        \
      has_nothing != 0, p, ux, uy, uz, FIELD);

#define COLL_PARAMS                                                                           \
  const float* __restrict__ f, float* __restrict__ fout, const uint8_t* __restrict__ map,     \
      float* __restrict__ rho, float* __restrict__ u, int Y, int Z, int periodic_bits,        \
      int has_nothing, lbm::CollParams p

// The A-B, even and odd kernels of collision C on storage WELL, the step's
// and the force_field ones, named ab_step_<TAG>_kernel, aa_even_<TAG>_kernel,
// aa_odd_<TAG>_kernel and ab_step_<TAG>_ff_kernel, ... so that the -Xptxas
// -v report reads per instance.
#define COLL_KERNEL(NAME, PAT, C, WELL)                                                       \
  extern "C" __global__ void __launch_bounds__(lbm::COLL_THREADS) NAME##_kernel(COLL_PARAMS) { \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                      \
    if (z >= Z) return;                                                                       \
    COLL_BODY_##PAT(C, WELL, false, nullptr)                                                  \
  }                                                                                           \
  extern "C" __global__ void __launch_bounds__(lbm::COLL_THREADS)                            \
      NAME##_ff_kernel(COLL_PARAMS, const float* __restrict__ ff) {                           \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                      \
    if (z >= Z) return;                                                                       \
    COLL_BODY_##PAT(C, WELL, true, ff)                                                        \
  }
#define COLL_KERNELS(TAG, C, WELL)                                                            \
  COLL_KERNEL(ab_step_##TAG, ab, C, WELL)                                                     \
  COLL_KERNEL(aa_even_##TAG, even, C, WELL)                                                   \
  COLL_KERNEL(aa_odd_##TAG, odd, C, WELL)

// The CollRow of COLL_KERNELS(TAG, ...).
#define COLL_ROW(TAG)                                                                         \
  {                                                                                           \
    {ab_step_##TAG##_kernel, aa_even_##TAG##_kernel, aa_odd_##TAG##_kernel}, {               \
      ab_step_##TAG##_ff_kernel, aa_even_##TAG##_ff_kernel, aa_odd_##TAG##_ff_kernel          \
    }                                                                                         \
  }

namespace lbm {

// Launch pattern (0 A-B, 1 even, 2 odd) of collision `coll` from a family's
// table on `stream`, in mode 0 (the step) or 1 (force_field: ff, the
// per-site force [3, X, Y, Z]); returns cudaGetLastError() of the launch,
// or cudaErrorInvalidValue for an unknown pattern, mode, collision or
// equilibrium kind.  pbits (periodic axes): bit 0 x, bit 1 y, bit 2 z.
inline int launch_coll(const CollRow* table, int ncoll, int pattern, int mode, int coll, int eq,
                       int kbc, const float* f, float* fout, const uint8_t* map, const float* ff,
                       float* rho, float* u, int X, int Y, int Z, int pbits, int has_nothing,
                       float nu, float fx, float fy, float fz, float uin_x, float uin_y,
                       float uin_z, int neumaier, void* stream) {
  if (pattern < 0 || pattern > 2 || mode < 0 || mode > 1 || (mode == 1) != (ff != nullptr) ||
      coll < 0 || coll >= ncoll || eq < EQ_QUAD || eq > EQ_ENTROPIC || fout == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const CollParams p{{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier},
                     nu, eq, kbc};
  const int block = Z >= COLL_THREADS ? COLL_THREADS : ((Z + 31) / 32) * 32;
  const dim3 grid((Z + block - 1) / block, Y, X);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    table[coll].step[pattern]<<<grid, block, 0, s>>>(f, fout, map, rho, u, Y, Z, pbits,
                                                      has_nothing, p);
  else
    table[coll].ff[pattern]<<<grid, block, 0, s>>>(f, fout, map, rho, u, Y, Z, pbits,
                                                    has_nothing, p, ff);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lbm

// The C entry of a family: NAME(pattern, mode, coll, eq, kbc, f, fout, map,
// ff, rho, u, X, Y, Z, pbits, has_nothing, nu, fx, fy, fz, uin_x, uin_y,
// uin_z, neumaier, stream) over TABLE, whose rows are the family's
// collisions.
#define COLL_ENTRY(NAME, TABLE)                                                                \
  extern "C" int NAME(int pattern, int mode, int coll, int eq, int kbc, const float* f,       \
                      float* fout, const uint8_t* map, const float* ff, float* rho, float* u,   \
                      int X, int Y, int Z, int pbits, int has_nothing, float nu, float fx,      \
                      float fy, float fz, float uin_x, float uin_y, float uin_z, int neumaier,  \
                      void* stream) {                                                          \
    return lbm::launch_coll(TABLE, sizeof(TABLE) / sizeof(TABLE[0]), pattern, mode, coll, eq,  \
                            kbc, f, fout, map, ff, rho, u, X, Y, Z, pbits, has_nothing, nu,    \
                            fx, fy, fz, uin_x, uin_y, uin_z, neumaier, stream);                \
  }
