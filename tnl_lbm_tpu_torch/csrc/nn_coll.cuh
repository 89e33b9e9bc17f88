// B10's instances of the collisions of collisions.cuh (the cumulant ones are
// nn_step.cu's): the march of nn_step.cu (nn_step_block, included here
// without its instances and entries) with the collision C, the equilibrium
// kind of the boundary sites read at run time (CollParams::eq, EQ_DYN; the
// well-conditioned collisions take the well equilibrium) and KBC's variant
// bits (CollParams::kbc).  Included by one source per collision family
// (nn_coll_srt.cu, nn_coll_clbm.cu, nn_coll_kbc.cu), so that the families
// compile in parallel.
//
// Replaces, beside nn_step.cu's cumulant instances, the same Pallas kernel:
// tnl_lbm_tpu/kernels/fused_nn_step.py make_fused_nn_step (pallas_call
// :522), whose body calls the config's collision with the body force plus
// the NN force (:477-484); the site update here hands the collision the same
// total force.  The geometry and shared memory are nn_step.cu's (16 x 32
// column tiles, 130 480 B, one block of 512 threads an SM: 128 registers a
// thread at most, so the longer collisions spill; the ptxas report,
// PERF.md).
//
// Bound: HBM bytes, 233 B/site (nn_step.cu's).

#pragma once

#include "collisions.cuh"

#define NN_STEP_MARCH_ONLY
#include "nn_step.cu"
#undef NN_STEP_MARCH_ONLY

// The A-B, even and odd kernels of collision C on storage WELL (the
// well-conditioned equilibrium, else the kind read at run time from
// CollParams::eq), named nn_step_{ab,even,odd}_<TAG>_kernel so that the
// -Xptxas -v report reads per instance.
#define NN_COLL_KERNEL(TAG, MODE_NAME, MODE, C, WELL)                                         \
  extern "C" __global__ void __launch_bounds__(nn::THREADS, nn::STEP_BLOCKS_PER_SM)          \
      nn_step_##MODE_NAME##_##TAG##_kernel(                                                   \
          const float* __restrict__ f, float* __restrict__ fout,                              \
          const uint8_t* __restrict__ map, float* __restrict__ rho, float* __restrict__ u,    \
          int X, int Y, int Z, int seg_len, NNStepParamsT<CollParams> P) {                    \
    nn_step_block<WELL, WELL ? EQ_WELL : EQ_DYN, MODE, C>(f, fout, map, rho, u, X, Y, Z,      \
                                                          seg_len, P);                        \
  }
#define NN_COLL_KERNELS(TAG, C, WELL)                                                         \
  NN_COLL_KERNEL(TAG, ab, MODE_AB, C, WELL)                                                   \
  NN_COLL_KERNEL(TAG, even, MODE_EVEN, C, WELL)                                               \
  NN_COLL_KERNEL(TAG, odd, MODE_ODD, C, WELL)

using NNCollKernel = void (*)(const float*, float*, const uint8_t*, float*, float*, int, int,
                              int, int, NNStepParamsT<CollParams>);

// A family's row for one collision: its A-B, even and odd kernels.
struct NNCollRow {
  NNCollKernel mode[3];
};
#define NN_COLL_ROW(TAG)                                                                      \
  {                                                                                           \
    { nn_step_ab_##TAG##_kernel, nn_step_even_##TAG##_kernel, nn_step_odd_##TAG##_kernel }    \
  }

// Launch mode (0 A-B, 1 A-A even, 2 A-A odd; fout a second buffer in
// every mode) of collision `coll` from a family's table on `stream`, as
// tnl_lbm_nn_step launches its variants; returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for an unknown mode, collision,
// equilibrium kind or model.
inline int launch_nn_coll(const NNCollRow* table, int ncoll, int mode, int coll, int eq, int kbc,
                          const float* f, float* fout, const uint8_t* map, float* rho, float* u,
                          int X, int Y, int Z, int pbits, int nn_bits, int has_nothing, float nu,
                          float fx, float fy, float fz, float uin_x, float uin_y, float uin_z,
                          int neumaier, int model, float nu0_minus_nu, float lam, float a,
                          float expo, float k0, float k1, void* stream) {
  if (mode < 0 || mode > 2 || coll < 0 || coll >= ncoll || eq < EQ_QUAD || eq > EQ_ENTROPIC ||
      (model != nn::CARREAU_YASUDA && model != nn::CASSON))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Y > 65535 || Z > 65535) return static_cast<int>(cudaErrorInvalidValue);  // y << 16 | z
  const NNCollKernel kernel = table[coll].mode[mode];
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nn::STEP_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const NNStepParamsT<CollParams> P{
      {{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier}, nu, eq, kbc},
      {model, nu, nu0_minus_nu, lam, a, expo, k0, k1},
      pbits,
      nn_bits,
      has_nothing};
  const nn::Launch l = nn::launch(X, Y, Z, nn::STEP_BLOCKS_PER_SM);
  kernel<<<l.blocks, nn::THREADS, nn::STEP_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      f, fout, map, rho, u, X, Y, Z, l.seg_len, P);
  return static_cast<int>(cudaGetLastError());
}

// The C entry of a family: NAME(mode, coll, eq, kbc, f, fout, map, rho, u,
// X, Y, Z, pbits, nn_bits, has_nothing, nu, fx, fy, fz, uin_x, uin_y,
// uin_z, neumaier, model, nu0_minus_nu, lam, a, expo, k0, k1, stream) over
// TABLE, whose rows are the family's collisions (the arguments after kbc
// as tnl_lbm_nn_step's).
#define NN_COLL_ENTRY(NAME, TABLE)                                                             \
  extern "C" int NAME(int mode, int coll, int eq, int kbc, const float* f, float* fout,        \
                      const uint8_t* map, float* rho, float* u, int X, int Y, int Z, int pbits, \
                      int nn_bits, int has_nothing, float nu, float fx, float fy, float fz,     \
                      float uin_x, float uin_y, float uin_z, int neumaier, int model,           \
                      float nu0_minus_nu, float lam, float a, float expo, float k0, float k1,   \
                      void* stream) {                                                          \
    return launch_nn_coll(TABLE, sizeof(TABLE) / sizeof(TABLE[0]), mode, coll, eq, kbc, f,     \
                          fout, map, rho, u, X, Y, Z, pbits, nn_bits, has_nothing, nu, fx, fy, \
                          fz, uin_x, uin_y, uin_z, neumaier, model, nu0_minus_nu, lam, a,      \
                          expo, k0, k1, stream);                                               \
  }
