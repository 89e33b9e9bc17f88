// One-kernel non-Newtonian LBM step for D3Q27 in float32 (B10): the u*
// pass, the strain rate, the rheology, the NN force and the full site
// update in one launch, one kernel per mode (A-B, A-A even, A-A odd) and
// collision.  This source holds the march (nn_step_block) and its cumulant
// instances; nn_coll_srt.cu, nn_coll_clbm.cu and nn_coll_kbc.cu instantiate
// the march for the other collisions (collisions.cuh) through nn_coll.cuh,
// which includes this source with NN_STEP_MARCH_ONLY defined (the march
// without the instances and entries below it).
//
// Replaces the Pallas kernel of tnl_lbm_tpu/kernels/fused_nn_step.py
// make_fused_nn_step (build_call :188, pallas_call :522), which collapses
// the reference's three kernels of a hooked step
// (cudaLBMComputeVelocitiesStarAndZeroForce, cudaLBMKernelStress with the
// forcing pass, the main kernel; kernels.h:178-218, nonNewtonian.h:216-391).
// Its plain version is the plain hooked step (sim/step.py with
// ops/non_newtonian.py make_nn_forcing_hook).
//
// Design: the x-marching plane pipeline of nn_site.cuh, shared with B9.  A
// block of 512 threads owns a 16 x 32 y-z column tile (z fastest, one
// thread a tile site) and walks an x segment of at most 32 planes; step j
// does three things and ends in one block barrier:
//
// 1. u* of plane j on the tile and its 2-site y-z ring, into the u ring:
//    each slot's coordinate is wrapped or clamped under the hook's
//    periodicity (nn_bits) - the value at an out-of-domain slot is the u*
//    of the clamped site, never a pull at an outside coordinate - and that
//    site's DFs are read with the mode's rule under the domain's
//    periodicity (pbits: the A-B pull, the even step's own DFs, the odd
//    step's opposite pull, with the outflow pull rules), transformed (WALL
//    swap, symmetry mirrors) and summed with the homogeneous force
//    (lbm_site.cuh ab_pull, aa_odd_pull, macro_site's moments).  The fluid
//    mask (map == FLUID) of each slot and rho0 of the tile sites go to
//    their rings too.
// 2. S of plane j - 2 on the tile and its 1-site ring (nn_site.cuh
//    strain_plane).
// 3. Per tile site of plane j - 4: F_nn = 2 (nu_eff - nu) rho0 div S on
//    FLUID sites (nn_site.cuh force_at); the site update of the mode then
//    runs with the total force F + F_nn, as the plain step's second moments
//    and collision do: lbm_site.cuh ab_site (A-B), the even update out of
//    place (A-B's site update, written to the opposite slots of a second
//    buffer: an in-place even step would race with the ring reads of the
//    neighbouring blocks), aa_odd_site (A-A odd: each thread collides its
//    own site with its own force and pushes; the JAX kernel's collision ring
//    is a TPU tiling artefact, not ported).  NOTHING sites keep their DFs,
//    WALL and NOTHING report rho = 1, u = 0.
//
// u* is computed once per slot and plane: 1.41 pulls a site on the 20 x 36
// slots of a plane, and 4 extra planes per segment; the cube tile this
// replaces pulled 3.375 times a site.  The site update pulls the tile
// site's DFs again, four planes after its u* pull read them, mostly from
// L2 (keeping them in shared memory instead leaves room for one block of
// 8 warps per SM, which ran slower: PERF.md).  130 480 B of shared memory
// and 128 registers a thread (the A-B and odd instances spill a few dozen
// bytes): one block of 512 threads per SM.  Where the time goes
// (tests/nn_ablation.py): the u*, S and F parts and the site update add up,
// each about as costly as the pipeline kernel that does the same work
// alone, so the one-kernel step is slower than the pipeline on the A-B and
// odd steps and faster on the even step (PERF.md).
//
// Bound: HBM bytes.  Per site the step must read 27 f32 and the map and
// write 27 f32 and rho and u: 233 B/site, the A-B step's.  The ring's pulls
// and the update's second pull are what the march pays above it, mostly in
// L2.

#include <cuda_runtime.h>

#include <cstdint>

#include "lbm_site.cuh"

#define NN_TY 16  // the column tile: 16 x 32 sites, one thread each
#include "nn_site.cuh"

using namespace lbm;

constexpr int MODE_AB = 0;
constexpr int MODE_EVEN = 1;
constexpr int MODE_ODD = 2;

// PP: the site parameters, ABParams (the cumulant instances below) or
// CollParams (the family instances of nn_coll.cuh).
template <class PP>
struct NNStepParamsT {
  PP p;              // omega, homogeneous force, inflow, neumaier (CollParams: nu, eq, kbc)
  nn::Rheology r;    // the hook's model at the lattice viscosity
  int pbits;         // the domain's periodic axes (the DF reads)
  int nn_bits;       // the hook's periodic axes (the stencils)
  int has_nothing;   // a NOTHING site is present (the odd push drops onto it)
};
using NNStepParams = NNStepParamsT<ABParams>;

// One block's march; C is the collision of the site update (lbm_site.cuh
// site_collide), which takes the total force F + F_nn as its force.
template <bool WELL, int EQ, int MODE, class C = Cum<WELL>, class PP = ABParams>
__device__ __forceinline__ void nn_step_block(const float* __restrict__ f,
                                              float* __restrict__ fout,
                                              const uint8_t* __restrict__ map,
                                              float* __restrict__ rho_out,
                                              float* __restrict__ u_out, int X, int Y, int Z,
                                              int seg_len, const NNStepParamsT<PP>& P) {
  extern __shared__ __align__(16) float smem[];
  const nn::March mr = nn::march(smem, true, X, Y, Z, P.nn_bits, seg_len);
  const int64_t YZ = (int64_t)Y * Z, N = X * YZ;
  const int L = mr.xe - mr.xs;
  for (int j = 0; j < L + nn::F_LAG + 2; ++j) {
    // 1. u* of plane j, at the canonical coordinates
    if (j < L + 4) {
      const int x = nn::plane_x(mr, j);
#pragma unroll 1
      for (int k = 0; k < nn::U_PER_THREAD; ++k) {
        const int i = nn::u_slot_of(threadIdx.x, k);
        if (i >= nn::U_SLOTS) break;
        const int y = mr.uyz[i] >> 16, z = mr.uyz[i] & 0xffff;
        const int64_t site = x * YZ + (int64_t)y * Z + z;
        const uint8_t m = map[site];
        float v[Q];
        if constexpr (MODE == MODE_AB) {
          ab_pull(f, m, x, y, z, X, Y, Z, P.pbits, v);
        } else if constexpr (MODE == MODE_ODD) {
          aa_odd_pull<false>(f, m, x, y, z, X, Y, Z, P.pbits, v);
        } else {
#pragma unroll
          for (int q = 0; q < Q; ++q) v[q] = f[q * N + site];
        }
        pull_transform_ab(v, m);
        float r, ux, uy, uz;
        moments_local<WELL>(v, P.p.fx, P.p.fy, P.p.fz, P.p.neumaier != 0, r, ux, uy, uz);
        nn::put_u(mr, j, i, ux, uy, uz, m == GEO_FLUID);
        const int ts = nn::u_tile_site(i);
        if (ts >= 0) mr.rho[(j % nn::RHO_PLANES) * nn::THREADS + ts] = r;
      }
    }
    // 2. S of plane j - 2
    const int q = j - nn::S_LAG;
    if (q >= 1 && q <= L + 2) nn::strain_plane(mr, q);
    // 3. the NN force and the site update of the mode at plane j - 4
    const int p = j - nn::F_LAG;
    int ly, lz;
    if (p >= 2 && p <= L + 1 && nn::tile_site(mr, ly, lz)) {
      const int x = mr.xs + p - 2, y = mr.y0 + ly, z = mr.z0 + lz;
      float F[3];
      nn::force_at(mr, P.r, p, x, ly, lz, mr.rho[(p % nn::RHO_PLANES) * nn::THREADS + threadIdx.x],
                   F);
      PP ps = P.p;
      ps.fx = P.p.fx + F[0];
      ps.fy = P.p.fy + F[1];
      ps.fz = P.p.fz + F[2];
      float ux, uy, uz;
      if constexpr (MODE == MODE_AB) {
        ab_site<WELL, EQ, false, C>(f, fout, map, rho_out, u_out, x, y, z, X, Y, Z, P.pbits, ps,
                                    ux, uy, uz);
      } else if constexpr (MODE == MODE_ODD) {
        aa_odd_site<WELL, EQ, false, false, C>(f, fout, map, rho_out, u_out, x, y, z, X, Y, Z,
                                               P.pbits, P.has_nothing != 0, ps, ux, uy, uz);
      } else {
        // the even update out of place: same site, opposite slots
        const int64_t site = ((int64_t)x * Y + y) * Z + z;
        const uint8_t m = map[site];
        float r = 1.0f;
        ux = uy = uz = 0.0f;
        if (m == GEO_NOTHING) {
#pragma unroll
          for (int q = 0; q < Q; ++q) fout[q * N + site] = f[q * N + site];
        } else {
          float v[Q];
#pragma unroll
          for (int q = 0; q < Q; ++q) v[q] = f[q * N + site];
          site_collide<WELL, EQ, C>(v, m, ps, r, ux, uy, uz);
#pragma unroll
          for (int q = 0; q < Q; ++q) fout[q * N + site] = v[opp(q)];
        }
        rho_out[site] = r;
        u_out[site] = ux;
        u_out[N + site] = uy;
        u_out[2 * N + site] = uz;
      }
    }
    __syncthreads();
  }
}

#ifndef NN_STEP_MARCH_ONLY

// One kernel per (collision, equilibrium kind, mode), named so that the
// -Xptxas -v report can be read per instance.
#define NN_STEP_KERNEL(NAME, WELL, EQ, MODE)                                                  \
  extern "C" __global__ void __launch_bounds__(nn::THREADS, nn::STEP_BLOCKS_PER_SM)          \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                             \
           const uint8_t* __restrict__ map, float* __restrict__ rho, float* __restrict__ u,   \
           int X, int Y, int Z, int seg_len, NNStepParams P) {                                \
    nn_step_block<WELL, EQ, MODE>(f, fout, map, rho, u, X, Y, Z, seg_len, P);                 \
  }

NN_STEP_KERNEL(nn_step_ab_cum_well_kernel, true, EQ_WELL, MODE_AB)
NN_STEP_KERNEL(nn_step_ab_cum_quad_kernel, false, EQ_QUAD, MODE_AB)
NN_STEP_KERNEL(nn_step_ab_cum_invcum_kernel, false, EQ_INVCUM, MODE_AB)
NN_STEP_KERNEL(nn_step_even_cum_well_kernel, true, EQ_WELL, MODE_EVEN)
NN_STEP_KERNEL(nn_step_even_cum_quad_kernel, false, EQ_QUAD, MODE_EVEN)
NN_STEP_KERNEL(nn_step_even_cum_invcum_kernel, false, EQ_INVCUM, MODE_EVEN)
NN_STEP_KERNEL(nn_step_odd_cum_well_kernel, true, EQ_WELL, MODE_ODD)
NN_STEP_KERNEL(nn_step_odd_cum_quad_kernel, false, EQ_QUAD, MODE_ODD)
NN_STEP_KERNEL(nn_step_odd_cum_invcum_kernel, false, EQ_INVCUM, MODE_ODD)

// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown variant, mode or model.  mode: 0
// A-B, 1 A-A even, 2 A-A odd (fout: a second buffer in every mode).
// variant as tnl_lbm_ab_step.  pbits: the domain's periodic axes, nn_bits
// the hook's (bit 0 x, bit 1 y, bit 2 z).  model 0 Carreau-Yasuda (nu0 - nu,
// lambda, a, (n - 1) / a), 1 Casson (k0, k1).
extern "C" int tnl_lbm_nn_step(const float* f, float* fout, const uint8_t* map, float* rho,
                               float* u, int X, int Y, int Z, int pbits, int nn_bits,
                               int has_nothing, int variant, int mode, float nu, float fx,
                               float fy, float fz, float uin_x, float uin_y, float uin_z,
                               int neumaier, int model, float nu0_minus_nu, float lam, float a,
                               float expo, float k0, float k1, void* stream) {
  using Kernel = void (*)(const float*, float*, const uint8_t*, float*, float*, int, int, int,
                          int, NNStepParams);
  static const Kernel kernels[3][3] = {
      {nn_step_ab_cum_well_kernel, nn_step_ab_cum_quad_kernel, nn_step_ab_cum_invcum_kernel},
      {nn_step_even_cum_well_kernel, nn_step_even_cum_quad_kernel,
       nn_step_even_cum_invcum_kernel},
      {nn_step_odd_cum_well_kernel, nn_step_odd_cum_quad_kernel, nn_step_odd_cum_invcum_kernel}};
  if (variant < 0 || variant > 2 || mode < 0 || mode > 2 ||
      (model != nn::CARREAU_YASUDA && model != nn::CASSON))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Y > 65535 || Z > 65535) return static_cast<int>(cudaErrorInvalidValue);  // y << 16 | z
  const Kernel kernel = kernels[mode][variant];
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nn::STEP_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const NNStepParams P{{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier},
                       {model, nu, nu0_minus_nu, lam, a, expo, k0, k1},
                       pbits,
                       nn_bits,
                       has_nothing};
  const nn::Launch l = nn::launch(X, Y, Z, nn::STEP_BLOCKS_PER_SM);
  kernel<<<l.blocks, nn::THREADS, nn::STEP_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      f, fout, map, rho, u, X, Y, Z, l.seg_len, P);
  return static_cast<int>(cudaGetLastError());
}

int nn_force_info(int X, int Y, int Z, int* out);  // nn_force.cu

// The launch geometry of B9 (kind 0) or B10 (kind 1) at a shape: out[0]
// dynamic shared memory per block (bytes), [1] TY, [2] TZ, [3] the x
// segment, [4] segments, [5] column tiles, [6] blocks per SM.
extern "C" int tnl_lbm_nn_info(int kind, int X, int Y, int Z, int* out) {
  if (kind == 0) return nn_force_info(X, Y, Z, out);
  if (kind == 1)
    return nn::launch_info(X, Y, Z, nn::STEP_BLOCKS_PER_SM, nn::STEP_SMEM_BYTES, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

#endif  // NN_STEP_MARCH_ONLY
