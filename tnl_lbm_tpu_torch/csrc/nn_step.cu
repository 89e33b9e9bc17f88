// One-kernel non-Newtonian LBM step for D3Q27 in float32 (B10): the u*
// pass, the strain rate, the rheology, the NN force and the full site
// update in one launch, one kernel per mode (A-B, A-A even, A-A odd).
//
// Replaces the Pallas kernel of tnl_lbm_tpu/kernels/fused_nn_step.py
// make_fused_nn_step (build_call :188, pallas_call :522), which collapses
// the reference's three kernels of a hooked step
// (cudaLBMComputeVelocitiesStarAndZeroForce, cudaLBMKernelStress with the
// forcing pass, the main kernel; kernels.h:178-218, nonNewtonian.h:216-391).
// Its plain version is the plain hooked step (sim/step.py with
// ops/non_newtonian.py make_nn_forcing_hook).  A block owns a TX x TY x TZ
// tile of sites, z fastest:
//
// 1. u* on the tile and a 2-site ring, in shared memory (nn_site.cuh's
//    tile, shared with B9): each slot's global coordinate is wrapped or
//    clamped under the hook's periodicity (nn_bits) - the value at an
//    out-of-domain slot is the u* of the clamped site, never a pull at an
//    outside coordinate - and that site's DFs are read with the mode's rule
//    under the domain's periodicity (pbits: the A-B pull, the even step's
//    own DFs, the odd step's opposite pull, with the outflow pull rules),
//    transformed (WALL swap, symmetry mirrors) and summed with the
//    homogeneous force (lbm_site.cuh ab_pull, aa_odd_pull, macro_site's
//    moments).  The fluid mask (map == FLUID) of each slot and rho0 of the
//    tile sites go to shared memory too.
// 2. S on the tile and a 1-site ring (nn_site.cuh tile_strain).
// 3. Per tile site: F_nn = 2 (nu_eff - nu) rho0 div S on FLUID sites
//    (nn_site.cuh tile_force); the site update of the mode then runs with
//    the total force F + F_nn, as the plain step's second moments and
//    collision do: lbm_site.cuh ab_site (A-B), the even update out of place
//    (A-B's site update, written to the opposite slots of a second buffer:
//    an in-place even step would race with the ring reads of the
//    neighbouring blocks), aa_odd_site (A-A odd: each thread collides its
//    own site with its own force and pushes; the JAX kernel's collision ring
//    is a TPU tiling artefact, not ported).  NOTHING sites keep their DFs,
//    WALL and NOTHING report rho = 1, u = 0.
//
// Tile: 4 x 8 x 32 sites with 256 threads (4 sites a thread in stage 3);
// 97 984 B of shared memory, two blocks per SM; the site update's registers
// (72-80 in B4) fit the 128 that two blocks of 256 threads leave.  The
// stage-1 pulls are amplified by (TX+4)(TY+4)(TZ+4) / (TX TY TZ) = 3.375
// before L2 serves the rings that neighbouring blocks share; stage 3
// re-reads the tile's DFs, mostly from L2.
//
// Bound: HBM bytes.  Per site the step must read 27 f32 and the map and
// write 27 f32 and rho and u: 233 B/site, the A-B step's.  The 2-ring reads
// are what a simple tile pays above it.

#include <cuda_runtime.h>

#include <cstdint>

#include "lbm_site.cuh"
#include "nn_site.cuh"

using namespace lbm;

constexpr int MODE_AB = 0;
constexpr int MODE_EVEN = 1;
constexpr int MODE_ODD = 2;

struct NNStepParams {
  ABParams p;        // omega, homogeneous force, inflow, neumaier
  nn::Rheology r;    // the hook's model at the lattice viscosity
  int pbits;         // the domain's periodic axes (the DF reads)
  int nn_bits;       // the hook's periodic axes (the stencils)
  int has_nothing;   // a NOTHING site is present (the odd push drops onto it)
};

template <bool WELL, int EQ, int MODE>
__device__ __forceinline__ void nn_step_block(const float* __restrict__ f,
                                              float* __restrict__ fout,
                                              const uint8_t* __restrict__ map,
                                              float* __restrict__ rho_out,
                                              float* __restrict__ u_out, int X, int Y, int Z,
                                              const NNStepParams& P) {
  extern __shared__ float smem[];
  const nn::Tile t = nn::tile(smem, X, Y, Z, P.nn_bits);
  const int64_t N = (int64_t)X * Y * Z;

  // 1. u* on the tile + 2 ring, at the canonical coordinates
  for (int i = threadIdx.x; i < nn::NU_SLOTS; i += blockDim.x) {
    int c[3], j;
    nn::u_slot(t, i, c, j);
    const int x = c[0], y = c[1], z = c[2];
    const int64_t site = ((int64_t)x * Y + y) * Z + z;
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
    t.u[i] = ux;
    t.u[nn::NU_SLOTS + i] = uy;
    t.u[2 * nn::NU_SLOTS + i] = uz;
    t.fluid[i] = m == GEO_FLUID;
    if (j >= 0) t.rho[j] = r;
  }
  __syncthreads();
  // 2. S on the tile + 1 ring
  nn::tile_strain(t);
  __syncthreads();

  // 3. the NN force and the site update of the mode, per tile site
  for (int j = threadIdx.x; j < nn::NT; j += blockDim.x) {
    int c[3];
    if (!nn::tile_site(t, j, c)) continue;
    const int x = c[0], y = c[1], z = c[2];
    float F[3];
    nn::tile_force(t, P.r, j, t.rho[j], F);
    ABParams ps = P.p;
    ps.fx = P.p.fx + F[0];
    ps.fy = P.p.fy + F[1];
    ps.fz = P.p.fz + F[2];
    float ux, uy, uz;
    if constexpr (MODE == MODE_AB) {
      ab_site<WELL, EQ>(f, fout, map, rho_out, u_out, x, y, z, X, Y, Z, P.pbits, ps, ux, uy,
                        uz);
    } else if constexpr (MODE == MODE_ODD) {
      aa_odd_site<WELL, EQ, false>(f, fout, map, rho_out, u_out, x, y, z, X, Y, Z, P.pbits,
                                   P.has_nothing != 0, ps, ux, uy, uz);
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
        site_collide<WELL, EQ>(v, m, ps, r, ux, uy, uz);
#pragma unroll
        for (int q = 0; q < Q; ++q) fout[q * N + site] = v[opp(q)];
      }
      rho_out[site] = r;
      u_out[site] = ux;
      u_out[N + site] = uy;
      u_out[2 * N + site] = uz;
    }
  }
}

// One kernel per (collision, equilibrium kind, mode), named so that the
// -Xptxas -v report can be read per instance.
#define NN_STEP_KERNEL(NAME, WELL, EQ, MODE)                                                  \
  extern "C" __global__ void __launch_bounds__(nn::TILE_THREADS, 2)                          \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                             \
           const uint8_t* __restrict__ map, float* __restrict__ rho, float* __restrict__ u,   \
           int X, int Y, int Z, NNStepParams P) {                                             \
    nn_step_block<WELL, EQ, MODE>(f, fout, map, rho, u, X, Y, Z, P);                          \
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
                          NNStepParams);
  static const Kernel kernels[3][3] = {
      {nn_step_ab_cum_well_kernel, nn_step_ab_cum_quad_kernel, nn_step_ab_cum_invcum_kernel},
      {nn_step_even_cum_well_kernel, nn_step_even_cum_quad_kernel,
       nn_step_even_cum_invcum_kernel},
      {nn_step_odd_cum_well_kernel, nn_step_odd_cum_quad_kernel, nn_step_odd_cum_invcum_kernel}};
  if (variant < 0 || variant > 2 || mode < 0 || mode > 2 ||
      (model != nn::CARREAU_YASUDA && model != nn::CASSON))
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kernel = kernels[mode][variant];
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nn::TILE_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const NNStepParams P{{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier},
                       {model, nu, nu0_minus_nu, lam, a, expo, k0, k1},
                       pbits,
                       nn_bits,
                       has_nothing};
  const dim3 grid((Z + nn::TZ - 1) / nn::TZ, (Y + nn::TY - 1) / nn::TY, (X + nn::TX - 1) / nn::TX);
  kernel<<<grid, nn::TILE_THREADS, nn::TILE_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      f, fout, map, rho, u, X, Y, Z, P);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of one block of B9 and B10, for the record.
extern "C" int tnl_lbm_nn_step_smem_bytes() { return nn::TILE_SMEM_BYTES; }
