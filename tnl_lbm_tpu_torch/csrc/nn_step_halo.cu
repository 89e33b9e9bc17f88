// B10 halo: the one-kernel non-Newtonian step (nn_step.cu) on a shard's
// haloed block, in float32, one kernel per mode (A-B, A-A even, A-A odd) and
// cumulant variant.
//
// Replaces the Pallas kernel of tnl_lbm_tpu/kernels/fused_nn_step.py
// make_fused_nn_step with prepadded=True and local_shape (prepadded :145-161,
// pallas_call :522; the sharded NN step, tnl_lbm_tpu/parallel/sharded.py
// make_sharded_fused_nn_step :674-767).  The JAX step exchanges f and the map
// 4 wide in x and 8 wide in y, the depth of its TPU windows; this kernel
// reads what its stencil chain reaches and no more:
//
//   - A-B: F at the block's sites needs S one site beyond them, S needs u*
//     two beyond, u* pulls f three beyond: f and the map have a 3-wide x/y
//     halo (the map is read at the u* sites, two beyond);
//   - even: u* reads the site's own DFs: a 2-wide halo;
//   - odd: the block's sites are pushed to by the 1-site ring around them
//     (the neighbour shards' edge sites, collided again here with their own
//     NN force, as B3 halo does), so F is needed one beyond the block, S two
//     beyond, u* three and f four: a 4-wide halo.
//
// The march (nn_step.cu nn_step_block with HALO, over nn_site.cuh's haloed
// mode) runs over a region of block coordinates: the block, and for the
// odd mode its ring on every seam face.  Coordinates read from the halo,
// except on a closed face (a non-periodic face of the domain, gbits; the
// stencil wraps as the domain does, which the route requires,
// fused_nn_step.supports), where they clamp to the edge as the unsharded
// kernel's do.  The u* reads are ab_halo_pull and aa_odd_halo_pull
// (lbm_site.cuh), the site updates ab_halo_site (A-B), the even update out
// of place, and aa_odd_halo_site (odd: ring sites push into the block only,
// a ring site on a closed face not at all).  The site updates and the
// arithmetic are the unsharded kernel's, so a block's sites equal the
// unsharded step's bit for bit when the halo holds the neighbour shards'
// layers.  A homogeneous body force only, as in JAX.
//
// Bound: HBM bytes, 233 B a site as the unsharded step's, plus the halo's
// distinct reads (chip_smoke.py).  Geometry and shared memory are nn_step.cu's.

#include <cuda_runtime.h>

#include <cstdint>

#define NN_STEP_MARCH_ONLY
#include "nn_step.cu"
#undef NN_STEP_MARCH_ONLY

#define NN_STEP_HALO_KERNEL(NAME, WELL, EQ, MODE)                                             \
  extern "C" __global__ void __launch_bounds__(nn::THREADS, nn::STEP_BLOCKS_PER_SM)          \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                             \
           const uint8_t* __restrict__ map, float* __restrict__ rho, float* __restrict__ u,   \
           int RX, int RY, int Z, int seg_len, NNStepParams P, nn::Halo h) {                  \
    nn_step_block<WELL, EQ, MODE, Cum<WELL>, ABParams, true>(f, fout, map, rho, u, RX, RY, Z,  \
                                                             seg_len, P, h);                  \
  }

NN_STEP_HALO_KERNEL(nn_step_halo_ab_cum_well_kernel, true, EQ_WELL, MODE_AB)
NN_STEP_HALO_KERNEL(nn_step_halo_ab_cum_quad_kernel, false, EQ_QUAD, MODE_AB)
NN_STEP_HALO_KERNEL(nn_step_halo_ab_cum_invcum_kernel, false, EQ_INVCUM, MODE_AB)
NN_STEP_HALO_KERNEL(nn_step_halo_even_cum_well_kernel, true, EQ_WELL, MODE_EVEN)
NN_STEP_HALO_KERNEL(nn_step_halo_even_cum_quad_kernel, false, EQ_QUAD, MODE_EVEN)
NN_STEP_HALO_KERNEL(nn_step_halo_even_cum_invcum_kernel, false, EQ_INVCUM, MODE_EVEN)
NN_STEP_HALO_KERNEL(nn_step_halo_odd_cum_well_kernel, true, EQ_WELL, MODE_ODD)
NN_STEP_HALO_KERNEL(nn_step_halo_odd_cum_quad_kernel, false, EQ_QUAD, MODE_ODD)
NN_STEP_HALO_KERNEL(nn_step_halo_odd_cum_invcum_kernel, false, EQ_INVCUM, MODE_ODD)

// Launches B10 halo on `stream` over a shard's block of X x Y x Z sites: f
// and the map the block with the mode's H-wide x/y halo (3 A-B, 2 even, 4
// odd: nn_step.cu NN_HALO_*), fout [27, X, Y, Z], rho and u the block.
// gbits: the block's closed faces (bit 0 low x, 1 high x, 2 low y, 3 high
// y), faces of the non-periodic domain; pbits and nn_bits as
// tnl_lbm_nn_step's (their z bits are read: x and y come from the halo);
// the rest as tnl_lbm_nn_step.  Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown variant, mode or model.
extern "C" int tnl_lbm_nn_step_halo(const float* f, float* fout, const uint8_t* map, float* rho,
                                    float* u, int X, int Y, int Z, int pbits, int nn_bits,
                                    int gbits, int has_nothing, int variant, int mode, float nu,
                                    float fx, float fy, float fz, float uin_x, float uin_y,
                                    float uin_z, int neumaier, int model, float nu0_minus_nu,
                                    float lam, float a, float expo, float k0, float k1,
                                    void* stream) {
  using Kernel = void (*)(const float*, float*, const uint8_t*, float*, float*, int, int, int,
                          int, NNStepParams, nn::Halo);
  static const Kernel kernels[3][3] = {
      {nn_step_halo_ab_cum_well_kernel, nn_step_halo_ab_cum_quad_kernel,
       nn_step_halo_ab_cum_invcum_kernel},
      {nn_step_halo_even_cum_well_kernel, nn_step_halo_even_cum_quad_kernel,
       nn_step_halo_even_cum_invcum_kernel},
      {nn_step_halo_odd_cum_well_kernel, nn_step_halo_odd_cum_quad_kernel,
       nn_step_halo_odd_cum_invcum_kernel}};
  if (variant < 0 || variant > 2 || mode < 0 || mode > 2 ||
      (model != nn::CARREAU_YASUDA && model != nn::CASSON))
    return static_cast<int>(cudaErrorInvalidValue);
  const int H = mode == MODE_AB ? NN_HALO_AB : (mode == MODE_EVEN ? NN_HALO_EVEN : NN_HALO_ODD);
  if (Y + 2 * H > 65535 || Z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // the region: the block, and on the odd mode its ring on every seam face
  const int ring = mode == MODE_ODD ? 1 : 0;
  const int lo_x = (gbits & 1) ? 0 : ring, hi_x = (gbits & 2) ? 0 : ring;
  const int lo_y = (gbits & 4) ? 0 : ring, hi_y = (gbits & 8) ? 0 : ring;
  const int RX = X + lo_x + hi_x, RY = Y + lo_y + hi_y;
  // a u* slot reads one site beyond it where u* pulls (A-B, odd)
  const nn::Halo h{H, mode == MODE_EVEN ? H : H - 1, -lo_x, -lo_y, X, Y, gbits};
  const Kernel kernel = kernels[mode][variant];
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nn::STEP_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const NNStepParams P{{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier},
                       {model, nu, nu0_minus_nu, lam, a, expo, k0, k1},
                       pbits,
                       nn_bits,
                       has_nothing};
  const nn::Launch l = nn::launch(RX, RY, Z, nn::STEP_BLOCKS_PER_SM);
  kernel<<<l.blocks, nn::THREADS, nn::STEP_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      f, fout, map, rho, u, RX, RY, Z, l.seg_len, P, h);
  return static_cast<int>(cudaGetLastError());
}
