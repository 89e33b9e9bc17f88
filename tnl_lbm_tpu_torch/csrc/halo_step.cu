// The sharded lattice's step kernels in float32: the A-B step (B4) and the
// A-A odd step (B3) on a shard's haloed block, one thread per site.
//
// Replace the Pallas kernels of tnl_lbm_tpu/kernels/fused.py make_fused_step
// with prepadded=True and local_shape (pallas_call at :585; the sharded A-B
// step, tnl_lbm_tpu/parallel/sharded.py:884-909) and of
// tnl_lbm_tpu/kernels/fused_aa.py _build_odd_call with its map ring and
// boundary flags (odd_kernel, pallas_call at :287; the sharded A-A step,
// sharded.py:1040-1077).  The A-A even step needs no kernel of its own: it
// is same-site, so aa_even.cu runs on each shard's block unchanged.
//
// ab_halo_kernel: f is the block with a 1-wide x/y halo [27, X+2, Y+2, Z];
// fout, the map, rho and u the block [X, Y, Z] (lbm_site.cuh ab_halo_site:
// ab_site's reads and arithmetic with every x/y neighbour in the halo).
// aa_odd_halo_kernel: f is the block with a 2-wide x/y halo [27, X+4, Y+4,
// Z], the map the block with its 1-wide ring [X+2, Y+2, Z]; a thread per
// site of the block and its ring, which collides the neighbour shards' edge
// sites again and pushes into the block only (lbm_site.cuh
// aa_odd_halo_site); gbits says which faces of the block are faces of the
// domain that are not periodic, where the push edge-replicates as the
// unsharded odd step does.  z is never sharded here: it keeps the wrap or
// clamp of the unsharded kernels (pz).
//
// Instances: the cumulant variants of ab_step.cu and aa_odd.cu, the
// collisions the apps' sharded paths run (sim_2: CUM_WELL, the odd step's
// lean instance on its FLUID/WALL/NOTHING duct; sim_1: CUM with eq_inv_cum;
// sim_3: CUM with eq_quadratic).  The float64 A-B instance is in f64_ab.cu.
//
// The hooked pipeline's modes (kernels/hooked.py under a plan; JAX
// make_sharded_fused_step / make_sharded_fused_step_aa with force_field and
// macro_only, sharded.py:847-951, 1055-1077), each of the cumulant variants:
// force_field (ab_halo_ff_*, aa_odd_halo_ff_*) reads a per-site force and
// adds it to the homogeneous one, as ab_step.cu's does: the A-B block's
// [3, X, Y, Z], the odd step's force ring [3, X+2, Y+2, Z] in the map ring's
// layout, so that a ring site collides with the neighbour shard's force (an
// edge-replicated force would diverge from the unsharded push at the seams);
// macro_only (ab_halo_macro_*, aa_odd_halo_macro_*) is the u* pre-pass, a
// thread per site of the block: the read, the WALL and symmetry transforms
// and the moments with the homogeneous force, rho and u written (lbm_site.cuh
// halo_macro_site).  The odd step has no lean force_field instance, as
// aa_odd.cu has none.  Bound: the step's reads plus the force (12 B a thread;
// the ring's too), or the u* pass's 27 values in and rho and u out.
//
// Bound: HBM bytes.  A thread pulls one element of each component, at
// s - c_q, so no two threads read the same one in x and y: the halo gives
// only the components that point into the threads' sites (9 of 27 a face
// site of the A-B halo; 18 on the odd step's inner ring and 9 on its
// outer), and the A-B block's edge sites lose those that leave it.  So the
// A-B kernel reads 108 B a site, as the unsharded step, writes 108 B, and
// moves the map and rho and u (17 B); the odd kernel reads 108 B for each
// of its threads (the block and its ring) and the ring's map, and writes
// the same (chip_smoke.py halo_reads counts it on the map).  The halo
// exchange (tnl_lbm_tpu_torch/parallel/sharded.py) is a copy of its own.  Same design as the unsharded kernels: z along threadIdx.x, so that
// each component's reads and writes are contiguous runs of a warp; the
// cascade in registers, no shared memory.

#include <cuda_runtime.h>

#include "lbm_site.cuh"

using namespace lbm;

// threads per block, along z
constexpr int THREADS = 128;

#define AB_HALO_KERNEL(NAME, WELL, EQ)                                                         \
  extern "C" __global__ void __launch_bounds__(THREADS)                                       \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                              \
           const uint8_t* __restrict__ map, float* __restrict__ rho, float* __restrict__ u,    \
           int Y, int Z, int pz, ABParams p) {                                                 \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                       \
    if (z >= Z) return;                                                                        \
    ab_halo_site<WELL, EQ>(f, fout, map, rho, u, blockIdx.z, blockIdx.y, z, gridDim.z, Y, Z,   \
                           pz != 0, p);                                                        \
  }

#define AA_ODD_HALO_KERNEL(NAME, WELL, EQ, LEAN)                                               \
  extern "C" __global__ void __launch_bounds__(THREADS)                                       \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                              \
           const uint8_t* __restrict__ ring, float* __restrict__ rho, float* __restrict__ u,   \
           int X, int Y, int Z, int pz, int gbits, int has_nothing, ABParams p) {              \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                       \
    if (z >= Z) return;                                                                        \
    aa_odd_halo_site<WELL, EQ, LEAN>(f, fout, ring, rho, u, (int)blockIdx.z - 1,               \
                                     (int)blockIdx.y - 1, z, X, Y, Z, pz != 0, gbits,          \
                                     has_nothing != 0, p);                                     \
  }

#define AB_HALO_FF_KERNEL(NAME, WELL, EQ)                                                      \
  extern "C" __global__ void __launch_bounds__(THREADS)                                       \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                              \
           const uint8_t* __restrict__ map, const float* __restrict__ ff,                      \
           float* __restrict__ rho, float* __restrict__ u, int Y, int Z, int pz, ABParams p) { \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                       \
    if (z >= Z) return;                                                                        \
    ab_halo_site<WELL, EQ, 1, 0, true>(f, fout, map, rho, u, blockIdx.z, blockIdx.y, z,        \
                                       gridDim.z, Y, Z, pz != 0, p, ff);                       \
  }

#define AA_ODD_HALO_FF_KERNEL(NAME, WELL, EQ)                                                  \
  extern "C" __global__ void __launch_bounds__(THREADS)                                       \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                              \
           const uint8_t* __restrict__ ring, const float* __restrict__ ff,                     \
           float* __restrict__ rho, float* __restrict__ u, int X, int Y, int Z, int pz,        \
           int gbits, int has_nothing, ABParams p) {                                           \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                       \
    if (z >= Z) return;                                                                        \
    aa_odd_halo_site<WELL, EQ, false, 2, 1, true>(f, fout, ring, rho, u, (int)blockIdx.z - 1,  \
                                                  (int)blockIdx.y - 1, z, X, Y, Z, pz != 0,    \
                                                  gbits, has_nothing != 0, p, ff);             \
  }

// The u* pass on a block: a thread per site of the block (ODD: the odd read
// from the 2-wide halo, the map with its ring; else the A-B read).
#define HALO_MACRO_KERNEL(NAME, WELL, ODD)                                                     \
  extern "C" __global__ void __launch_bounds__(THREADS)                                       \
      NAME(const float* __restrict__ f, const uint8_t* __restrict__ map,                       \
           float* __restrict__ rho, float* __restrict__ u, int Y, int Z, int pz, ABParams p) { \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                       \
    if (z >= Z) return;                                                                        \
    halo_macro_site<WELL, ODD>(f, map, rho, u, blockIdx.z, blockIdx.y, z, gridDim.z, Y, Z,     \
                               pz != 0, p);                                                    \
  }

AB_HALO_KERNEL(ab_halo_cum_well_kernel, true, EQ_WELL)
AB_HALO_KERNEL(ab_halo_cum_quad_kernel, false, EQ_QUAD)
AB_HALO_KERNEL(ab_halo_cum_invcum_kernel, false, EQ_INVCUM)
AA_ODD_HALO_KERNEL(aa_odd_halo_cum_well_kernel, true, EQ_WELL, false)
AA_ODD_HALO_KERNEL(aa_odd_halo_cum_quad_kernel, false, EQ_QUAD, false)
AA_ODD_HALO_KERNEL(aa_odd_halo_cum_invcum_kernel, false, EQ_INVCUM, false)
AA_ODD_HALO_KERNEL(aa_odd_halo_lean_kernel, true, EQ_WELL, true)
AB_HALO_FF_KERNEL(ab_halo_ff_cum_well_kernel, true, EQ_WELL)
AB_HALO_FF_KERNEL(ab_halo_ff_cum_quad_kernel, false, EQ_QUAD)
AB_HALO_FF_KERNEL(ab_halo_ff_cum_invcum_kernel, false, EQ_INVCUM)
AA_ODD_HALO_FF_KERNEL(aa_odd_halo_ff_cum_well_kernel, true, EQ_WELL)
AA_ODD_HALO_FF_KERNEL(aa_odd_halo_ff_cum_quad_kernel, false, EQ_QUAD)
AA_ODD_HALO_FF_KERNEL(aa_odd_halo_ff_cum_invcum_kernel, false, EQ_INVCUM)
HALO_MACRO_KERNEL(ab_halo_macro_well_kernel, true, false)
HALO_MACRO_KERNEL(ab_halo_macro_total_kernel, false, false)
HALO_MACRO_KERNEL(aa_odd_halo_macro_well_kernel, true, true)
HALO_MACRO_KERNEL(aa_odd_halo_macro_total_kernel, false, true)

namespace {

ABParams params(float nu, float fx, float fy, float fz, float uin_x, float uin_y, float uin_z,
                int neumaier) {
  return ABParams{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier};
}

dim3 block_of(int Z) { return dim3(Z >= THREADS ? THREADS : ((Z + 31) / 32) * 32); }

}  // namespace

// The A-B step on a haloed block of X x Y x Z sites on `stream`: f
// [27, X+2, Y+2, Z], fout, map, rho, u of the block; pz: z periodic;
// variant as tnl_lbm_ab_step's (0 CUM_WELL, 1 CUM with the quadratic
// equilibrium, 2 with the inverse-cumulant one); mode as tnl_lbm_ab_step's
// (0 the step, 1 force_field with ff the block's [3, X, Y, Z] force, 2
// macro_only: fout unused, the u* pass of the variant's storage).  Returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for another
// variant or mode.
extern "C" int tnl_lbm_ab_step_halo(const float* f, float* fout, const uint8_t* map,
                                    const float* ff, float* rho, float* u, int X, int Y, int Z,
                                    int pz, int variant, int mode, float nu, float fx, float fy,
                                    float fz, float uin_x, float uin_y, float uin_z, int neumaier,
                                    void* stream) {
  using Kernel = void (*)(const float*, float*, const uint8_t*, float*, float*, int, int, int,
                          ABParams);
  using FFKernel = void (*)(const float*, float*, const uint8_t*, const float*, float*, float*,
                            int, int, int, ABParams);
  using MacroKernel = void (*)(const float*, const uint8_t*, float*, float*, int, int, int,
                               ABParams);
  static const Kernel kernels[3] = {ab_halo_cum_well_kernel, ab_halo_cum_quad_kernel,
                                    ab_halo_cum_invcum_kernel};
  static const FFKernel ff_kernels[3] = {ab_halo_ff_cum_well_kernel, ab_halo_ff_cum_quad_kernel,
                                         ab_halo_ff_cum_invcum_kernel};
  static const MacroKernel macro_kernels[3] = {ab_halo_macro_well_kernel,
                                               ab_halo_macro_total_kernel,
                                               ab_halo_macro_total_kernel};
  if (variant < 0 || variant > 2 || mode < 0 || mode > 2 || (mode == 1 && ff == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block = block_of(Z);
  const dim3 grid((Z + block.x - 1) / block.x, Y, X);
  const auto s = static_cast<cudaStream_t>(stream);
  const ABParams p = params(nu, fx, fy, fz, uin_x, uin_y, uin_z, neumaier);
  if (mode == 0)
    kernels[variant]<<<grid, block, 0, s>>>(f, fout, map, rho, u, Y, Z, pz, p);
  else if (mode == 1)
    ff_kernels[variant]<<<grid, block, 0, s>>>(f, fout, map, ff, rho, u, Y, Z, pz, p);
  else
    macro_kernels[variant]<<<grid, block, 0, s>>>(f, map, rho, u, Y, Z, pz, p);
  return static_cast<int>(cudaGetLastError());
}

// The A-A odd step on a block of X x Y x Z sites on `stream`: f
// [27, X+4, Y+4, Z], ring [X+2, Y+2, Z], fout, rho, u of the block; pz: z
// periodic; gbits: the block's faces on non-periodic domain faces (bit 0
// low x, 1 high x, 2 low y, 3 high y); variant as tnl_lbm_aa_odd's (0-2 as
// the A-B step's, 3 the lean CUM_WELL instance, the step's only); mode as
// tnl_lbm_ab_step_halo's, ff the force ring [3, X+2, Y+2, Z] in the ring's
// layout.  Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for another variant or mode.
extern "C" int tnl_lbm_aa_odd_halo(const float* f, float* fout, const uint8_t* ring,
                                   const float* ff, float* rho, float* u, int X, int Y, int Z,
                                   int pz, int gbits, int has_nothing, int variant, int mode,
                                   float nu, float fx, float fy, float fz, float uin_x,
                                   float uin_y, float uin_z, int neumaier, void* stream) {
  using Kernel = void (*)(const float*, float*, const uint8_t*, float*, float*, int, int, int,
                          int, int, int, ABParams);
  using FFKernel = void (*)(const float*, float*, const uint8_t*, const float*, float*, float*,
                            int, int, int, int, int, int, ABParams);
  using MacroKernel = void (*)(const float*, const uint8_t*, float*, float*, int, int, int,
                               ABParams);
  static const Kernel kernels[4] = {aa_odd_halo_cum_well_kernel, aa_odd_halo_cum_quad_kernel,
                                    aa_odd_halo_cum_invcum_kernel, aa_odd_halo_lean_kernel};
  static const FFKernel ff_kernels[3] = {aa_odd_halo_ff_cum_well_kernel,
                                         aa_odd_halo_ff_cum_quad_kernel,
                                         aa_odd_halo_ff_cum_invcum_kernel};
  static const MacroKernel macro_kernels[3] = {aa_odd_halo_macro_well_kernel,
                                               aa_odd_halo_macro_total_kernel,
                                               aa_odd_halo_macro_total_kernel};
  if (variant < 0 || variant > (mode == 0 ? 3 : 2) || mode < 0 || mode > 2 ||
      (mode == 1 && ff == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block = block_of(Z);
  const auto s = static_cast<cudaStream_t>(stream);
  const ABParams p = params(nu, fx, fy, fz, uin_x, uin_y, uin_z, neumaier);
  if (mode == 2) {  // the u* pass: the block's sites
    const dim3 grid((Z + block.x - 1) / block.x, Y, X);
    macro_kernels[variant]<<<grid, block, 0, s>>>(f, ring, rho, u, Y, Z, pz, p);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((Z + block.x - 1) / block.x, Y + 2, X + 2);
  if (mode == 0)
    kernels[variant]<<<grid, block, 0, s>>>(f, fout, ring, rho, u, X, Y, Z, pz, gbits,
                                            has_nothing, p);
  else
    ff_kernels[variant]<<<grid, block, 0, s>>>(f, fout, ring, ff, rho, u, X, Y, Z, pz, gbits,
                                               has_nothing, p);
  return static_cast<int>(cudaGetLastError());
}
