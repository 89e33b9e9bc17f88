// The A-A pair with the A-A steps' code set (B1b): two lattice steps (even,
// then odd) of D3Q27 in float32 in one launch, with the boundary set and
// the three variants of the even and odd steps (aa_even.cu, aa_odd.cu).
//
// Replaces the Pallas kernels of tnl_lbm_tpu/kernels/fused_aa.py
// make_fused_pair_aa (:1183): its even kernel (even_kernel, pallas_call at
// :1274), which writes the odd kernel's padded [Q, X+4, Y+16, Z] layout, the
// halo fill between them (_fill_halos, :1302-1327) and its odd kernel
// (_build_odd_call, pallas_call at :287).  Per call f_out = odd(even(f_in)),
// rho and u from the odd sub-step; the codes are all of the A-A set but
// OUTFLOW_RIGHT_INTERP (INFLOW, INFLOW_LEFT, OUTFLOW_EQ, OUTFLOW_RIGHT,
// PERIODIC, the six SYM planes, WALL, NOTHING, FLUID).
//
// Design: the one-kernel pair's x-march (pair_march.cuh pair_march, shared
// with aa_pair.cu), whose even output stays on chip: 11 even warps run
// aa_even_site's update (lbm_site.cuh site_collide on the site's own DFs,
// the opposite-slot result; NOTHING sites keep their DFs) over each window
// plane into the ring; 8 odd warps pull ev[opp q](s - c_q) from it, run
// aa_odd_site's update (site_collide: the WALL swap and the symmetry
// mirrors before the moments, the inflow and outflow rules after them, in
// registers) and push with push_targets' one-writer edge-replicated
// scatter.  An OUTFLOW_RIGHT site pulls all 27 components from x - 1
// (lbm_site.cuh aa_odd_pull), so the ring keeps every group of a plane
// until the odd plane after it has read (pair_march.cuh OUT_GROUPS: 146,880
// bytes), and the even output never goes to HBM.  The input planes are read from
// global memory by the even warps: the ring and the stages' 86 KB would not
// fit one block, and B1 ran 9-13% faster unstaged (tests/pair_ablation.py).
//
// Instances: CUM_WELL, CUM with eq_quadratic and CUM with eq_inv_cum on the
// full set, and a lean CUM_WELL instance for a map of FLUID, WALL and
// NOTHING (B1's site updates, the ring of 9 groups, no stages).  The other
// collisions, and CUM with eq_entropic, are pair_coll.cuh's (one source per
// family) on the same march and geometry.
//
// Bound: HBM bytes, one read and one write of f per pair (216 B/site), the
// map and 16 B of rho and u: 233 B/site.  Registers: 608 threads a block
// leave at most 104 a thread; the full-set site update spills beyond that
// (the ptxas report, PERF.md).  Offsets into a state are 64-bit; offsets
// within one plane (Y Z < 2^31 sites) are 32-bit.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "lbm_site.cuh"
#include "pair_march.cuh"

using namespace lbm;
using namespace lbm::march;

namespace {

// The full-set instance for (WELL, EQ): aa_even_site's and aa_odd_site's
// site updates.
template <bool WELL, int EQ>
struct FullSite {
  using Store = float;
  using Params = ABParams;
  static constexpr bool STAGED = false, OUTFLOW = true;
  __device__ static __forceinline__ void even(float (&v)[Q], uint8_t m, const ABParams& p) {
    float rho, ux, uy, uz;
    site_collide<WELL, EQ>(v, m, p, rho, ux, uy, uz);
  }
  __device__ static __forceinline__ void odd(float (&v)[Q], uint8_t m, const ABParams& p,
                                             float& rho, float& ux, float& uy, float& uz) {
    site_collide<WELL, EQ>(v, m, p, rho, ux, uy, uz);
  }
};

// The lean instance: CUM_WELL on FLUID, WALL and NOTHING (no outflow pull).
struct LeanSite {
  using Store = float;
  using Params = ABParams;
  static constexpr bool STAGED = false, OUTFLOW = false;
  __device__ static __forceinline__ void even(float (&v)[Q], uint8_t m, const ABParams& p) {
    float rho, ux, uy, uz;
    stream_bc_collide(v, m, p, rho, ux, uy, uz);
  }
  __device__ static __forceinline__ void odd(float (&v)[Q], uint8_t m, const ABParams& p,
                                             float& rho, float& ux, float& uy, float& uz) {
    stream_bc_collide(v, m, p, rho, ux, uy, uz);
  }
};

using FullWell = FullSite<true, EQ_WELL>;
using FullQuad = FullSite<false, EQ_QUAD>;
using FullInvCum = FullSite<false, EQ_INVCUM>;

}  // namespace

#define AA_PAIR_FULL_KERNEL(NAME, SITE)                                                       \
  extern "C" __global__ void __launch_bounds__(THREADS, 1)                                   \
      NAME(const float* __restrict__ f, float* __restrict__ fout,                             \
           const uint8_t* __restrict__ map, float* __restrict__ rho, float* __restrict__ u,   \
           int X, int Y, int Z, int periodic_bits, int has_nothing, int with_macro,          \
           int seg_len, ABParams p) {                                                         \
    pair_march<SITE>(f, fout, map, rho, u, X, Y, Z, periodic_bits, has_nothing, with_macro,   \
                     seg_len, 0, p);                                                          \
  }

AA_PAIR_FULL_KERNEL(aa_pair_full_cum_well_kernel, FullWell)
AA_PAIR_FULL_KERNEL(aa_pair_full_cum_quad_kernel, FullQuad)
AA_PAIR_FULL_KERNEL(aa_pair_full_cum_invcum_kernel, FullInvCum)
AA_PAIR_FULL_KERNEL(aa_pair_full_lean_kernel, LeanSite)

namespace {

using FullKernel = void (*)(const float*, float*, const uint8_t*, float*, float*, int, int, int,
                            int, int, int, int, ABParams);

const FullKernel KERNELS[4] = {aa_pair_full_cum_well_kernel, aa_pair_full_cum_quad_kernel,
                               aa_pair_full_cum_invcum_kernel, aa_pair_full_lean_kernel};

// Dynamic shared memory of one block of a variant: the ring (12 groups with
// the outflow pull, 9 on the lean map) and the codes.
int full_smem(int variant) {
  return variant == 3 ? RING_BYTES + CODE_BYTES : OUT_SMEM_BYTES;
}

}  // namespace

// The launch geometry of a variant and a shape: out[0] dynamic shared
// memory per block (bytes), [1] ring groups, [2] TY, [3] TZ, [4] the
// automatic x segment length, [5] segments, [6] column tiles, [7] threads
// per block.  Returns cudaErrorInvalidValue for an unknown variant.
extern "C" int tnl_lbm_aa_pair_full_info(int variant, int X, int Y, int Z, int* out) {
  if (variant < 0 || variant > 3) return static_cast<int>(cudaErrorInvalidValue);
  const int seg = auto_seg_len(X, Y, Z);
  const int vals[8] = {full_smem(variant), variant == 3 ? RING_GROUPS : 3 * OUT_GROUPS,
                       TY, TZ, seg, (X + seg - 1) / seg, column_tiles(Y, Z), THREADS};
  for (int k = 0; k < 8; ++k) out[k] = vals[k];
  return 0;
}

// Launches on `stream`; returns the CUDA error of the launch (0 on
// success), or cudaErrorInvalidValue for an unknown variant, rho and u not
// both given or both null, or a plane of 2^31 sites or more.  variant as
// tnl_lbm_aa_odd: 0 CUM_WELL, 1 CUM with the quadratic equilibrium, 2 CUM
// with the inverse-cumulant one, 3 CUM_WELL on a FLUID/WALL/NOTHING map.
// periodic_bits: bit 0 x, 1 y, 2 z.  rho and u are null when with_macro is
// 0.  seg_len: the x segment of one block, or 0 for the automatic one.
extern "C" int tnl_lbm_aa_pair_full(const float* f, float* fout, const uint8_t* map, float* rho,
                                    float* u, int X, int Y, int Z, int periodic_bits,
                                    int has_nothing, int with_macro, int variant, float nu,
                                    float fx, float fy, float fz, float uin_x, float uin_y,
                                    float uin_z, int neumaier, int seg_len, void* stream) {
  static cudaError_t opted[4] = {cudaErrorNotReady, cudaErrorNotReady, cudaErrorNotReady,
                                 cudaErrorNotReady};
  if (variant < 0 || variant > 3 || (rho == nullptr) != (u == nullptr) ||
      (with_macro != 0) != (rho != nullptr) || (int64_t)Y * Z > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (opted[variant] == cudaErrorNotReady)
    opted[variant] = cudaFuncSetAttribute(
        KERNELS[variant], cudaFuncAttributeMaxDynamicSharedMemorySize, full_smem(variant));
  if (opted[variant] != cudaSuccess) return static_cast<int>(opted[variant]);
  if (seg_len <= 0) seg_len = auto_seg_len(X, Y, Z);
  const ABParams p{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier};
  const int blocks = column_tiles(Y, Z) * ((X + seg_len - 1) / seg_len);
  KERNELS[variant]<<<blocks, THREADS, full_smem(variant), static_cast<cudaStream_t>(stream)>>>(
      f, fout, map, rho, u, X, Y, Z, periodic_bits, has_nothing, with_macro, seg_len, p);
  return static_cast<int>(cudaGetLastError());
}
