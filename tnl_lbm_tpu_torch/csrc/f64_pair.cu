// Float64 instance of the one-kernel A-A pair (B1) for D3Q27 CUM_WELL on a
// map of FLUID, WALL and NOTHING: two lattice steps (even, then odd) per
// launch, the state stored in float64 and every operation in float64.
// sim_2 --streaming AA --precision double runs it under pair dispatch.
//
// Replaces the Pallas kernel of tnl_lbm_tpu/kernels/fused_aa.py
// make_fused_pair2_aa (kernel at :794, pallas_call at :1115) where
// cfg.compute_dtype is float64 and the state is stored in it (:685-704).
// Per call f_out = odd(even(f_in)), with rho and u from the odd sub-step;
// the site updates are aa_pair.cu's (stream_bc_collide), compiled with
// LBM_F64.
//
// Design: the float32 pair's x-march (pair_march.cuh pair_march<Site>),
// which LBM_F64 compiles on a half-width column tile, 8 x 16 sites (the
// window plane 10 x 18 = 180 sites): 6 even warps, one thread per window
// site, and 4 odd warps, one thread per tile site, 320 threads a block.
// The float32 tile's 19 warps at 96 registers would spill the double site
// update heavily; here a thread may hold up to 200 registers.  The even
// output stays in shared memory in float64, in the ring of the slots later
// odd pulls read (9 groups of 9 doubles a window site, 116 640 B), beside
// the codes (900 B): 117 540 B, one block an SM.  No stages: the even
// warps read their window planes from global memory (the float32 kernel ran
// unstaged at 0.909x its staged time on an H100, PERF.md; float64 stages
// would not fit beside the ring at the float32 tile).  Blocks read their
// neighbours' sites, so the kernel reads f_in and writes a second buffer.
//
// Bound: HBM bytes, one read and one write of f per two steps (432 B/site)
// plus the map and 32 B of rho and u: 465 B/site a pair; the two site
// updates' FP64 work (2.4 collisions a site with the window halo) on the
// FP64 pipe, half the FP32 pipe's lanes (chip_smoke.py card_rates).
//
// The haloed instance (aa_pair_halo_f64_kernel, tnl_lbm_aa_pair_f64_halo):
// the sharded pair on one shard's block, as aa_pair.cu's haloed instances
// (pair_march.cuh, HALO): f, fout and the map [27, X+4, Y+4, Z], the
// interior written.

#define LBM_F64

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "lbm_site.cuh"
#include "pair_march.cuh"

using namespace lbm;
using namespace lbm::march;

namespace {

// B1's float64 instance of the march: CUM_WELL on FLUID, WALL and NOTHING,
// stored in double, its input planes read from global memory.
struct PairSiteF64 {
  using Store = double;
  using Params = SiteParams;
  static constexpr bool STAGED = false, OUTFLOW = false;
  __device__ static __forceinline__ void even(double (&v)[Q], uint8_t m, const SiteParams& p) {
    double rho, ux, uy, uz;
    stream_bc_collide(v, m, p, rho, ux, uy, uz);
  }
  __device__ static __forceinline__ void odd(double (&v)[Q], uint8_t m, const SiteParams& p,
                                             double& rho, double& ux, double& uy, double& uz) {
    stream_bc_collide(v, m, p, rho, ux, uy, uz);
  }
};

// The ring and the codes; no stages.
constexpr int SMEM_F64 = RING_BYTES + CODE_BYTES;

}  // namespace

extern "C" __global__ void __launch_bounds__(THREADS, 1)
    aa_pair_f64_kernel(const double* __restrict__ f, double* __restrict__ fout,
                       const uint8_t* __restrict__ map, double* __restrict__ rho,
                       double* __restrict__ u, int X, int Y, int Z, int periodic_bits,
                       int has_nothing, int with_macro, int seg_len, SiteParams p) {
  pair_march<PairSiteF64>(f, fout, map, rho, u, X, Y, Z, periodic_bits, has_nothing, with_macro,
                          seg_len, 0, p);
}

extern "C" __global__ void __launch_bounds__(THREADS, 1)
    aa_pair_halo_f64_kernel(const double* __restrict__ f, double* __restrict__ fout,
                            const uint8_t* __restrict__ map, double* __restrict__ rho,
                            double* __restrict__ u, int X, int Y, int Z, int periodic_bits,
                            int has_nothing, int with_macro, int seg_len, int gbits,
                            SiteParams p) {
  pair_march<PairSiteF64, true>(f, fout, map, rho, u, X, Y, Z, periodic_bits, has_nothing,
                                with_macro, seg_len, 0, p, gbits);
}

// The launch geometry for a shape: out[0] dynamic shared memory per block
// (bytes), [1] stages (0), [2] TY, [3] TZ, [4] the automatic x segment
// length, [5] segments, [6] column tiles, [7] staged (0), [8] threads.
extern "C" int tnl_lbm_aa_pair_f64_info(int X, int Y, int Z, int* out) {
  const int seg = auto_seg_len(X, Y, Z);
  const int vals[9] = {SMEM_F64, 0, TY, TZ, seg, (X + seg - 1) / seg, column_tiles(Y, Z), 0,
                       THREADS};
  for (int k = 0; k < 9; ++k) out[k] = vals[k];
  return 0;
}

// Launches on `stream`; returns the CUDA error of the launch (0 on success).
// periodic_bits: bit 0 x, 1 y, 2 z.  rho and u may be null when with_macro
// is 0.  seg_len: the x segment of one block, or 0 for the automatic one.
extern "C" int tnl_lbm_aa_pair_f64(const double* f, double* fout, const uint8_t* map,
                                   double* rho, double* u, int X, int Y, int Z,
                                   int periodic_bits, int has_nothing, int with_macro, double nu,
                                   double fx, double fy, double fz, int neumaier, int seg_len,
                                   void* stream) {
  static const cudaError_t opted = cudaFuncSetAttribute(
      aa_pair_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_F64);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  if ((int64_t)Y * Z > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (seg_len <= 0) seg_len = auto_seg_len(X, Y, Z);
  const SiteParams p{1.0 / (3.0 * nu + 0.5), fx, fy, fz, neumaier};
  const int blocks = column_tiles(Y, Z) * ((X + seg_len - 1) / seg_len);
  aa_pair_f64_kernel<<<blocks, THREADS, SMEM_F64, static_cast<cudaStream_t>(stream)>>>(
      f, fout, map, rho, u, X, Y, Z, periodic_bits, has_nothing, with_macro, seg_len, p);
  return static_cast<int>(cudaGetLastError());
}

// The haloed pair on one shard's block on `stream` (aa_pair.cu
// tnl_lbm_aa_pair_halo's arguments in double, without the store code).
extern "C" int tnl_lbm_aa_pair_f64_halo(const double* f, double* fout, const uint8_t* map,
                                        double* rho, double* u, int X, int Y, int Z, int pz,
                                        int gbits, int has_nothing, int with_macro, double nu,
                                        double fx, double fy, double fz, int neumaier,
                                        int seg_len, void* stream) {
  // opted in at every launch: a card keeps the attribute for itself
  const cudaError_t opted = cudaFuncSetAttribute(
      aa_pair_halo_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_F64);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  if ((int64_t)(Y + 4) * Z > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (seg_len <= 0) seg_len = auto_seg_len(X + 2, Y + 2, Z);
  const SiteParams p{1.0 / (3.0 * nu + 0.5), fx, fy, fz, neumaier};
  const int blocks = column_tiles(Y + 2, Z) * ((X + 2 + seg_len - 1) / seg_len);
  aa_pair_halo_f64_kernel<<<blocks, THREADS, SMEM_F64, static_cast<cudaStream_t>(stream)>>>(
      f, fout, map, rho, u, X, Y, Z, pz ? 4 : 0, has_nothing, with_macro, seg_len, gbits, p);
  return static_cast<int>(cudaGetLastError());
}
