// Float64 instances of the A-A even and odd steps (B2, B3) for D3Q27
// CUM_WELL (well=True, the well-conditioned equilibrium), one thread per
// site: the even step in place, the odd step out of place with the full
// A-A code set, and the odd step's lean instance on a map of FLUID, WALL
// and NOTHING (sim_2's duct).  sim_2 --streaming AA --precision double runs
// them per step.
//
// Replace the Pallas kernels of tnl_lbm_tpu/kernels/fused_aa.py
// make_fused_step_aa (even_kernel, pallas_call at :408; the odd call built
// by _build_odd_call, :129, called at :287) where cfg.compute_dtype is
// float64 (they compute in it, :685).  The site updates are aa_even.cu's
// and aa_odd.cu's (lbm_site.cuh aa_even_site, aa_odd_site), compiled with
// LBM_F64: every operation in double, the state, rho, u and the parameters
// double too.
//
// Bound: HBM bytes, 27 f64 in and out, the map, rho and u: 465 B/site per
// step; the site's FP64 work as for the A-B step (f64_ab.cu).  Same design
// as the float32 kernels: z along threadIdx.x, no shared memory, the odd
// step's pushes by the one-writer rule of push_targets.
//
// The haloed odd instances (aa_odd_halo_f64_*_kernel, tnl_lbm_aa_odd_halo_f64):
// the sharded A-A step's odd step on a shard's block in float64, as
// halo_step.cu's float32 ones (lbm_site.cuh aa_odd_halo_site): f
// [27, X+4, Y+4, Z], the map ring [X+2, Y+2, Z], the rest the block; lean
// and full set.  They replace the same Pallas call (fused_aa.py:287) with
// prepadded=True, map_ring_in and bflags, in float64.

#define LBM_F64

#include <cuda_runtime.h>

#include "lbm_site.cuh"

using namespace lbm;

// threads per block, along z
constexpr int THREADS = 128;

extern "C" __global__ void __launch_bounds__(THREADS)
    aa_even_f64_cum_well_kernel(double* __restrict__ f, const uint8_t* __restrict__ map,
                                double* __restrict__ rho, double* __restrict__ u, int Y, int Z,
                                ABParams p) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  if (z >= Z) return;
  const int64_t N = (int64_t)gridDim.z * Y * Z;
  const int64_t site = ((int64_t)blockIdx.z * Y + blockIdx.y) * Z + z;
  double ux, uy, uz;
  aa_even_site<true, EQ_WELL>(f, map, rho, u, site, N, p, ux, uy, uz);
}

#define AA_ODD_F64_KERNEL(NAME, LEAN)                                                         \
  extern "C" __global__ void __launch_bounds__(THREADS)                                      \
      NAME(const double* __restrict__ f, double* __restrict__ fout,                           \
           const uint8_t* __restrict__ map, double* __restrict__ rho, double* __restrict__ u, \
           int Y, int Z, int periodic_bits, int has_nothing, ABParams p) {                    \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                      \
    if (z >= Z) return;                                                                       \
    double ux, uy, uz;                                                                        \
    aa_odd_site<true, EQ_WELL, LEAN>(f, fout, map, rho, u, blockIdx.z, blockIdx.y, z,         \
                                     gridDim.z, Y, Z, periodic_bits, has_nothing != 0, p, ux, \
                                     uy, uz);                                                 \
  }

AA_ODD_F64_KERNEL(aa_odd_f64_cum_well_kernel, false)
AA_ODD_F64_KERNEL(aa_odd_f64_lean_kernel, true)

#define AA_ODD_HALO_F64_KERNEL(NAME, LEAN)                                                    \
  extern "C" __global__ void __launch_bounds__(THREADS)                                      \
      NAME(const double* __restrict__ f, double* __restrict__ fout,                           \
           const uint8_t* __restrict__ ring, double* __restrict__ rho, double* __restrict__ u,\
           int X, int Y, int Z, int pz, int gbits, int has_nothing, ABParams p) {            \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                      \
    if (z >= Z) return;                                                                       \
    aa_odd_halo_site<true, EQ_WELL, LEAN>(f, fout, ring, rho, u, (int)blockIdx.z - 1,         \
                                          (int)blockIdx.y - 1, z, X, Y, Z, pz != 0, gbits,    \
                                          has_nothing != 0, p);                               \
  }

AA_ODD_HALO_F64_KERNEL(aa_odd_halo_f64_cum_well_kernel, false)
AA_ODD_HALO_F64_KERNEL(aa_odd_halo_f64_lean_kernel, true)

namespace {

ABParams params(double nu, double fx, double fy, double fz, double uin_x, double uin_y,
                double uin_z, int neumaier) {
  return ABParams{1.0 / (3.0 * nu + 0.5), fx, fy, fz, uin_x, uin_y, uin_z, neumaier};
}

dim3 block_of(int Z) { return dim3(Z >= THREADS ? THREADS : ((Z + 31) / 32) * 32); }

}  // namespace

// The even step in place on `stream`; returns cudaGetLastError() of the launch.
extern "C" int tnl_lbm_aa_even_f64(double* f, const uint8_t* map, double* rho, double* u, int X,
                                   int Y, int Z, double nu, double fx, double fy, double fz,
                                   double uin_x, double uin_y, double uin_z, int neumaier,
                                   void* stream) {
  const dim3 block = block_of(Z);
  const dim3 grid((Z + block.x - 1) / block.x, Y, X);
  aa_even_f64_cum_well_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      f, map, rho, u, Y, Z, params(nu, fx, fy, fz, uin_x, uin_y, uin_z, neumaier));
  return static_cast<int>(cudaGetLastError());
}

// The odd step from f into fout on `stream`: lean 1 the FLUID/WALL/NOTHING
// instance, 0 the full A-A code set; returns cudaGetLastError() of the
// launch.  periodic_bits: bit 0 x, 1 y, 2 z.
extern "C" int tnl_lbm_aa_odd_f64(const double* f, double* fout, const uint8_t* map, double* rho,
                                  double* u, int X, int Y, int Z, int periodic_bits,
                                  int has_nothing, int lean, double nu, double fx, double fy,
                                  double fz, double uin_x, double uin_y, double uin_z,
                                  int neumaier, void* stream) {
  const dim3 block = block_of(Z);
  const dim3 grid((Z + block.x - 1) / block.x, Y, X);
  const ABParams p = params(nu, fx, fy, fz, uin_x, uin_y, uin_z, neumaier);
  const auto s = static_cast<cudaStream_t>(stream);
  if (lean)
    aa_odd_f64_lean_kernel<<<grid, block, 0, s>>>(f, fout, map, rho, u, Y, Z, periodic_bits,
                                                  has_nothing, p);
  else
    aa_odd_f64_cum_well_kernel<<<grid, block, 0, s>>>(f, fout, map, rho, u, Y, Z, periodic_bits,
                                                      has_nothing, p);
  return static_cast<int>(cudaGetLastError());
}

// The haloed odd step on a block of X x Y x Z sites on `stream`: f
// [27, X+4, Y+4, Z], ring [X+2, Y+2, Z], fout, rho, u of the block; pz, gbits
// and has_nothing as halo_step.cu tnl_lbm_aa_odd_halo's; lean 1 the
// FLUID/WALL/NOTHING instance, 0 the full A-A code set.  Returns
// cudaGetLastError() of the launch.
extern "C" int tnl_lbm_aa_odd_halo_f64(const double* f, double* fout, const uint8_t* ring,
                                       double* rho, double* u, int X, int Y, int Z, int pz,
                                       int gbits, int has_nothing, int lean, double nu, double fx,
                                       double fy, double fz, double uin_x, double uin_y,
                                       double uin_z, int neumaier, void* stream) {
  const dim3 block = block_of(Z);
  const dim3 grid((Z + block.x - 1) / block.x, Y + 2, X + 2);
  const ABParams p = params(nu, fx, fy, fz, uin_x, uin_y, uin_z, neumaier);
  const auto s = static_cast<cudaStream_t>(stream);
  if (lean)
    aa_odd_halo_f64_lean_kernel<<<grid, block, 0, s>>>(f, fout, ring, rho, u, X, Y, Z, pz, gbits,
                                                       has_nothing, p);
  else
    aa_odd_halo_f64_cum_well_kernel<<<grid, block, 0, s>>>(f, fout, ring, rho, u, X, Y, Z, pz,
                                                           gbits, has_nothing, p);
  return static_cast<int>(cudaGetLastError());
}
