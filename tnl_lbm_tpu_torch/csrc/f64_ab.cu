// Float64 instances of the A-B step (B4) for D3Q27 CUM_WELL (well=True, the
// well-conditioned equilibrium), with the full 3D boundary set, one thread
// per site: the vector instance (a homogeneous inflow velocity) and the
// profile instance (the velocity of each INFLOW_LEFT and INFLOW site read
// from a per-site field).  sim_2 --precision double runs them, and sim_2
// --velocity --precision double the profile one.
//
// Replaces the Pallas kernel of tnl_lbm_tpu/kernels/fused.py
// make_fused_step (pallas_call at :585) where cfg.compute_dtype is float64
// (the kernel computes in it, :510); the profile instance computes what the
// JAX driver runs on its XLA step for a profile (fused.py
// _stream_bc_collide with a per-site u_in_field, :313-333).  The site update
// is ab_step.cu's, lbm_site.cuh ab_site, compiled with LBM_F64: every
// operation in double, the state, rho, u, the parameters and the profile
// double too.
//
// Bound: HBM bytes.  Per site and step 27 f64 are read and 27 written
// (432 B), plus the 1-byte map and the 32 B of rho and u: 465 B/site (the
// profile instance 24 B more at an inflow site).  The FP64 work of a site
// is the float32 cascade's operations on the card's FP64 pipe, half as
// many lanes as FP32's (chip_smoke.py card_rates); the IEEE double
// divisions are DFMA sequences.  Same design as the float32 step: z runs
// along threadIdx.x so that each component's reads and writes are
// contiguous runs of a warp; no shared memory; registers roughly double.

#define LBM_F64

#include <cuda_runtime.h>

#include "lbm_site.cuh"

using namespace lbm;

// threads per block, along z
constexpr int THREADS = 128;

#define AB_F64_KERNEL(NAME, PROF)                                                             \
  extern "C" __global__ void __launch_bounds__(THREADS)                                      \
      NAME(const double* __restrict__ f, double* __restrict__ fout,                           \
           const uint8_t* __restrict__ map, double* __restrict__ rho, double* __restrict__ u, \
           int Y, int Z, int periodic_bits, ABParams p, Profile prof) {                       \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                      \
    if (z >= Z) return;                                                                       \
    double ux, uy, uz;                                                                        \
    ab_site<true, EQ_WELL, false, Cum<true>, ABParams, PROF>(                                 \
        f, fout, map, rho, u, blockIdx.z, blockIdx.y, z, gridDim.z, Y, Z, periodic_bits, p,   \
        ux, uy, uz, nullptr, prof);                                                           \
  }

AB_F64_KERNEL(ab_step_f64_cum_well_kernel, false)
AB_F64_KERNEL(ab_step_f64_profile_cum_well_kernel, true)

// Launches on `stream`; returns cudaGetLastError() of the launch.  pbits
// (periodic axes): bit 0 x, bit 1 y, bit 2 z.  prof null: the vector
// instance with (uin_x, uin_y, uin_z); else the profile instance, prof the
// [3, ...] field with its element strides (component, x, y, z; 0 on a
// broadcast axis), and the uin arguments unused.
extern "C" int tnl_lbm_ab_step_f64(const double* f, double* fout, const uint8_t* map,
                                   double* rho, double* u, int X, int Y, int Z, int pbits,
                                   double nu, double fx, double fy, double fz, double uin_x,
                                   double uin_y, double uin_z, const double* prof, long long sa,
                                   long long sx, long long sy, long long sz, int neumaier,
                                   void* stream) {
  const ABParams p{1.0 / (3.0 * nu + 0.5), fx, fy, fz, uin_x, uin_y, uin_z, neumaier};
  const int block = Z >= THREADS ? THREADS : ((Z + 31) / 32) * 32;
  const dim3 grid((Z + block - 1) / block, Y, X);
  const auto s = static_cast<cudaStream_t>(stream);
  if (prof == nullptr)
    ab_step_f64_cum_well_kernel<<<grid, block, 0, s>>>(f, fout, map, rho, u, Y, Z, pbits, p,
                                                       Profile{});
  else
    ab_step_f64_profile_cum_well_kernel<<<grid, block, 0, s>>>(
        f, fout, map, rho, u, Y, Z, pbits, p, Profile{prof, sa, sx, sy, sz});
  return static_cast<int>(cudaGetLastError());
}
