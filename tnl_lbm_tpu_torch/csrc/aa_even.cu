// A-A even step for D3Q27 CUM_WELL in float32, one thread per site.
//
// Replaces the Pallas kernel of tnl_lbm_tpu/kernels/fused_aa.py
// make_fused_step_aa (even_kernel, pallas_call at :408).  Per site: read
// the 27 DFs of the site itself (same site, same direction, reference
// streaming_AA.h:16-45), apply the WALL swap, take the moments, collide,
// and write the result to the opposite slots of the same site; NOTHING
// sites keep their DFs.  Each thread reads and writes only its own site,
// so the update is in place on the one state buffer.
//
// Bound: HBM bytes.  Per site and step 27 f32 are read and 27 written
// (216 B), plus the 1-byte map read and the 16 B of rho and u.  The design
// keeps every load and store coalesced: threadIdx.x runs along z, the
// fastest axis of the [27, X, Y, Z] layout, so each of the 27 component
// planes is read and written as contiguous runs of a warp.  The cumulant
// cascade runs entirely in registers; no shared memory is used.
// Offsets are 64-bit: 27 X Y Z exceeds 2^31 at 512^3.

#include <cuda_runtime.h>

#include "lbm_site.cuh"

using namespace lbm;

extern "C" __global__ void __launch_bounds__(128)
aa_even_kernel(float* __restrict__ f, const uint8_t* __restrict__ map,
               float* __restrict__ rho_out, float* __restrict__ u_out,
               int Y, int Z, SiteParams p) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  if (z >= Z) return;
  const int64_t N = (int64_t)gridDim.z * Y * Z;
  const int64_t site = ((int64_t)blockIdx.z * Y + blockIdx.y) * Z + z;

  const uint8_t m = map[site];
  float rho = 1.0f, ux = 0.0f, uy = 0.0f, uz = 0.0f;
  if (m != GEO_NOTHING) {
    float v[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = f[q * N + site];
    stream_bc_collide(v, m, p, rho, ux, uy, uz);
#pragma unroll
    for (int q = 0; q < Q; ++q) f[q * N + site] = v[opp(q)];
  }
  rho_out[site] = rho;
  u_out[site] = ux;
  u_out[N + site] = uy;
  u_out[2 * N + site] = uz;
}

// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int tnl_lbm_aa_even(float* f, const uint8_t* map, float* rho, float* u,
                               int X, int Y, int Z, float nu, float fx, float fy, float fz,
                               int neumaier, void* stream) {
  const SiteParams p{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, neumaier};
  const int block = Z >= 128 ? 128 : ((Z + 31) / 32) * 32;
  const dim3 grid((Z + block - 1) / block, Y, X);
  aa_even_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(f, map, rho, u, Y, Z, p);
  return static_cast<int>(cudaGetLastError());
}
