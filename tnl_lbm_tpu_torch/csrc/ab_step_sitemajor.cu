// A-B step for D3Q27 (CUM_WELL or CUM) in float32 with the full 3D
// boundary set on the site-major layout [X, Y, 32, Z], one thread per site.
//
// Replaces the Pallas kernel of tnl_lbm_tpu/kernels/fused.py
// make_fused_step_sitemajor (kernel at :688, pallas_call at :732).  The
// state holds a site's 27 components, padded to QPAD = 32 with zeros,
// between its y row and its z run: component q of site (x, y, z) lies at
// ((x Y + y) 32 + q) Z + z.  The update is the A-B step's (ab_step.cu,
// lbm_site.cuh ab_site): pull f_q from x - c_q, wrapped on periodic axes and
// clamped to the edge site otherwise, the outflow pull rules, the WALL swap
// and the symmetry mirrors, the moments, the post-moment BCs and the
// collision where the code collides (site_collide); NOTHING sites keep
// their DFs; WALL and NOTHING sites report rho = 1, u = 0.  The five dummy
// components of the output are written as zeros, as the JAX kernel writes
// them.  The wrap and clamp are index arithmetic: the JAX step's
// _pad_once_sitemajor pass has no counterpart.  The map, rho and u keep
// their [X, Y, Z] and [3, X, Y, Z] layouts.
//
// Instances: CUM_WELL; CUM with eq_quadratic; CUM with eq_inv_cum (the
// A-B step's).  The JAX function has no force_field or macro_only variant,
// and neither has this kernel.
//
// Bound: HBM bytes.  Per site 27 f32 are read and 32 written (the dummies
// included), plus the 1-byte map and the 16 B of rho and u: 253 B/site.
// threadIdx.x runs along z, so each component's reads and writes are
// contiguous runs of a warp, as in ab_step.cu; the 27 components of one
// site lie 4 Z bytes apart (1 KB at Z = 256) instead of X Y Z 4 bytes.
// Offsets are 64-bit.

#include <cuda_runtime.h>

#include "lbm_site.cuh"

using namespace lbm;

namespace {

// threads per block, along z
constexpr int THREADS = 128;
// components per site in the layout, the dummies included
constexpr int QPAD = 32;

// ab_site with site-major offsets; rho_out / u_out null: no macro writes.
template <bool WELL, int EQ>
__device__ __forceinline__ void ab_site_sitemajor(const float* __restrict__ fs,
                                                  float* __restrict__ fout,
                                                  const uint8_t* __restrict__ map,
                                                  float* __restrict__ rho_out,
                                                  float* __restrict__ u_out, int x, int y, int z,
                                                  int X, int Y, int Z, int periodic_bits,
                                                  const ABParams& p) {
  const int64_t N = (int64_t)X * Y * Z;
  const int64_t site = ((int64_t)x * Y + y) * Z + z;
  const int64_t sy = (int64_t)QPAD * Z, sx = (int64_t)Y * sy;
  const int64_t base = x * sx + y * sy + z;  // component 0 of this site
  const bool px = periodic_bits & 1, py = periodic_bits & 2, pz = periodic_bits & 4;
  // component q of site (nx, ny, nz)
  auto at = [&](int q, int nx, int ny, int nz) {
    return fs[nx * sx + ny * sy + (int64_t)q * Z + nz];
  };

  const uint8_t m = map[site];
  float v[Q];
  float rho = 1.0f, ux = 0.0f, uy = 0.0f, uz = 0.0f;
  if (m == GEO_NOTHING) {
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = fs[base + (int64_t)q * Z];
  } else {
    const bool row_inside = x > 0 && x < X - 1 && y > 0 && y < Y - 1;
    if (row_inside) {
#pragma unroll
      for (int q = 0; q < Q; ++q)
        v[q] = fs[base + (int64_t)q * Z - cx(q) * sx - cy(q) * sy +
                  (neighbour(z, -cz(q), Z, pz) - z)];
    } else {
#pragma unroll
      for (int q = 0; q < Q; ++q)
        v[q] = at(q, neighbour(x, -cx(q), X, px), neighbour(y, -cy(q), Y, py),
                  neighbour(z, -cz(q), Z, pz));
    }
    if (m == GEO_OUTFLOW_RIGHT || m == GEO_OUTFLOW_RIGHT_INTERP) {
      // the outflow pull rules read x-1 (and x) in place of x - c_x
      const int xm = neighbour(x, -1, X, px);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int ny = neighbour(y, -cy(q), Y, py), nz = neighbour(z, -cz(q), Z, pz);
        const float from_xm = at(q, xm, ny, nz);
        if (m == GEO_OUTFLOW_RIGHT)
          v[q] = from_xm;
        else if (cx(q) == -1)
          v[q] = CS * from_xm + ONE_MINUS_CS * at(q, x, ny, nz);
      }
    }
    site_collide<WELL, EQ>(v, m, p, rho, ux, uy, uz);
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) fout[base + (int64_t)q * Z] = v[q];
#pragma unroll
  for (int q = Q; q < QPAD; ++q) fout[base + (int64_t)q * Z] = 0.0f;
  if (rho_out != nullptr) {
    rho_out[site] = rho;
    u_out[site] = ux;
    u_out[N + site] = uy;
    u_out[2 * N + site] = uz;
  }
}

}  // namespace

#define AB_SITEMAJOR_KERNEL(NAME, WELL, EQ)                                                   \
  extern "C" __global__ void __launch_bounds__(THREADS)                                      \
      NAME(const float* __restrict__ fs, float* __restrict__ fout,                            \
           const uint8_t* __restrict__ map, float* __restrict__ rho, float* __restrict__ u,   \
           int Y, int Z, int periodic_bits, ABParams p) {                                     \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                      \
    if (z >= Z) return;                                                                       \
    ab_site_sitemajor<WELL, EQ>(fs, fout, map, rho, u, blockIdx.z, blockIdx.y, z, gridDim.z,  \
                                Y, Z, periodic_bits, p);                                      \
  }

AB_SITEMAJOR_KERNEL(ab_step_sitemajor_cum_well_kernel, true, EQ_WELL)
AB_SITEMAJOR_KERNEL(ab_step_sitemajor_cum_quad_kernel, false, EQ_QUAD)
AB_SITEMAJOR_KERNEL(ab_step_sitemajor_cum_invcum_kernel, false, EQ_INVCUM)

// Launches on `stream`; returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for an unknown variant.  fs, fout: [X, Y, 32, Z];
// periodic_bits: bit 0 x, bit 1 y, bit 2 z; variant as tnl_lbm_ab_step
// (0 CUM_WELL, 1 CUM with the quadratic equilibrium, 2 CUM with the
// inverse-cumulant one); rho and u may both be null (with_macro=False).
extern "C" int tnl_lbm_ab_step_sitemajor(const float* fs, float* fout, const uint8_t* map,
                                         float* rho, float* u, int X, int Y, int Z,
                                         int periodic_bits, int variant, float nu, float fx,
                                         float fy, float fz, float uin_x, float uin_y,
                                         float uin_z, int neumaier, void* stream) {
  using Kernel = void (*)(const float*, float*, const uint8_t*, float*, float*, int, int, int,
                          ABParams);
  static const Kernel kernels[3] = {ab_step_sitemajor_cum_well_kernel,
                                    ab_step_sitemajor_cum_quad_kernel,
                                    ab_step_sitemajor_cum_invcum_kernel};
  if (variant < 0 || variant > 2 || (rho == nullptr) != (u == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ABParams p{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier};
  const int block = Z >= THREADS ? THREADS : ((Z + 31) / 32) * 32;
  const dim3 grid((Z + block - 1) / block, Y, X);
  kernels[variant]<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(fs, fout, map, rho, u,
                                                                          Y, Z, periodic_bits, p);
  return static_cast<int>(cudaGetLastError());
}
