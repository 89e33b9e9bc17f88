// The two-kernel A-A pair for D3Q27 in float32 with the A-A boundary set:
// an even step that writes its result into a padded buffer, then an odd
// step that pulls from it, one thread per site in each.
//
// Replaces the Pallas kernels of tnl_lbm_tpu/kernels/fused_aa.py
// make_fused_pair_aa: its even kernel (even_kernel, pallas_call at :1274),
// which writes straight into the odd kernel's padded [Q, X+4, Y+16, Z]
// layout, the halo fill between the two (_fill_halos, :1302-1327), and its
// odd kernel (_build_odd_call, pallas_call at :287, with y_org = 8).
//
// The layout on this card: a padded [Q, X+2, Y+2, Z] buffer with a one-site
// ring in x and y (z is not padded: the odd step wraps or clamps z in its
// index arithmetic, as aa_odd.cu does).  The TPU's y origin of 8 and lane
// padding exist for its DMA rules and have no counterpart here.
//
// even (aa_pair_pad_even_*): per site, read the site's own 27 DFs, update
// them as aa_even_site does (lbm_site.cuh site_collide, then the opposite
// slots; NOTHING sites keep their DFs) and store them at the site's padded
// position.  A thread at an x or y edge also stores its values into every
// ring slot that mirrors it - wrapped on a periodic axis, edge-replicated
// otherwise - so the ring equals ops/streaming.py pad_halo of the even
// output along x and y, and no halo-fill pass runs.  Each ring slot has one
// source site, hence one writer.  The even step's rho and u are not
// written: the JAX pair discards them.
//
// odd (aa_pair_pad_odd_*): per site, pull f_in[q] = fpad[opp q](s - c_q)
// with plain x and y offsets into the padded buffer (no wrap or clamp in x
// and y; z as aa_odd.cu), OUTFLOW_RIGHT from x-1 of the buffer, update as
// aa_odd_site does and push into the unpadded output with its
// edge-replicated one-writer scatter; NOTHING sites copy their even-step
// DFs from the buffer and drop the pushes aimed at them.  rho and u come
// from this step.
//
// Instances: the three of the A-A steps (CUM_WELL; CUM with eq_quadratic;
// CUM with eq_inv_cum) for both kernels, and the odd kernel's lean
// CUM_WELL instance for a map of FLUID, WALL and NOTHING (aa_odd.cu's).
// The site updates are lbm_site.cuh's site_collide / stream_bc_collide and
// push_targets; aa_even_site and aa_odd_site stay as they are, so the
// instances of B2, B3 and B8 keep their code (a shared pull in ab_site had
// cost B7 eight registers, PERF.md section 6).
//
// Bound: HBM bytes.  The same work at its least moves B1's 233 B/site per
// pair (f in, f2 out, the map, rho and u).  This layout moves more: the
// even kernel reads 108 B and writes 108 (X+2)(Y+2)/(XY) B per site, the
// odd kernel reads that buffer and the map and writes 108 + 16 B, about
// 453 B/site per pair at 256^3.  threadIdx.x runs along z, so every
// component row is read and written as contiguous runs of a warp.
// Offsets are 64-bit.

#include <cuda_runtime.h>

#include "lbm_site.cuh"

using namespace lbm;

namespace {

// threads per block, along z
constexpr int THREADS = 128;

// The padded positions (1 + the site, and the ring slots 0 and n + 1 where
// they mirror the site) of coordinate s on an axis of extent n; -1 where a
// ring slot mirrors another site.  Slot 0 holds the site at -1 wrapped
// (periodic) or clamped, slot n + 1 the site at n.
__device__ __forceinline__ void ring_targets(int s, int n, bool periodic, int (&t)[3]) {
  t[0] = s + 1;
  t[1] = s == (periodic ? n - 1 : 0) ? 0 : -1;
  t[2] = s == (periodic ? 0 : n - 1) ? n + 1 : -1;
}

template <bool WELL, int EQ>
__device__ __forceinline__ void even_to_padded(const float* __restrict__ f,
                                               float* __restrict__ fpad,
                                               const uint8_t* __restrict__ map, int x, int y,
                                               int z, int X, int Y, int Z, int periodic_bits,
                                               const ABParams& p) {
  const int64_t N = (int64_t)X * Y * Z;
  const int64_t NP = (int64_t)(X + 2) * (Y + 2) * Z;
  const int64_t site = ((int64_t)x * Y + y) * Z + z;
  const uint8_t m = map[site];
  float v[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) v[q] = f[q * N + site];
  if (m != GEO_NOTHING) {
    float rho, ux, uy, uz;
    site_collide<WELL, EQ>(v, m, p, rho, ux, uy, uz);
    // the even write goes to the opposite slots: opposite directions are
    // the pairs (1, 2), (3, 4), ..., (25, 26)
#pragma unroll
    for (int q = 1; q < Q; q += 2) {
      const float t = v[q];
      v[q] = v[q + 1];
      v[q + 1] = t;
    }
  }
  int tx[3], ty[3];
  ring_targets(x, X, periodic_bits & 1, tx);
  ring_targets(y, Y, periodic_bits & 2, ty);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (tx[i] < 0) continue;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (ty[j] < 0) continue;
      const int64_t dst = ((int64_t)tx[i] * (Y + 2) + ty[j]) * Z + z;
#pragma unroll
      for (int q = 0; q < Q; ++q) fpad[q * NP + dst] = v[q];
    }
  }
}

// aa_odd_site with its reads from the padded buffer: plain x and y offsets,
// z wrapped or clamped; the update and the push are aa_odd_site's.
template <bool WELL, int EQ, bool LEAN>
__device__ __forceinline__ void odd_from_padded(const float* __restrict__ fpad,
                                                float* __restrict__ fout,
                                                const uint8_t* __restrict__ map,
                                                float* __restrict__ rho_out,
                                                float* __restrict__ u_out, int x, int y, int z,
                                                int X, int Y, int Z, int periodic_bits,
                                                bool has_nothing, const ABParams& p) {
  const int64_t N = (int64_t)X * Y * Z;
  const int64_t NP = (int64_t)(X + 2) * (Y + 2) * Z;
  const int64_t site = ((int64_t)x * Y + y) * Z + z;
  const int64_t psite = ((int64_t)(x + 1) * (Y + 2) + (y + 1)) * Z + z;
  const int64_t sxp = (int64_t)(Y + 2) * Z, syp = Z;
  const bool px = periodic_bits & 1, py = periodic_bits & 2, pz = periodic_bits & 4;
  const int64_t sx = (int64_t)Y * Z, sy = Z;

  float v[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q)
    v[q] = fpad[opp(q) * NP + psite - cx(q) * sxp - cy(q) * syp + (neighbour(z, -cz(q), Z, pz) - z)];
  const uint8_t m = map[site];
  if (!LEAN && m == GEO_OUTFLOW_RIGHT) {
    // every direction from x-1 (the ring slot at x = 0)
#pragma unroll
    for (int q = 0; q < Q; ++q)
      v[q] = fpad[opp(q) * NP + psite - sxp - cy(q) * syp + (neighbour(z, -cz(q), Z, pz) - z)];
  }
  float rho, ux, uy, uz;
  if constexpr (LEAN) stream_bc_collide(v, m, p, rho, ux, uy, uz);
  else site_collide<WELL, EQ>(v, m, p, rho, ux, uy, uz);

  // pushes aimed at a NOTHING site are dropped: its own thread restores it
  auto push = [&](int q, int64_t dst) {
    if (!(has_nothing && map[dst] == GEO_NOTHING)) fout[q * N + dst] = v[q];
  };
  const bool row_inside = x > 0 && x < X - 1 && y > 0 && y < Y - 1;
  if (row_inside) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      int tz0, tz1;
      push_targets(z, cz(q), Z, pz, tz0, tz1);
      const int64_t row = site - z + cx(q) * sx + cy(q) * sy;
      if (tz0 >= 0) push(q, row + tz0);
      if (tz1 >= 0) push(q, row + tz1);
    }
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      int tx[2], ty[2], tz[2];
      push_targets(x, cx(q), X, px, tx[0], tx[1]);
      push_targets(y, cy(q), Y, py, ty[0], ty[1]);
      push_targets(z, cz(q), Z, pz, tz[0], tz[1]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            if (tx[i] >= 0 && ty[j] >= 0 && tz[k] >= 0)
              push(q, ((int64_t)tx[i] * Y + ty[j]) * Z + tz[k]);
    }
  }
  if (m == GEO_NOTHING) {
#pragma unroll
    for (int q = 0; q < Q; ++q) fout[q * N + site] = fpad[q * NP + psite];
  }
  if (rho_out != nullptr) {
    rho_out[site] = rho;
    u_out[site] = ux;
    u_out[N + site] = uy;
    u_out[2 * N + site] = uz;
  }
}

}  // namespace

#define PAD_EVEN_KERNEL(NAME, WELL, EQ)                                                       \
  extern "C" __global__ void __launch_bounds__(THREADS)                                      \
      NAME(const float* __restrict__ f, float* __restrict__ fpad,                             \
           const uint8_t* __restrict__ map, int Y, int Z, int periodic_bits, ABParams p) {    \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                      \
    if (z >= Z) return;                                                                       \
    even_to_padded<WELL, EQ>(f, fpad, map, blockIdx.z, blockIdx.y, z, gridDim.z, Y, Z,        \
                             periodic_bits, p);                                               \
  }

#define PAD_ODD_KERNEL(NAME, WELL, EQ, LEAN)                                                  \
  extern "C" __global__ void __launch_bounds__(THREADS)                                      \
      NAME(const float* __restrict__ fpad, float* __restrict__ fout,                          \
           const uint8_t* __restrict__ map, float* __restrict__ rho, float* __restrict__ u,   \
           int Y, int Z, int periodic_bits, int has_nothing, ABParams p) {                    \
    const int z = blockIdx.x * blockDim.x + threadIdx.x;                                      \
    if (z >= Z) return;                                                                       \
    odd_from_padded<WELL, EQ, LEAN>(fpad, fout, map, rho, u, blockIdx.z, blockIdx.y, z,       \
                                    gridDim.z, Y, Z, periodic_bits, has_nothing != 0, p);     \
  }

PAD_EVEN_KERNEL(aa_pair_pad_even_cum_well_kernel, true, EQ_WELL)
PAD_EVEN_KERNEL(aa_pair_pad_even_cum_quad_kernel, false, EQ_QUAD)
PAD_EVEN_KERNEL(aa_pair_pad_even_cum_invcum_kernel, false, EQ_INVCUM)
PAD_ODD_KERNEL(aa_pair_pad_odd_kernel, true, EQ_WELL, true)
PAD_ODD_KERNEL(aa_pair_pad_odd_cum_well_kernel, true, EQ_WELL, false)
PAD_ODD_KERNEL(aa_pair_pad_odd_cum_quad_kernel, false, EQ_QUAD, false)
PAD_ODD_KERNEL(aa_pair_pad_odd_cum_invcum_kernel, false, EQ_INVCUM, false)

namespace {

dim3 site_grid(int X, int Y, int Z, int& block) {
  block = Z >= THREADS ? THREADS : ((Z + 31) / 32) * 32;
  return dim3((Z + block - 1) / block, Y, X);
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() of the launch,
// or cudaErrorInvalidValue for an unknown variant.  periodic_bits: bit 0 x,
// bit 1 y, bit 2 z.  variant as tnl_lbm_aa_odd: 0 CUM_WELL, 1 CUM with the
// quadratic equilibrium, 2 CUM with the inverse-cumulant one, 3 CUM_WELL on
// a FLUID/WALL/NOTHING map (the odd kernel's lean instance; the even
// kernel runs its CUM_WELL one).  fpad: [27, X+2, Y+2, Z].
extern "C" int tnl_lbm_aa_pair_pad_even(const float* f, float* fpad, const uint8_t* map, int X,
                                        int Y, int Z, int periodic_bits, int variant, float nu,
                                        float fx, float fy, float fz, float uin_x, float uin_y,
                                        float uin_z, int neumaier, void* stream) {
  using Kernel = void (*)(const float*, float*, const uint8_t*, int, int, int, ABParams);
  static const Kernel kernels[4] = {aa_pair_pad_even_cum_well_kernel,
                                    aa_pair_pad_even_cum_quad_kernel,
                                    aa_pair_pad_even_cum_invcum_kernel,
                                    aa_pair_pad_even_cum_well_kernel};
  if (variant < 0 || variant > 3) return static_cast<int>(cudaErrorInvalidValue);
  const ABParams p{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier};
  int block;
  const dim3 grid = site_grid(X, Y, Z, block);
  kernels[variant]<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(f, fpad, map, Y, Z,
                                                                           periodic_bits, p);
  return static_cast<int>(cudaGetLastError());
}

// rho and u may be null (with_macro=False): the odd kernel then writes f only.
extern "C" int tnl_lbm_aa_pair_pad_odd(const float* fpad, float* fout, const uint8_t* map,
                                       float* rho, float* u, int X, int Y, int Z,
                                       int periodic_bits, int has_nothing, int variant, float nu,
                                       float fx, float fy, float fz, float uin_x, float uin_y,
                                       float uin_z, int neumaier, void* stream) {
  using Kernel = void (*)(const float*, float*, const uint8_t*, float*, float*, int, int, int,
                          int, ABParams);
  static const Kernel kernels[4] = {aa_pair_pad_odd_cum_well_kernel,
                                    aa_pair_pad_odd_cum_quad_kernel,
                                    aa_pair_pad_odd_cum_invcum_kernel, aa_pair_pad_odd_kernel};
  if (variant < 0 || variant > 3 || (rho == nullptr) != (u == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ABParams p{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, uin_x, uin_y, uin_z, neumaier};
  int block;
  const dim3 grid = site_grid(X, Y, Z, block);
  kernels[variant]<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      fpad, fout, map, rho, u, Y, Z, periodic_bits, has_nothing, p);
  return static_cast<int>(cudaGetLastError());
}
