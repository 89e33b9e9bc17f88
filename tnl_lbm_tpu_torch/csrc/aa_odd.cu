// A-A odd step for D3Q27 CUM_WELL in float32, one thread per source site.
//
// Replaces the Pallas kernel of tnl_lbm_tpu/kernels/fused_aa.py
// _build_odd_call (odd_kernel, pallas_call at :287).  Per site s: pull the
// opposite components from the neighbours, f_in[q](s) = f[opp q](s - c_q)
// (reference streaming_AA.h:47-76), apply the WALL swap, take the moments,
// collide, and push f_post[q](s) to the neighbours.  The JAX step defines
// the push as f_out = pull(pad_halo(f_post)) with edge replication on the
// non-periodic axes (sim/step.py:224): destination x takes component q from
// the unique source clamp(x - c_q) (a wrap on periodic axes).  Read as a
// scatter, source s writes q to s + c_q when that lies in the domain and,
// on every non-periodic axis where s is the first layer and c = +1 or the
// last layer and c = -1, also to the layer s itself: up to 8 destinations
// at a corner, each destination with exactly one writer.  The pull clamps
// the same way.  NOTHING sites keep their stored DFs: their thread copies
// its own 27 values and pushes aimed at a NOTHING destination are dropped.
// The kernel writes out of place into a second buffer; an in-place odd
// step would race at the edge-replicated layers.
//
// Bound: HBM bytes.  Per site and step 27 f32 are read and 27 written
// (216 B), plus the map and the 16 B of rho and u.  threadIdx.x runs along
// z, the fastest axis, so for each component the neighbour reads and the
// pushed writes of a warp are contiguous runs shifted by c_z.  The cascade
// runs in registers; no shared memory.  Offsets are 64-bit.

#include <cuda_runtime.h>

#include "lbm_site.cuh"

using namespace lbm;

extern "C" __global__ void __launch_bounds__(128)
aa_odd_kernel(const float* __restrict__ f, float* __restrict__ fout,
              const uint8_t* __restrict__ map, float* __restrict__ rho_out,
              float* __restrict__ u_out, int Y, int Z, int periodic_bits,
              int has_nothing, SiteParams p) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  if (z >= Z) return;
  const int X = gridDim.z;
  const int x = blockIdx.z, y = blockIdx.y;
  const int64_t N = (int64_t)X * Y * Z;
  const int64_t site = ((int64_t)x * Y + y) * Z + z;
  const bool px = periodic_bits & 1, py = periodic_bits & 2, pz = periodic_bits & 4;
  // A block is one (x, y) row.  Rows away from the x and y faces (all but
  // a thin shell) take the short path: their x and y neighbours are plain
  // offsets, and only z needs the wrap/clamp and edge-replication rules.
  const bool row_inside = x > 0 && x < X - 1 && y > 0 && y < Y - 1;
  const int64_t sx = (int64_t)Y * Z, sy = Z;

  float v[Q];
  if (row_inside) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
      v[q] = f[opp(q) * N + site - cx(q) * sx - cy(q) * sy + (neighbour(z, -cz(q), Z, pz) - z)];
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int nx = neighbour(x, -cx(q), X, px);
      const int ny = neighbour(y, -cy(q), Y, py);
      const int nz = neighbour(z, -cz(q), Z, pz);
      v[q] = f[opp(q) * N + ((int64_t)nx * Y + ny) * Z + nz];
    }
  }
  const uint8_t m = map[site];
  float rho, ux, uy, uz;
  stream_bc_collide(v, m, p, rho, ux, uy, uz);

  // pushes aimed at a NOTHING site are dropped: its own thread restores it
  auto push = [&](int q, int64_t dst) {
    if (!(has_nothing && map[dst] == GEO_NOTHING)) fout[q * N + dst] = v[q];
  };
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
    for (int q = 0; q < Q; ++q) fout[q * N + site] = f[q * N + site];
  }
  rho_out[site] = rho;
  u_out[site] = ux;
  u_out[N + site] = uy;
  u_out[2 * N + site] = uz;
}

// Launches on `stream`; returns cudaGetLastError() of the launch.
// periodic_bits: bit 0 x, bit 1 y, bit 2 z.
extern "C" int tnl_lbm_aa_odd(const float* f, float* fout, const uint8_t* map, float* rho,
                              float* u, int X, int Y, int Z, int periodic_bits,
                              int has_nothing, float nu, float fx, float fy, float fz,
                              int neumaier, void* stream) {
  const SiteParams p{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, neumaier};
  const int block = Z >= 128 ? 128 : ((Z + 31) / 32) * 32;
  const dim3 grid((Z + block - 1) / block, Y, X);
  aa_odd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      f, fout, map, rho, u, Y, Z, periodic_bits, has_nothing, p);
  return static_cast<int>(cudaGetLastError());
}
