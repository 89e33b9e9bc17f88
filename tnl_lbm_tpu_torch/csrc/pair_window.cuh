// Block geometry of the one-kernel A-A pair (aa_pair.cu) and of the probes
// that mirror it (probes.cu pair_pipeline / pair_compute_only).
//
// A block owns an output tile of TX x TY x TZ sites (z fastest) and works
// on its window: the tile plus a one-site halo, wrapped on periodic axes
// and clamped to the domain on the others.  Tiles at the high faces of a
// shape that no tile divides are partial; their threads beyond the domain
// are masked.

#pragma once

#include <cuda_runtime.h>

#include "lbm_site.cuh"

namespace lbm {
namespace pair {

constexpr int TX = 4, TY = 4, TZ = 32;                // output tile
constexpr int WX = TX + 2, WY = TY + 2, WZ = TZ + 2;  // window
constexpr int WSITES = WX * WY * WZ;                  // 1224
constexpr int THREADS = TX * TY * TZ;                 // one per tile site: 512
constexpr int SMEM_BYTES = Q * WSITES * (int)sizeof(float);  // float32 [Q][WSITES]: 132,192

inline dim3 grid(int X, int Y, int Z) {
  return dim3((Z + TZ - 1) / TZ, (Y + TY - 1) / TY, (X + TX - 1) / TX);
}

// Domain offset of window site w of block (bx, by, bz), or -1 beyond a
// partial tile.  periodic_bits: bit 0 x, 1 y, 2 z.
__device__ __forceinline__ int64_t window_site(int w, int bx, int by, int bz, int X, int Y,
                                               int Z, int periodic_bits) {
  const int x0 = bz * TX, y0 = by * TY, z0 = bx * TZ;
  const int lz = w % WZ, ly = (w / WZ) % WY, lx = w / (WZ * WY);
  if (lx > min(TX, X - x0) + 1 || ly > min(TY, Y - y0) + 1 || lz > min(TZ, Z - z0) + 1)
    return -1;
  return ((int64_t)neighbour(x0 - 1, lx, X, periodic_bits & 1) * Y +
          neighbour(y0 - 1, ly, Y, periodic_bits & 2)) * Z +
         neighbour(z0 - 1, lz, Z, periodic_bits & 4);
}

// This thread's tile site (lx, ly, lz) and its window index.
struct TileSite {
  int lx, ly, lz, w;
  __device__ TileSite()
      : lx(threadIdx.x / (TZ * TY)), ly((threadIdx.x / TZ) % TY), lz(threadIdx.x % TZ),
        w(((lx + 1) * WY + (ly + 1)) * WZ + (lz + 1)) {}
};

}  // namespace pair
}  // namespace lbm
