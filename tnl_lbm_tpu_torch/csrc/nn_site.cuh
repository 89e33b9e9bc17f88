// The non-Newtonian stencil shared by the NN force kernel (nn_force.cu, B9)
// and the one-kernel NN step (nn_step.cu, B10): the per-site formulas and the
// x-marching plane pipeline both kernels evaluate them on.
//
// CUDA counterpart of tnl_lbm_tpu_torch/ops/non_newtonian.py (the plain
// version of both kernels): the wall-aware derivative (_wall_aware_derivative,
// reference nonNewtonian.h:326-391), the strain-rate tensor S
// (strain_rate_tensor), the shear rate gamma (shear_rate_magnitude), the
// Carreau-Yasuda and Casson viscosities and F = 2 (nu_eff - nu) rho div(S)
// (make_nn_forcing_hook, reference nonNewtonian.h:690-788).  The callers
// hand in the neighbour values: every neighbour read goes to the neighbour
// coordinate under the hook's own periodicity - wrapped on a periodic axis,
// clamped to the edge otherwise - for u, the fluid mask and S alike, which
// is the hook's _pad1 of u, of the mask and of S.
//
// The sums and products follow the plain version term for term, with the
// _rn intrinsics where nvcc would otherwise contract a product and a sum
// into one fused multiply-add; powf and sqrtf are the accurate ones (no
// fast math).
//
// The march.  A block owns a y-z column tile of TY x TZ sites (z fastest,
// one thread a site; TY is the including kernel's NN_TY: B9 8, B10 16) and
// an x segment [xs, xe) of at most SEG_MAX planes, and walks it plane by
// plane, one step per plane ending in one block barrier.  Step j, for the
// planes p = 0 .. L + 3 of x = xs - 2 + p (L = xe - xs):
//
//   - u of plane j on the tile and its 2-site y-z ring (UY x UZ slots), and
//     the fluid mask, into a ring of U_PLANES planes: each slot at its
//     coordinate wrapped or clamped under the hook's periodicity (the value
//     at an out-of-domain slot is that of the clamped site: clamp the
//     coordinate, never the value).  B9 reads u; B10 computes u* (and rho
//     of the tile sites, into a ring of RHO_PLANES planes);
//   - S of plane j - S_LAG on the tile and its 1-site y-z ring (SY x SZ
//     slots), into a ring of S_PLANES planes, from the u planes on either
//     side.  A slot outside the domain on a non-periodic y or z axis of the
//     hook takes S at the clamped coordinate (the hook's edge replication of
//     S): it reads the u slots around the clamped one;
//   - F of plane j - F_LAG on the tile; along x its S neighbours are the
//     planes on either side, clamped to the plane itself at a closed face of
//     the hook (the same edge replication, taken by the reader).
//
// The haloed mode (HALO, the sharded lattice's B9 and B10 on a shard's
// block; JAX make_sharded_fused_nn_step, the GSPMD hook of
// make_sharded_hooked_fused_step): the arrays hold the block with an H-wide
// x/y halo (Halo), the neighbour shards' layers, and the march walks a region
// of block coordinates - the block, or for B10's odd mode the block and its
// 1-site ring where a face is a seam.  A coordinate is the block coordinate
// itself, read from the halo, except on a closed face (a face of the domain
// on which the hook does not wrap, gbits), where it is clamped to the edge
// as in the unsharded march: the seams read neighbour data, the domain's
// closed faces edge-replicate u, the mask and S.  z keeps the unsharded
// rule.  The coordinates of slots no region site reads are clamped into
// the halo (lim), never outside the arrays.
//
// The lags let one step's three parts run between the same two barriers:
// each ring plane a step writes was last read in an earlier step (the CPU
// model in tests/test_torch_nn_march.py checks every lifetime).  Each u, S
// and mask value is computed once per plane and block; the redundant work
// left is the y-z ring, UY UZ / (TY TZ) u slots a site (1.69 at 8 x 32,
// 1.41 at 16 x 32) and SY SZ / (TY TZ) S slots (1.33, 1.20), and 4 extra u
// planes per segment.  The coordinates of a thread's slots within a plane
// are fixed for the whole march, so each is computed once, before it.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "lbm_site.cuh"

namespace nn {

constexpr int CARREAU_YASUDA = 0;
constexpr int CASSON = 1;

// The rheology of a hook (ops/non_newtonian.py CarreauYasuda, Casson) at the
// lattice viscosity nu; the host rounds each constant once to float.
struct Rheology {
  int model;
  float nu;            // lattice viscosity
  float nu0_minus_nu;  // CY: nu0 - nu
  float lam, a, expo;  // CY: lambda, a, (n - 1) / a
  float k0, k1;        // Casson
};

// nu_eff = nu + (nu0 - nu) (1 + (gamma lambda)^a)^((n - 1) / a) (CY), or
// (k0 + k1 sqrt(gamma))^2 / sqrt(gamma), nu at rest (Casson).
__device__ __forceinline__ float nu_eff(const Rheology& r, float gamma) {
  if (r.model == CARREAU_YASUDA) {
    const float t = powf(__fadd_rn(1.0f, powf(__fmul_rn(gamma, r.lam), r.a)), r.expo);
    return __fadd_rn(r.nu, __fmul_rn(r.nu0_minus_nu, t));
  }
  const float sg = sqrtf(gamma);
  const float safe = fmaxf(sg, 1e-10f);
  const float t = __fadd_rn(r.k0, __fmul_rn(r.k1, sg));
  return sg > 1e-10f ? __fmul_rn(t, t) / safe : r.nu;
}

// One-sided differences where a neighbour is not fluid, central where both
// are, zero where neither is.
__device__ __forceinline__ float wall_aware(float gp, float gm, float c, bool flp, bool flm) {
  if (flp && flm) return 0.5f * (gp - gm);
  if (flp) return gp - c;
  if (flm) return c - gm;
  return 0.0f;
}

// Component index of S[(a, b)] in the six stored ones: (0,0) (0,1) (0,2)
// (1,1) (1,2) (2,2).
__host__ __device__ constexpr int sidx(int a, int b) {
  return a > b ? sidx(b, a) : (a == 0 ? b : (a == 1 ? 2 + b : 5));
}

// S at a site: u_at(b, a, s) is component b of u at the face neighbour
// along axis a on side s = +1 / -1 (s = 0: the site), fl_at(a, s) that
// neighbour's fluidity.
template <class UAt, class FlAt>
__device__ __forceinline__ void strain(UAt u_at, FlAt fl_at, float (&S)[6]) {
  float g[3][3];  // [derivative axis][velocity component]
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const bool flp = fl_at(a, 1), flm = fl_at(a, -1);
#pragma unroll
    for (int b = 0; b < 3; ++b) g[a][b] = wall_aware(u_at(b, a, 1), u_at(b, a, -1), u_at(b, a, 0),
                                                    flp, flm);
  }
  S[0] = g[0][0];
  S[1] = 0.5f * (g[0][1] + g[1][0]);
  S[2] = 0.5f * (g[0][2] + g[2][0]);
  S[3] = g[1][1];
  S[4] = 0.5f * (g[1][2] + g[2][1]);
  S[5] = g[2][2];
}

// F = 2 (nu_eff - nu) rho div(S) at a site, 0 where it is not fluid:
// s_at(k, a, s) is component k of S at the face neighbour along axis a on
// side s (s = 0: the site), fl_at(a, s) that neighbour's fluidity.
template <class SAt, class FlAt>
__device__ __forceinline__ void force(const Rheology& r, SAt s_at, FlAt fl_at, bool fluid,
                                      float rho, float (&F)[3]) {
  const float s00 = s_at(0, 0, 0), s01 = s_at(1, 0, 0), s02 = s_at(2, 0, 0);
  const float s11 = s_at(3, 0, 0), s12 = s_at(4, 0, 0), s22 = s_at(5, 0, 0);
  const float diag = __fadd_rn(__fadd_rn(__fmul_rn(s00, s00), __fmul_rn(s11, s11)),
                               __fmul_rn(s22, s22));
  const float off = __fadd_rn(__fadd_rn(__fmul_rn(s01, s01), __fmul_rn(s02, s02)),
                              __fmul_rn(s12, s12));
  const float gamma = sqrtf(__fadd_rn(diag, 2.0f * off));
  const float scale = 2.0f * (nu_eff(r, gamma) - r.nu);
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    float div = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int k = sidx(a, b);
      div = div + wall_aware(s_at(k, a, 1), s_at(k, a, -1), s_at(k, a, 0), fl_at(a, 1),
                             fl_at(a, -1));
    }
    F[b] = fluid ? __fmul_rn(__fmul_rn(scale, div), rho) : 0.0f;
  }
}

// ---------------------------------------------------------------- the march

// The column tile's height is the including kernel's: NN_TY, 8 in B9
// (nn_force.cu), 16 in B10 (nn_step.cu).
#ifndef NN_TY
#error "define NN_TY, the column tile's height, before including nn_site.cuh"
#endif
constexpr int TY = NN_TY, TZ = 32;          // column tile
constexpr int THREADS = TY * TZ;            // one thread per tile site: 256 (B9), 512 (B10)
constexpr int UY = TY + 4, UZ = TZ + 4;     // u plane: the tile and a 2-site ring
constexpr int U_SLOTS = UY * UZ;            // 432 (B9), 720 (B10)
constexpr int SY = TY + 2, SZ = TZ + 2;     // S plane: the tile and a 1-site ring
constexpr int S_SLOTS = SY * SZ;            // 340 (B9), 612 (B10)
constexpr int U_PER_THREAD = (U_SLOTS + THREADS - 1) / THREADS;  // 2
constexpr int S_PER_THREAD = (S_SLOTS + THREADS - 1) / THREADS;  // 2
constexpr int S_LAG = 2;                    // step j evaluates S of plane j - 2
constexpr int F_LAG = 4;                    // and F of plane j - 4
constexpr int U_PLANES = 6, S_PLANES = 4, RHO_PLANES = 5;
constexpr int SEG_MAX = 32;                 // x planes a block marches at most
constexpr int STEP_BLOCKS_PER_SM = 1;       // B10's launch bound: 128 registers a thread
constexpr int FORCE_BLOCKS_PER_SM = 3;      // B9's
// Dynamic shared memory: u [U_PLANES][3][U_SLOTS] and S [S_PLANES][6][S_SLOTS]
// floats, B10's rho [RHO_PLANES][THREADS], the slot tables (the canonical y
// and z of each u slot, the u slot each S slot reads around), then the mask
// [U_PLANES][U_SLOTS] bytes: B9 69 424 B at 8 x 32 (three blocks per SM),
// B10 130 480 B at 16 x 32 (one).
constexpr int RING_FLOATS = U_PLANES * 3 * U_SLOTS + S_PLANES * 6 * S_SLOTS;
constexpr int TABLE_INTS = U_SLOTS + S_SLOTS;
constexpr int FORCE_SMEM_BYTES = (RING_FLOATS + TABLE_INTS) * 4 + U_PLANES * U_SLOTS;
constexpr int STEP_SMEM_BYTES =
    (RING_FLOATS + RHO_PLANES * THREADS + TABLE_INTS) * 4 + U_PLANES * U_SLOTS;

// g wrapped (periodic) or clamped into [0, n).
__host__ __device__ __forceinline__ int canonical(int g, int n, bool periodic) {
  if (periodic) {
    const int t = g % n;
    return t < 0 ? t + n : t;
  }
  return g < 0 ? 0 : (g >= n ? n - 1 : g);
}

// g clamped into [0, n) on a non-periodic axis, kept on a periodic one.
__host__ __device__ __forceinline__ int clamped(int g, int n, bool periodic) {
  return periodic ? g : (g < 0 ? 0 : (g >= n ? n - 1 : g));
}

// The column tiles of a Y x Z plane.
__host__ __device__ __forceinline__ int column_tiles(int Y, int Z) {
  return ((Y + TY - 1) / TY) * ((Z + TZ - 1) / TZ);
}

// The SMs of the current device (132, an H100 SXM's, where it cannot be read).
static inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// The launch of the including kernel at a shape.  A block's x segment is at
// most SEG_MAX planes, and short enough that the blocks fill the card
// (blocks_per_sm on every SM) when the column tiles alone do not: down to
// one plane on a small lattice, whose few blocks then march 7 steps each
// (tests/nn_ablation.py: on four lattices from 4 x 4 x 21 to 128 x 64 x 64
// the rule's choice ran as fast as the fastest of 1, 2, 4 and 8 planes).
// Static: each source that includes the header has its own tile height.
struct Launch {
  int seg_len, segments, blocks;
};
static inline Launch launch(int X, int Y, int Z, int blocks_per_sm) {
  const int cols = column_tiles(Y, Z);
  const int segs = std::max(1, std::min(X, (sm_count() * blocks_per_sm + cols - 1) / cols));
  const int seg = std::min(SEG_MAX, (X + segs - 1) / segs);
  const int n = (X + seg - 1) / seg;
  return {seg, n, cols * n};
}

// The launch geometry that tnl_lbm_nn_info (nn_step.cu) reports, into out.
static inline int launch_info(int X, int Y, int Z, int blocks_per_sm, int smem_bytes, int* out) {
  const Launch l = launch(X, Y, Z, blocks_per_sm);
  const int vals[7] = {smem_bytes, TY, TZ, l.seg_len, l.segments, column_tiles(Y, Z),
                       blocks_per_sm};
  for (int k = 0; k < 7; ++k) out[k] = vals[k];
  return 0;
}

// The haloed mode's geometry (HALO): the arrays' halo width, the region's
// origin and the block's extent in block coordinates, the closed faces (bit
// 0 low x, 1 high x, 2 low y, 3 high y) and how far beyond the block a slot
// coordinate may lie (lim: H less the one site a u* pull reads beyond it).
struct Halo {
  int H, lim;
  int ox, oy;
  int bX, bY;
  int gbits;
};

// Block coordinate g along axis a (0 x, 1 y) as an index of the haloed
// arrays: clamped to the edge on a closed face, kept in the halo elsewhere.
__host__ __device__ __forceinline__ int hcoord(const Halo& h, int g, int a) {
  const int n = a == 0 ? h.bX : h.bY;
  if (((h.gbits >> (2 * a)) & 1) && g < 0) g = 0;
  if (((h.gbits >> (2 * a + 1)) & 1) && g >= n) g = n - 1;
  g = g < -h.lim ? -h.lim : (g > n - 1 + h.lim ? n - 1 + h.lim : g);
  return g + h.H;
}

// A block's march: its rings and slot tables carved from the dynamic shared
// memory, its tile and its segment.  The slot tables hold what is fixed for
// the whole march, so that no thread keeps it in registers across the site
// update.
struct March {
  float* u;        // [U_PLANES][3][U_SLOTS]
  float* S;        // [S_PLANES][6][S_SLOTS]
  float* rho;      // [RHO_PLANES][THREADS] (B10)
  unsigned* uyz;   // [U_SLOTS]: canonical y << 16 | z of each u slot
  int* scu;        // [S_SLOTS]: the u slot at which each S slot's S is taken
  uint8_t* fluid;  // [U_PLANES][U_SLOTS]: map == FLUID
  int y0, z0;      // the tile's first site
  int xs, xe;      // the segment
  int X, Y, Z;     // the region's extent (HALO: the march's region; else the lattice)
  bool per[3];     // the hook's periodic axes
  Halo h;          // HALO: the haloed arrays and the region
};

// Slot pass k of thread t: u slots in order; S slots in order on the first
// pass and from the end on the second, so that the threads with two u slots
// are not those with two S slots.
__device__ __forceinline__ int u_slot_of(int t, int k) { return k * THREADS + t; }
__device__ __forceinline__ int s_slot_of(int t, int k) {
  return k == 0 ? t : k * THREADS + (THREADS - 1 - t);
}

// The block's march; fills the slot tables and ends in a block barrier.
// HALO: X and Y are the region's extent, h its geometry; a u slot's table
// entry holds its y as an index of the haloed arrays.
template <bool HALO = false>
__device__ __forceinline__ March march(void* smem, bool with_rho, int X, int Y, int Z,
                                       int nn_bits, int seg_len, Halo h = Halo{}) {
  March m;
  m.u = static_cast<float*>(smem);
  m.S = m.u + U_PLANES * 3 * U_SLOTS;
  m.rho = m.S + S_PLANES * 6 * S_SLOTS;
  m.uyz = reinterpret_cast<unsigned*>(m.rho + (with_rho ? RHO_PLANES * THREADS : 0));
  m.scu = reinterpret_cast<int*>(m.uyz + U_SLOTS);
  m.fluid = reinterpret_cast<uint8_t*>(m.scu + S_SLOTS);
  m.X = X;
  m.Y = Y;
  m.Z = Z;
  m.per[0] = nn_bits & 1;
  m.per[1] = nn_bits & 2;
  m.per[2] = nn_bits & 4;
  // block b: column tile b mod ncol of segment b / ncol, so the blocks that
  // run together walk the same x and share their ring rows in L2
  const int nzt = (Z + TZ - 1) / TZ, ncol = column_tiles(Y, Z);
  const int col = blockIdx.x % ncol, seg = blockIdx.x / ncol;
  m.y0 = (col / nzt) * TY;
  m.z0 = (col % nzt) * TZ;
  m.xs = seg * seg_len;
  m.xe = min(m.xs + seg_len, X);
  if constexpr (HALO) {
    m.h = h;
    const int yb = h.oy + m.y0;  // the tile's first y in block coordinates
    for (int i = threadIdx.x; i < U_SLOTS; i += THREADS)
      m.uyz[i] = unsigned(hcoord(h, yb + i / UZ - 2, 1)) << 16 |
                 unsigned(canonical(m.z0 + i % UZ - 2, Z, m.per[2]));
    for (int i = threadIdx.x; i < S_SLOTS; i += THREADS) {
      int y = yb + i / SZ - 1;  // S is replicated from the edge on a closed y face only
      if ((h.gbits & 4) && y < 0) y = 0;
      if ((h.gbits & 8) && y >= h.bY) y = h.bY - 1;
      m.scu[i] = (y - yb + 2) * UZ + (clamped(m.z0 + i % SZ - 1, Z, m.per[2]) - m.z0 + 2);
    }
  } else {
    for (int i = threadIdx.x; i < U_SLOTS; i += THREADS)
      m.uyz[i] = unsigned(canonical(m.y0 + i / UZ - 2, Y, m.per[1])) << 16 |
                 unsigned(canonical(m.z0 + i % UZ - 2, Z, m.per[2]));
    for (int i = threadIdx.x; i < S_SLOTS; i += THREADS)
      m.scu[i] = (clamped(m.y0 + i / SZ - 1, Y, m.per[1]) - m.y0 + 2) * UZ +
                 (clamped(m.z0 + i % SZ - 1, Z, m.per[2]) - m.z0 + 2);
  }
  __syncthreads();
  return m;
}

// The tile site of this thread: (ly, lz), and whether it lies in the domain.
__device__ __forceinline__ bool tile_site(const March& m, int& ly, int& lz) {
  ly = threadIdx.x / TZ;
  lz = threadIdx.x % TZ;
  return m.y0 + ly < m.Y && m.z0 + lz < m.Z;
}

// The canonical x of plane p (x = xs - 2 + p) under the hook's periodicity;
// HALO: the plane's x (block coordinate ox + xs - 2 + p) as an index of the
// haloed arrays.
template <bool HALO = false>
__device__ __forceinline__ int plane_x(const March& m, int p) {
  if constexpr (HALO) return hcoord(m.h, m.h.ox + m.xs - 2 + p, 0);
  return canonical(m.xs - 2 + p, m.X, m.per[0]);
}

// The tile site of u slot i (-1 on the ring).
__device__ __forceinline__ int u_tile_site(int i) {
  const int ly = i / UZ - 2, lz = i % UZ - 2;
  return ly >= 0 && ly < TY && lz >= 0 && lz < TZ ? ly * TZ + lz : -1;
}

// u of slot i of plane p (its ring plane) and its fluidity.
__device__ __forceinline__ void put_u(const March& m, int p, int i, float ux, float uy,
                                      float uz, bool fluid) {
  float* u = m.u + (p % U_PLANES) * 3 * U_SLOTS + i;
  u[0] = ux;
  u[U_SLOTS] = uy;
  u[2 * U_SLOTS] = uz;
  m.fluid[(p % U_PLANES) * U_SLOTS + i] = fluid;
}

// S of plane q (1 <= q) on this thread's S slots, from u planes q - 1 .. q + 1.
__device__ __forceinline__ void strain_plane(const March& m, int q) {
  const float* u[3];
  const uint8_t* fl[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    u[d] = m.u + ((q - 1 + d) % U_PLANES) * 3 * U_SLOTS;
    fl[d] = m.fluid + ((q - 1 + d) % U_PLANES) * U_SLOTS;
  }
  float* Sq = m.S + (q % S_PLANES) * 6 * S_SLOTS;
#pragma unroll
  for (int k = 0; k < S_PER_THREAD; ++k) {
    const int i = s_slot_of(threadIdx.x, k);
    if (i >= S_SLOTS) continue;
    const int c = m.scu[i];
    // neighbour s along axis a: x from the planes, y and z within one
    auto at = [&](int a, int s) { return a == 0 ? 1 + s : 1; };
    auto off = [&](int a, int s) { return a == 1 ? s * UZ : (a == 2 ? s : 0); };
    float S[6];
    strain([&](int b, int a, int s) { return u[at(a, s)][b * U_SLOTS + c + off(a, s)]; },
           [&](int a, int s) { return fl[at(a, s)][c + off(a, s)] != 0; }, S);
#pragma unroll
    for (int e = 0; e < 6; ++e) Sq[e * S_SLOTS + i] = S[e];
  }
}

// F at tile site (ly, lz) of plane p (x = xs - 2 + p, in the domain; HALO:
// x its block coordinate) with density rho.
template <bool HALO = false>
__device__ __forceinline__ void force_at(const March& m, const Rheology& r, int p, int x, int ly,
                                         int lz, float rho, float (&F)[3]) {
  // along x the S neighbours of a closed face are the face plane itself
  int pm, pp;
  if constexpr (HALO) {
    pm = ((m.h.gbits & 1) && x == 0) ? p : p - 1;
    pp = ((m.h.gbits & 2) && x == m.h.bX - 1) ? p : p + 1;
  } else {
    pm = (!m.per[0] && x == 0) ? p : p - 1;
    pp = (!m.per[0] && x == m.X - 1) ? p : p + 1;
  }
  const float* S[3] = {m.S + (pm % S_PLANES) * 6 * S_SLOTS, m.S + (p % S_PLANES) * 6 * S_SLOTS,
                       m.S + (pp % S_PLANES) * 6 * S_SLOTS};
  const uint8_t* fl[3] = {m.fluid + ((p - 1) % U_PLANES) * U_SLOTS,
                          m.fluid + (p % U_PLANES) * U_SLOTS,
                          m.fluid + ((p + 1) % U_PLANES) * U_SLOTS};
  const int cs = (ly + 1) * SZ + (lz + 1);
  const int cu = (ly + 2) * UZ + (lz + 2);
  auto at = [&](int a, int s) { return a == 0 ? 1 + s : 1; };
  force(r,
        [&](int k, int a, int s) {
          return S[at(a, s)][k * S_SLOTS + cs + (a == 1 ? s * SZ : (a == 2 ? s : 0))];
        },
        [&](int a, int s) {
          return fl[at(a, s)][cu + (a == 1 ? s * UZ : (a == 2 ? s : 0))] != 0;
        },
        fl[1][cu] != 0, rho, F);
}

}  // namespace nn
