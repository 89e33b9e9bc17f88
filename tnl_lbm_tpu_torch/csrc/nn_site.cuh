// The non-Newtonian stencil shared by the NN force kernel (nn_force.cu, B9)
// and the one-kernel NN step (nn_step.cu, B10): the per-site formulas and the
// shared-memory tile both kernels evaluate them on.
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
// The tile: a block owns TX x TY x TZ sites, z fastest.  Its kernel fills u
// and the fluid mask on the tile and a 2-site ring in shared memory, each
// slot at its global coordinate wrapped or clamped under the hook's
// periodicity (the value at an out-of-domain slot is that of the clamped
// site: clamp the coordinate, never the value); tile_strain then evaluates
// S on the tile and a 1-site ring, where a slot outside the domain on a
// non-periodic axis of the hook takes S at the clamped coordinate (the
// hook's edge replication of S); tile_force gives F at a tile site.  u is
// read 3.375 times per site over the rings, (TX+4)(TY+4)(TZ+4) / (TX TY TZ),
// mostly from L2.  Shared memory: u (3 floats) and the mask on 8 x 12 x 36
// slots, S (6 floats) on 6 x 10 x 34, rho on the 1024 tile sites: 97 984 B,
// two blocks of 256 threads per SM in the 228 KB of an H100 SM.

#pragma once

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

// ---------------------------------------------------------------- the tile

constexpr int TX = 4, TY = 8, TZ = 32;
constexpr int TILE_THREADS = 256;
constexpr int UY = TY + 4, UZ = TZ + 4, NU_SLOTS = (TX + 4) * UY * UZ;
constexpr int SY = TY + 2, SZ = TZ + 2, NS_SLOTS = (TX + 2) * SY * SZ;
constexpr int NT = TX * TY * TZ;
constexpr int TILE_SMEM_BYTES = (3 * NU_SLOTS + 6 * NS_SLOTS + NT) * 4 + NU_SLOTS;

// g wrapped (periodic) or clamped into [0, n).
__device__ __forceinline__ int canonical(int g, int n, bool periodic) {
  if (periodic) {
    const int t = g % n;
    return t < 0 ? t + n : t;
  }
  return g < 0 ? 0 : (g >= n ? n - 1 : g);
}

// g clamped into [0, n) on a non-periodic axis, kept on a periodic one.
__device__ __forceinline__ int clamped(int g, int n, bool periodic) {
  return periodic ? g : (g < 0 ? 0 : (g >= n ? n - 1 : g));
}

// Slot strides along axis a of the u region and of the S region.
__device__ __forceinline__ int ustride(int a) { return a == 0 ? UY * UZ : (a == 1 ? UZ : 1); }
__device__ __forceinline__ int sstride(int a) { return a == 0 ? SY * SZ : (a == 1 ? SZ : 1); }

// A block's tile, its shared arrays carved from the dynamic shared memory.
struct Tile {
  float* u;        // [3][NU_SLOTS]: u of each slot of the tile + 2 ring
  float* S;        // [6][NS_SLOTS]: S of each slot of the tile + 1 ring
  float* rho;      // [NT]: rho of the tile sites (B10's u* pass)
  uint8_t* fluid;  // [NU_SLOTS]: map == FLUID of each slot of the u region
  int o[3];        // the tile's first site
  int n[3];        // X, Y, Z
  bool per[3];     // the hook's periodic axes
};

__device__ __forceinline__ Tile tile(float* smem, int X, int Y, int Z, int nn_bits) {
  Tile t;
  t.u = smem;
  t.S = t.u + 3 * NU_SLOTS;
  t.rho = t.S + 6 * NS_SLOTS;
  t.fluid = reinterpret_cast<uint8_t*>(t.rho + NT);
  t.o[0] = blockIdx.z * TX;
  t.o[1] = blockIdx.y * TY;
  t.o[2] = blockIdx.x * TZ;
  t.n[0] = X;
  t.n[1] = Y;
  t.n[2] = Z;
  t.per[0] = nn_bits & 1;
  t.per[1] = nn_bits & 2;
  t.per[2] = nn_bits & 4;
  return t;
}

// The canonical global coordinate c of u slot i, and the index j of the
// tile site it is (-1 on the ring).
__device__ __forceinline__ void u_slot(const Tile& t, int i, int (&c)[3], int& j) {
  const int l[3] = {i / (UZ * UY), (i / UZ) % UY, i % UZ};
  const int T[3] = {TX, TY, TZ};
  bool in_tile = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c[a] = canonical(t.o[a] + l[a] - 2, t.n[a], t.per[a]);
    in_tile = in_tile && l[a] >= 2 && l[a] < T[a] + 2;
  }
  j = in_tile ? ((l[0] - 2) * TY + (l[1] - 2)) * TZ + (l[2] - 2) : -1;
}

// S on the tile + 1 ring from u and the mask (after a __syncthreads that
// follows their fill).
__device__ __forceinline__ void tile_strain(const Tile& t) {
  for (int i = threadIdx.x; i < NS_SLOTS; i += blockDim.x) {
    const int l[3] = {i / (SZ * SY), (i / SZ) % SY, i % SZ};
    int c = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      c += (clamped(t.o[a] + l[a] - 1, t.n[a], t.per[a]) - t.o[a] + 2) * ustride(a);
    float S[6];
    strain([&](int b, int a, int s) { return t.u[b * NU_SLOTS + c + s * ustride(a)]; },
           [&](int a, int s) { return t.fluid[c + s * ustride(a)] != 0; }, S);
#pragma unroll
    for (int k = 0; k < 6; ++k) t.S[k * NS_SLOTS + i] = S[k];
  }
}

// The global coordinate c of tile site j; false when it lies outside the
// domain (a ragged tile).
__device__ __forceinline__ bool tile_site(const Tile& t, int j, int (&c)[3]) {
  c[0] = t.o[0] + j / (TZ * TY);
  c[1] = t.o[1] + (j / TZ) % TY;
  c[2] = t.o[2] + j % TZ;
  return c[0] < t.n[0] && c[1] < t.n[1] && c[2] < t.n[2];
}

// F at tile site j with density rho (after a __syncthreads that follows
// tile_strain).
__device__ __forceinline__ void tile_force(const Tile& t, const Rheology& r, int j, float rho,
                                           float (&F)[3]) {
  const int lx = j / (TZ * TY), ly = (j / TZ) % TY, lz = j % TZ;
  const int cs = ((lx + 1) * SY + (ly + 1)) * SZ + (lz + 1);
  const int cu = ((lx + 2) * UY + (ly + 2)) * UZ + (lz + 2);
  force(r, [&](int k, int a, int s) { return t.S[k * NS_SLOTS + cs + s * sstride(a)]; },
        [&](int a, int s) { return t.fluid[cu + s * ustride(a)] != 0; }, t.fluid[cu] != 0, rho,
        F);
}

}  // namespace nn
