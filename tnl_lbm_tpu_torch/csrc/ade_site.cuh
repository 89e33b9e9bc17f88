// Per-site D3Q7 advection-diffusion (ADE) update, shared by the ADE step
// (ade_step.cu) and the coupled NSE+ADE step (coupled_ab.cu).
//
// CUDA counterpart of tnl_lbm_tpu/kernels/fused_ade.py _ade_tile_body (the
// A-B pattern) with the four D3Q7 collisions of
// tnl_lbm_tpu/ops/collision_ade.py; their plain PyTorch versions are
// tnl_lbm_tpu_torch/kernels/fused_ade.py _ade_tile_body and
// tnl_lbm_tpu_torch/ops/collision_ade.py.  One thread owns one site; its 7
// DFs live in registers.  All arithmetic is float32.

#pragma once

#include <cstdint>

#include "lbm_site.cuh"

namespace lbm {

constexpr int AQ = 7;

// ADEGEO codes (tnl_lbm_tpu/sim/step_ade.py; reference d3q7/bc.h:17-37)
constexpr uint8_t ADE_FLUID = 0;
constexpr uint8_t ADE_WALL = 1;
constexpr uint8_t ADE_WALL_BODY = 2;
constexpr uint8_t ADE_SOLID = 3;
constexpr uint8_t ADE_TRANSFER_FS = 4;
constexpr uint8_t ADE_TRANSFER_SF = 5;
constexpr uint8_t ADE_TRANSFER_SW = 6;
constexpr uint8_t ADE_INFLOW = 7;
constexpr uint8_t ADE_OUTFLOW_RIGHT = 8;
constexpr uint8_t ADE_PERIODIC = 9;
constexpr uint8_t ADE_NOTHING = 10;
constexpr uint8_t ADE_OUTFLOW_PE = 11;
constexpr uint8_t ADE_SYM_TOP = 12;
constexpr uint8_t ADE_SYM_BOTTOM = 13;
constexpr uint8_t ADE_SYM_LEFT = 14;
constexpr uint8_t ADE_SYM_RIGHT = 15;
constexpr uint8_t ADE_SYM_BACK = 16;
constexpr uint8_t ADE_SYM_FRONT = 17;

// The collisions (ops/collision_ade.py COLLISIONS_D3Q7); SRT relaxes to the
// local quadratic equilibrium (fused_ade.py use_local_eq).
constexpr int ADE_SRT = 0;
constexpr int ADE_MRT = 1;
constexpr int ADE_CLBM = 2;
constexpr int ADE_CLBM_RS = 3;

// D3Q7 directions in the descriptor's order: zzz, pzz, mzz, zpz, zmz, zzp,
// zzm.  Axis a has its plus direction at 2a + 1 and its minus at 2a + 2;
// opposites are neighbours, as in D3Q27.
__host__ __device__ constexpr int acq(int q, int a) {
  return q == 2 * a + 1 ? 1 : (q == 2 * a + 2 ? -1 : 0);
}
__host__ __device__ constexpr int aopp(int q) { return q == 0 ? 0 : ((q & 1) ? q + 1 : q - 1); }
__host__ __device__ constexpr float aweight(int q) { return q == 0 ? 0.25f : 0.125f; }

// Codes on which the collision runs (step_ade.py _COLLIDING).
__device__ __forceinline__ bool ade_collides(uint8_t m) {
  return m == ADE_FLUID || m == ADE_PERIODIC || m == ADE_SOLID || m == ADE_TRANSFER_FS ||
         m == ADE_TRANSFER_SF || m == ADE_TRANSFER_SW || m == ADE_OUTFLOW_RIGHT;
}

// Quadratic equilibrium with cs^2 = 1/4 (fused_ade.py _eq_local_ade):
// w_q phi (1 + 4 c.u + 8 (c.u)^2 - 2 u.u).
__device__ __forceinline__ float ade_eq(int q, float phi, float ux, float uy, float uz) {
  const float uu = ux * ux + uy * uy + uz * uz;
  if (q == 0) return aweight(0) * phi * (1.0f - 2.0f * uu);
  const float v = q <= 2 ? ux : (q <= 4 ? uy : uz);
  const float cu = (q & 1) ? v : -v;
  return aweight(q) * phi * (1.0f + 4.0f * cu + 8.0f * cu * cu - 2.0f * uu);
}

// The collision of kind COLL in place on the 7 DFs, at concentration phi,
// velocity u and relaxation rate omega = 1 / (1/2 + 4 nu).
template <int COLL>
__device__ __forceinline__ void ade_collide(float (&g)[AQ], float phi, float ux, float uy,
                                            float uz, float omega) {
  const float cs2 = 0.25f;
  const float u[3] = {ux, uy, uz};
  if constexpr (COLL == ADE_SRT) {
#pragma unroll
    for (int q = 0; q < AQ; ++q) g[q] = g[q] + omega * (ade_eq(q, phi, ux, uy, uz) - g[q]);
  } else if constexpr (COLL == ADE_MRT) {
    // raw moments: first order relaxes at omega, second at 1 (col_mrt.h)
    float m2[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float fp = g[2 * a + 1], fm = g[2 * a + 2], v = u[a];
      const float m1 = (phi * v + fm - fp) * omega;
      m2[a] = phi * (v * v + cs2) - fm - fp;
      g[2 * a + 1] = fp + 0.5f * (m2[a] + m1);
      g[2 * a + 2] = fm + 0.5f * (m2[a] - m1);
    }
    g[0] = g[0] - m2[0] - m2[1] - m2[2];
  } else if constexpr (COLL == ADE_CLBM) {
    // central moments (col_clbm.h)
    float k1[3], k2[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float fp = g[2 * a + 1], fm = g[2 * a + 2], v = u[a];
      k1[a] = (phi * v + fm - fp) * omega;
      k2[a] = phi * (cs2 - v * v) + 2.0f * v * (fp - fm) - fm - fp;
      g[2 * a + 1] = fp + k1[a] * v + 0.5f * (k2[a] + k1[a]);
      g[2 * a + 2] = fm + k1[a] * v + 0.5f * (k2[a] - k1[a]);
    }
    g[0] = g[0] - 2.0f * (k1[0] * ux + k1[1] * uy + k1[2] * uz) - k2[0] - k2[1] - k2[2];
  } else {
    // central moments with full reconstruction, no source (col_clbm_RS.h)
    float g1[3], g2[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float fp = g[2 * a + 1], fm = g[2 * a + 2], v = u[a];
      const float gc1 = -phi * v + fp - fm;
      const float gc2 = phi * v * v + 2.0f * (fm - fp) * v + fp + fm;
      g1[a] = (1.0f - omega) * gc1;
      g2[a] = gc2 + (phi * cs2 - gc2);
    }
    g[0] = phi * (1.0f - ux * ux - uy * uy - uz * uz)
           - 2.0f * (g1[0] * ux + g1[1] * uy + g1[2] * uz) - g2[0] - g2[1] - g2[2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float v = u[a];
      g[2 * a + 1] = 0.5f * phi * (v * v + v) + g1[a] * v + 0.5f * (g2[a] + g1[a]);
      g[2 * a + 2] = 0.5f * phi * (v * v - v) + g1[a] * v + 0.5f * (g2[a] - g1[a]);
    }
  }
}

// The symmetry plane of code m (step_ade.py _SYM): the one incoming
// component with c[AXIS] == SIGN takes its mirror image, the opposite.
template <int AXIS, int SIGN>
__device__ __forceinline__ void ade_sym(float (&g)[AQ]) {
  constexpr int q = SIGN > 0 ? 2 * AXIS + 1 : 2 * AXIS + 2;
  g[q] = g[aopp(q)];
}

struct ADEParams {
  float omega;   // 1 / (1/2 + 4 nu) for a scalar nu (a nu field overrides it)
  float phi_in;  // inflow concentration (INFLOW)
  float tcoef;   // conjugate-transfer coefficient (TRANSFER_FS/SF)
};

// The ADE update of one site, in the order of _ade_tile_body.  read(q, dx,
// dy, dz) returns the stored (pre-streaming) g_q at the site offset by
// (dx, dy, dz), wrapped or clamped; g gets the post-collision DFs, phi the
// concentration.  tflags is the site's packed interface bits (bit q-1: the
// link in direction q crosses the phase boundary).
template <int COLL, class Read>
__device__ __forceinline__ void ade_site_update(float (&g)[AQ], float& phi, const Read& read,
                                                uint8_t m, uint32_t tflags, float ux, float uy,
                                                float uz, float omega, const ADEParams& p) {
  if (m == ADE_NOTHING) {
    // inert ghost site: its stored DFs, phi = 0
#pragma unroll
    for (int q = 0; q < AQ; ++q) g[q] = read(q, 0, 0, 0);
    phi = 0.0f;
    return;
  }
  // pull from x - c_q; OUTFLOW_RIGHT pulls every direction from x-1,
  // OUTFLOW_PE from x - c_x - 1 (which reaches x-2)
  const int shift = m == ADE_OUTFLOW_PE ? -1 : 0;
#pragma unroll
  for (int q = 0; q < AQ; ++q) {
    const int dx = m == ADE_OUTFLOW_RIGHT ? -1 : -acq(q, 0) + shift;
    g[q] = read(q, dx, -acq(q, 1), -acq(q, 2));
  }
  switch (m) {
    case ADE_WALL:
    case ADE_WALL_BODY:
#pragma unroll
      for (int q = 1; q < AQ; q += 2) {
        const float t = g[q];
        g[q] = g[q + 1];
        g[q + 1] = t;
      }
      if (m == ADE_WALL_BODY) {
        // anti-bounce-back with the site's pre-streaming phi (d3q7/bc.h:101-115)
        float phi_prev = read(0, 0, 0, 0);
#pragma unroll
        for (int q = 1; q < AQ; ++q) phi_prev = phi_prev + read(q, 0, 0, 0);
#pragma unroll
        for (int q = 0; q < AQ; ++q) g[q] = -g[q] + 2.0f * aweight(q) * phi_prev;
      }
      break;
    case ADE_SYM_TOP: ade_sym<2, -1>(g); break;
    case ADE_SYM_BOTTOM: ade_sym<2, 1>(g); break;
    case ADE_SYM_LEFT: ade_sym<0, 1>(g); break;
    case ADE_SYM_RIGHT: ade_sym<0, -1>(g); break;
    case ADE_SYM_BACK: ade_sym<1, 1>(g); break;
    case ADE_SYM_FRONT: ade_sym<1, -1>(g); break;
    case ADE_TRANSFER_FS:
    case ADE_TRANSFER_SF:
    case ADE_TRANSFER_SW: {
      // conjugate transfer (d3q7/bc.h:142-189), on the flagged links only:
      // the incoming g_q is the site's own outgoing g_opp(q), plus (FS, SF)
      // the transfer coefficient times the pre-streaming phi difference to
      // the neighbour at x - c_q.  Transfer sites are rare: this branch alone
      // reads the neighbours' phi.
      float center[AQ];
      float phi_tot = 0.0f;
#pragma unroll
      for (int q = 0; q < AQ; ++q) {
        center[q] = read(q, 0, 0, 0);
        phi_tot = q == 0 ? center[0] : phi_tot + center[q];
      }
#pragma unroll
      for (int q = 1; q < AQ; ++q) {
        if (!((tflags >> (aopp(q) - 1)) & 1u)) continue;
        if (m == ADE_TRANSFER_SW) {
          g[q] = center[aopp(q)];
        } else {
          const int dx = -acq(q, 0), dy = -acq(q, 1), dz = -acq(q, 2);
          float nb_phi = read(0, dx, dy, dz);
#pragma unroll
          for (int k = 1; k < AQ; ++k) nb_phi = nb_phi + read(k, dx, dy, dz);
          g[q] = center[aopp(q)] + p.tcoef * (nb_phi - phi_tot);
        }
      }
      break;
    }
    default:
      break;
  }

  phi = g[0];
#pragma unroll
  for (int q = 1; q < AQ; ++q) phi = phi + g[q];

  if (m == ADE_INFLOW) {
    phi = p.phi_in;
#pragma unroll
    for (int q = 0; q < AQ; ++q) g[q] = ade_eq(q, phi, ux, uy, uz);
  } else if (m == ADE_OUTFLOW_PE) {
#pragma unroll
    for (int q = 0; q < AQ; ++q) g[q] = ade_eq(q, phi, ux, uy, uz);
  }
  if (ade_collides(m)) ade_collide<COLL>(g, phi, ux, uy, uz, omega);
}

// The ADE site at (x, y, z) of an [X, Y, Z] lattice: reads its stored g
// with the wrap/clamp rule of periodic_bits (bit 0 x, bit 1 y, bit 2 z),
// updates it advected by (ux, uy, uz) and writes gout and phi_out.
// nu_field (or null: p.omega) and tflags (or null: no flags) are per site.
template <int COLL>
__device__ __forceinline__ void ade_site(const float* __restrict__ g, float* __restrict__ gout,
                                         const uint8_t* __restrict__ map,
                                         const float* __restrict__ nu_field,
                                         const uint8_t* __restrict__ tflags,
                                         float* __restrict__ phi_out, int x, int y, int z, int X,
                                         int Y, int Z, int periodic_bits, const ADEParams& p,
                                         float ux, float uy, float uz) {
  const int64_t N = (int64_t)X * Y * Z;
  const int64_t site = ((int64_t)x * Y + y) * Z + z;
  const bool px = periodic_bits & 1, py = periodic_bits & 2, pz = periodic_bits & 4;
  const auto read = [&](int q, int dx, int dy, int dz) {
    const int nx = neighbour(x, dx, X, px);
    const int ny = neighbour(y, dy, Y, py);
    const int nz = neighbour(z, dz, Z, pz);
    return g[q * N + ((int64_t)nx * Y + ny) * Z + nz];
  };
  const uint8_t m = map[site];
  const float omega = nu_field ? 1.0f / (0.5f + 4.0f * nu_field[site]) : p.omega;
  // the flags are read at the (rare) transfer sites only
  const bool transfer = m == ADE_TRANSFER_FS || m == ADE_TRANSFER_SF || m == ADE_TRANSFER_SW;
  const uint32_t tf = tflags && transfer ? tflags[site] : 0u;
  float v[AQ];
  float phi;
  ade_site_update<COLL>(v, phi, read, m, tf, ux, uy, uz, omega, p);
#pragma unroll
  for (int q = 0; q < AQ; ++q) gout[q * N + site] = v[q];
  phi_out[site] = phi;
}

}  // namespace lbm
