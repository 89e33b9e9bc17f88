// The x-march of the one-launch A-A pairs (aa_pair.cu, B1; aa_pair_full.cu,
// B1b): column tiles that march along x, a ring of even-output planes and
// staged input planes, as one template over the site updates
// (pair_march<Site>).  The P2a probe (probes.cu pair_pipeline) loads its
// window planes on the same geometry.
//
// A block owns a y-z column tile of TY x TZ sites (z fastest) and a segment
// [xs, xe) of at most SEG_MAX x planes.  Its warps have one role each:
// EVEN_THREADS (11 warps) walk the even planes xs - 1 .. xe (wrapped or
// clamped along x), the even sub-step on a window plane, the tile and its
// one-site y-z halo (WY x WZ sites, wrap or clamp as pad_halo), one thread
// per window site; ODD_THREADS (8 warps) walk the odd planes xs .. xe - 1,
// the odd sub-step on the tile, one thread per tile site.  The roles hand
// planes over through mbarriers (HANDOFF of each kind), not a block-wide
// barrier: odd plane o waits until even plane o + 1 is written
// (`planes_done`), even plane i until odd plane i - 3 has read the ring
// (`odd_done`), so the even warps run up to three planes ahead.
//
// The ring.  The odd sub-step of plane o pulls ev[opp q](s - c_q): from
// plane o - 1 only the slots r = opp q with c_x(r) = -1, from plane o only
// those with c_x(r) = 0, from plane o + 1 only those with c_x(r) = +1 (nine
// slots each).  With even plane i written while odd planes up to i - 2 may
// still read, the ring holds two +1 groups (P(i), i mod 2), three 0 groups
// (Z(i), i mod 3) and four -1 groups (M(i), i mod 4): 9 groups of 9 float32
// slots, 81 values per window site; the group even plane i overwrites was
// last read by odd plane i - 3, which it waits for.  Within a group, slot r
// sits at 3 (c_y + 1) + (c_z + 1).  An instance whose map may hold
// OUTFLOW_RIGHT (Site::OUTFLOW) keeps OUT_GROUPS groups of every class: an
// OUTFLOW_RIGHT site of odd plane o pulls all 27 slots from plane o - 1
// (ev[opp q](x - 1, y - c_y, z - c_z)), so every group of plane i is read
// until odd plane i + 1, and even plane i + 4, which overwrites it, waits
// for that odd plane: 12 groups, 108 values per window site.  The site
// codes of the window ride along in CODE_PLANES planes: odd plane o reads
// those of planes o - 1 .. o + 1 for its pushes after it released the
// ring, so the codes even plane i overwrites (plane i - 5) were last read by
// odd plane i - 4, finished before odd plane i - 3 released.
//
// The stages.  NSTAGES input planes of the window, each [Q][WY] rows of
// ROW bytes: a word holding the low z halo (z0 - 1, wrapped or clamped), 12
// bytes of padding, the TZ interior elements from byte 16 (16-byte aligned,
// so copied as one bulk copy), and a word holding the high z halo at byte
// 16 + TZ * sizeof(S).  A 16-bit halo element is copied as the aligned word
// that contains it.  Plane i + 1 is copied while the even warps work on
// plane i.  Tiles at the high faces of a shape that no tile divides are
// partial: their high halo is the site just past the tile's last, and
// their threads beyond the domain are masked.  An instance without the
// stages (Site::STAGED false) has the even warps read global memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "lbm_site.cuh"

namespace lbm {
namespace march {

constexpr int TY = 8, TZ = 32;               // column tile
constexpr int WY = TY + 2, WZ = TZ + 2;      // window plane
constexpr int WSITES = WY * WZ;              // 340
constexpr int TILE_SITES = TY * TZ;          // 256
constexpr int EVEN_THREADS = 352;            // 11 warps, one thread per window site
constexpr int ODD_THREADS = TILE_SITES;      // 8 warps, one thread per tile site
constexpr int THREADS = EVEN_THREADS + ODD_THREADS;  // 608: 96 registers a thread
constexpr int NSTAGES = 2;                   // staged input planes, one in flight
constexpr int SEG_MAX = 32;                  // x planes a block marches at most
constexpr int GROUP = 9;                     // slots of one c_x class
constexpr int P_GROUPS = 2, Z_GROUPS = 3, M_GROUPS = 4;  // c_x = +1, 0, -1
constexpr int RING_GROUPS = P_GROUPS + Z_GROUPS + M_GROUPS;  // 9
constexpr int RING_BYTES = RING_GROUPS * GROUP * WSITES * (int)sizeof(float);  // 110,160
constexpr int OUT_GROUPS = 4;                // groups of each class with OUTFLOW_RIGHT pulls
constexpr int OUT_RING_BYTES = 3 * OUT_GROUPS * GROUP * WSITES * (int)sizeof(float);  // 146,880
constexpr int CODE_PLANES = 5;
constexpr int HANDOFF = 4;                   // plane barriers between the even and odd warps
constexpr int CODE_BYTES = CODE_PLANES * WSITES;
// the stages start 128-byte aligned after the ring and the codes
constexpr int STAGE_OFFSET = (RING_BYTES + CODE_BYTES + 127) / 128 * 128;  // 111,872
// an instance with OUTFLOW_RIGHT pulls and no stages: its ring and codes
constexpr int OUT_SMEM_BYTES = OUT_RING_BYTES + CODE_BYTES;  // 148,580

// Bytes of one staged row for storage type S: 160 (float32), 96 (16-bit).
template <typename S>
__host__ __device__ constexpr int row_bytes() {
  return 16 + ((TZ * (int)sizeof(S) + 4 + 15) / 16) * 16;
}
template <typename S>
__host__ __device__ constexpr int hi_halo_byte() { return 16 + TZ * (int)sizeof(S); }
template <typename S>
__host__ __device__ constexpr int stage_bytes() { return Q * WY * row_bytes<S>(); }
// Dynamic shared memory of one staged block: 198,272 B (float32), 163,712 B (16-bit).
template <typename S>
__host__ __device__ constexpr int smem_bytes() {
  return STAGE_OFFSET + NSTAGES * stage_bytes<S>();
}

// Slot of direction r within its c_x group.
__host__ __device__ constexpr int group_slot(int r) { return dir_code(r) % 9; }

inline int column_tiles(int Y, int Z) { return ((Y + TY - 1) / TY) * ((Z + TZ - 1) / TZ); }

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// The x segment length: at most SEG_MAX planes, and short enough that the
// blocks fill the card when the column tiles alone do not.
inline int auto_seg_len(int X, int Y, int Z) {
  const int cols = column_tiles(Y, Z);
  const int segs = std::max(1, std::min(X, (sm_count() + cols - 1) / cols));
  return std::min(SEG_MAX, (X + segs - 1) / segs);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename S>
__device__ __forceinline__ S narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half narrow<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// One bulk copy (TMA) of `bytes` from global to shared memory, completing
// on `bar` (whose transaction count this thread raised first).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Arrives on `bar` once all of this thread's earlier cp.async copies landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// A plain arrive: releases this thread's earlier shared-memory writes.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// The staged copies of one window plane, thread t's row (t < Q WY: component
// t / WY, window row t % WY, whose y address wraps or clamps): its interior
// as one bulk copy to byte 16 of the row, its two z-halo elements as the
// 4-byte words that hold them, to byte `lo_byte` and hi_halo_byte<S>().
// `src` is the row's first element of the plane (z = 0).
template <typename S>
__device__ __forceinline__ void stage_row(unsigned char* dst, const S* src, int z0, int nz,
                                          int zlo, int zhi, int lo_byte, uint64_t* bar) {
  bulk_copy(dst + 16, src + z0, nz * (uint32_t)sizeof(S), bar);
  const S* lo = src + zlo;
  const S* hi = src + zhi;
  if (sizeof(S) == 2) {  // the aligned words that hold the halo elements
    lo = reinterpret_cast<const S*>(reinterpret_cast<uintptr_t>(lo) & ~uintptr_t(3));
    hi = reinterpret_cast<const S*>(reinterpret_cast<uintptr_t>(hi) & ~uintptr_t(3));
  }
  cp_async4(dst + lo_byte, lo);
  cp_async4(dst + hi_halo_byte<S>(), hi);
}

// One axis of a push from coordinate s of n (push_targets): the step to
// s - 1 and to s + 1, wrapped on a periodic axis (in elements of `stride`),
// whether it exists, and whether a push along -1 / +1 also lands on s (a
// closed face's edge replication).
struct Face {
  int64_t lo, hi;
  bool lo_ok, hi_ok, lo_rep, hi_rep;
  __device__ __forceinline__ bool ok(int c) const { return c == 0 || (c < 0 ? lo_ok : hi_ok); }
  __device__ __forceinline__ int64_t delta(int c) const { return c == 0 ? 0 : (c < 0 ? lo : hi); }
  __device__ __forceinline__ int rep(int c) const { return c != 0 && (c < 0 ? lo_rep : hi_rep); }
};

__device__ __forceinline__ Face face(int s, int n, bool periodic, int64_t stride) {
  Face a;
  a.lo = (s > 0 ? -1 : n - 1) * stride;
  a.hi = (s < n - 1 ? 1 : 1 - n) * stride;
  a.lo_ok = s > 0 || periodic;
  a.hi_ok = s < n - 1 || periodic;
  a.lo_rep = !periodic && s == n - 1;
  a.hi_rep = !periodic && s == 0;
  return a;
}

// The pair of one block over its column tile and x segment.  Site holds
// the instance: Store (the state's storage type), Params (the site
// parameters), STAGED (whether the staged load path is compiled; `staged`
// then chooses it per launch), OUTFLOW (whether an odd OUTFLOW_RIGHT site
// pulls all of plane o - 1, with OUT_GROUPS ring groups of each class), and
// the site updates: even(v, m, p), on the DFs of a site that is not
// NOTHING, and odd(v, m, p, rho, ux, uy, uz).
template <class Site>
__device__ __forceinline__ void pair_march(const typename Site::Store* __restrict__ f,
                                           typename Site::Store* __restrict__ fout,
                                           const uint8_t* __restrict__ map,
                                           float* __restrict__ rho_out,
                                           float* __restrict__ u_out, int X, int Y, int Z,
                                           int periodic_bits, int has_nothing, int with_macro,
                                           int seg_len, int staged,
                                           const typename Site::Params& p) {
  using S = typename Site::Store;
  constexpr int PG = Site::OUTFLOW ? OUT_GROUPS : P_GROUPS;
  constexpr int ZG = Site::OUTFLOW ? OUT_GROUPS : Z_GROUPS;
  constexpr int MG = Site::OUTFLOW ? OUT_GROUPS : M_GROUPS;
  constexpr int RB = row_bytes<S>(), SB = stage_bytes<S>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [PG + ZG + MG][GROUP][WSITES]
  uint8_t* codes = smem + (Site::OUTFLOW ? OUT_RING_BYTES : RING_BYTES);  // [CODE_PLANES][WSITES]
  unsigned char* stages = smem + STAGE_OFFSET;   // [NSTAGES][Q][WY][RB]
  __shared__ uint64_t full[NSTAGES];  // stage landed: EVEN_THREADS arrivals and its bytes

  const bool px = periodic_bits & 1, py = periodic_bits & 2, pz = periodic_bits & 4;
  const int64_t YZ = (int64_t)Y * Z, N = X * YZ;
  // block b: column tile b mod ncol of segment b / ncol, so the blocks that
  // run together walk the same x and share their halo rows in L2
  const int nzt = (Z + TZ - 1) / TZ, ncol = ((Y + TY - 1) / TY) * nzt;
  const int col = blockIdx.x % ncol, seg = blockIdx.x / ncol;
  const int y0 = (col / nzt) * TY, z0 = (col % nzt) * TZ;
  const int ny = min(TY, Y - y0), nz = min(TZ, Z - z0);
  const int xs = seg * seg_len, xe = min(xs + seg_len, X);
  const int n_even = xe - xs + 2;  // even planes xs - 1 .. xe
  const int t = threadIdx.x;
  const int zlo = neighbour(z0 - 1, 0, Z, pz), zhi = neighbour(z0 - 1, nz + 1, Z, pz);

  __shared__ uint64_t planes_done[HANDOFF];  // even plane i written: EVEN_THREADS arrivals
  __shared__ uint64_t odd_done[HANDOFF];     // odd plane o read: ODD_THREADS arrivals at o - 1
  if (t == 0) {
    if (Site::STAGED)
      for (int s = 0; s < NSTAGES; ++s) mbar_init(&full[s], EVEN_THREADS);
    for (int k = 0; k < HANDOFF; ++k) {
      mbar_init(&planes_done[k], EVEN_THREADS);
      mbar_init(&odd_done[k], ODD_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (t < EVEN_THREADS) {
    // ================= even warps: window plane i, for i = 0 .. n_even - 1
    // This thread's window site: its y-z offset within a plane, its stage
    // offset and whether it exists.
    const int lyw = t / WZ, lzw = t % WZ;
    const bool on = t < WSITES && lyw <= ny + 1 && lzw <= nz + 1;
    const int zg = neighbour(z0 - 1, lzw, Z, pz);
    const int yz = neighbour(y0 - 1, lyw, Y, py) * Z + zg;  // Y Z < 2^31
    const int half = sizeof(S) == 2 ? 2 * (zg & 1) : 0;     // a halo's half in its word
    const int soff = lyw * RB + (lzw == 0 ? half
                                          : (lzw == nz + 1 ? hi_halo_byte<S>() + half
                                                           : 16 + (lzw - 1) * (int)sizeof(S)));
    // Staged rows: thread t < Q WY copies row t (component t / WY, window
    // row t % WY) of every plane: its interior as one bulk copy, its two
    // z-halo words by cp.async.
    const bool copier = t < Q * WY && t % WY <= ny + 1;
    auto issue = [&](int j) {
      uint64_t* bar = &full[j % NSTAGES];
      if (copier) {
        const S* src = f + neighbour(xs - 1, j, X, px) * YZ + (int64_t)(t / WY) * N +
                       neighbour(y0 - 1, t % WY, Y, py) * (int64_t)Z;
        unsigned char* dst = stages + (j % NSTAGES) * SB + t * RB;
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the last reads
        stage_row<S>(dst, src, z0, nz, zlo, zhi, 0, bar);
      }
      cp_async_arrive(bar);
    };
    if (Site::STAGED && staged)
      for (int j = 0; j < NSTAGES - 1 && j < n_even; ++j) issue(j);
    uint8_t mnext = on ? map[neighbour(xs - 1, 0, X, px) * YZ + yz] : GEO_NOTHING;

    for (int i = 0; i < n_even; ++i) {
      if (Site::STAGED && staged && i + NSTAGES - 1 < n_even) {
        // every even thread has read the stage that plane i + 1 refills
        if (i > 0) asm volatile("bar.sync 1, %0;\n" ::"r"(EVEN_THREADS) : "memory");
        issue(i + NSTAGES - 1);
      }
      // the ring groups and codes that plane i overwrites were last read by
      // odd plane i - 3
      if (i >= 4) mbar_wait(&odd_done[(i - 4) % HANDOFF], ((i - 4) / HANDOFF) & 1);
      if (on) {
        // same-site read, opposite-slot result
        if (Site::STAGED && staged) mbar_wait(&full[i % NSTAGES], (i / NSTAGES) & 1);
        const uint8_t m = mnext;
        if (i + 1 < n_even) mnext = map[neighbour(xs - 1, i + 1, X, px) * YZ + yz];
        float v[Q];
        if (Site::STAGED && staged) {
          const unsigned char* st = stages + (i % NSTAGES) * SB + soff;
#pragma unroll
          for (int q = 0; q < Q; ++q)
            v[q] = widen(*reinterpret_cast<const S*>(st + q * WY * RB));
        } else {
          int64_t n = N;
          asm volatile("" : "+l"(n));  // no 27 component offsets kept across the loop
          const S* src = f + neighbour(xs - 1, i, X, px) * YZ + yz;
#pragma unroll
          for (int q = 0; q < Q; ++q, src += n) v[q] = widen(*src);
        }
        float* ringP = ring + (i % PG) * GROUP * WSITES;
        float* ringZ = ring + (PG + i % ZG) * GROUP * WSITES;
        float* ringM = ring + (PG + ZG + i % MG) * GROUP * WSITES;
        if (m == GEO_NOTHING) {  // its DFs as they are
#pragma unroll
          for (int r = 0; r < Q; ++r) {
            float* grp = cx(r) > 0 ? ringP : (cx(r) == 0 ? ringZ : ringM);
            grp[group_slot(r) * WSITES + t] = v[r];
          }
          if (i >= 1 && i + 1 < n_even && lyw >= 1 && lyw <= ny && lzw >= 1 && lzw <= nz) {
            // a tile site of an odd plane: no push lands on it, and its
            // output is its even output narrowed, the stored bits
            S* dst = fout + (int64_t)(xs + i - 1) * YZ + yz;
#pragma unroll
            for (int q = 0; q < Q; ++q) dst[q * N] = narrow<S>(v[q]);
          }
        } else {
          Site::even(v, m, p);
#pragma unroll
          for (int r = 0; r < Q; ++r) {
            float* grp = cx(r) > 0 ? ringP : (cx(r) == 0 ? ringZ : ringM);
            grp[group_slot(r) * WSITES + t] = v[opp(r)];
          }
        }
        codes[(i % CODE_PLANES) * WSITES + t] = m;
      } else if (Site::STAGED && staged) {
        mbar_wait(&full[i % NSTAGES], (i / NSTAGES) & 1);  // keep the phases in step
      }
      mbar_arrive(&planes_done[i % HANDOFF]);  // releases this thread's ring writes
    }
    return;
  }

  // ================= odd warps: plane o = 1 .. n_even - 2 (x = xs + o - 1),
  // once even plane o + 1 is written
  const int ot = t - EVEN_THREADS, ly = ot / TZ, lz = ot % TZ;
  const int wc = (ly + 1) * WZ + lz + 1;
  const bool mine = ly < ny && lz < nz;
  const int y = y0 + ly, z = z0 + lz;
  const bool y_inner = y > 0 && y < Y - 1, z_inner = z > 0 && z < Z - 1;
  for (int o = 1; o + 1 < n_even; ++o) {
    mbar_wait(&planes_done[(o + 1) % HANDOFF], ((o + 1) / HANDOFF) & 1);
    const int x = xs + o - 1;
    // the push path is the warp's: straight lines where every site is away
    // from the faces, z's edge rule alone where every site is away from the
    // x and y faces, else all three axes'
    const bool warp_xy_inner = __all_sync(0xffffffffu, !mine || (y_inner && x > 0 && x < X - 1));
    const bool warp_inner = __all_sync(0xffffffffu, !mine || (y_inner && z_inner && x > 0 &&
                                                              x < X - 1));
    if (mine) {
      // neighbour pull, collide, push
      const int64_t site = (int64_t)x * YZ + (int64_t)y * Z + z;
      const float* ringP = ring + ((o + 1) % PG) * GROUP * WSITES;
      const float* ringZ = ring + (PG + o % ZG) * GROUP * WSITES;
      const float* ringM = ring + (PG + ZG + (o - 1) % MG) * GROUP * WSITES;
      float v[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int r = opp(q);
        const float* grp = cx(r) > 0 ? ringP : (cx(r) == 0 ? ringZ : ringM);
        v[q] = grp[group_slot(r) * WSITES + wc - cy(q) * WZ - cz(q)];
      }
      const uint8_t m = codes[(o % CODE_PLANES) * WSITES + wc];
      if constexpr (Site::OUTFLOW) {
        if (m == GEO_OUTFLOW_RIGHT) {
          // every direction from plane o - 1 (x - 1, wrapped or clamped)
          const float* prevP = ring + ((o - 1) % PG) * GROUP * WSITES;
          const float* prevZ = ring + (PG + (o - 1) % ZG) * GROUP * WSITES;
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int r = opp(q);
            const float* grp = cx(r) > 0 ? prevP : (cx(r) == 0 ? prevZ : ringM);
            v[q] = grp[group_slot(r) * WSITES + wc - cy(q) * WZ - cz(q)];
          }
        }
      }
      mbar_arrive(&odd_done[(o - 1) % HANDOFF]);  // the ring is read: the even warps may go on
      float rho, ux, uy, uz;
      Site::odd(v, m, p, rho, ux, uy, uz);

      // The strides, opaque to the compiler inside the iteration: the 27
      // component offsets are then formed as the pushes go, not kept in
      // registers across the plane loop.
      int64_t n = N;
      int sx32 = (int)YZ, sy32 = Z;  // neighbour deltas within a component: |d| <= Y Z + Z + 1
      asm volatile("" : "+l"(n), "+r"(sx32), "+r"(sy32));
      // pushes aimed at a NOTHING site are dropped: the even warps wrote
      // its output.  A target's code is the window's at the push's offset
      // (dx, dy, dz), from plane o + dx: wrapped as the target is, and in
      // shared memory, so no push waits on a global load.
      auto kept = [&](int dx, int dy, int dz) {
        return !has_nothing ||
               codes[((o + dx) % CODE_PLANES) * WSITES + wc + dy * WZ + dz] != GEO_NOTHING;
      };
      S* fs = fout + site;  // component q's plane at this site
      if (warp_inner) {
        // every push lands at site + c_q: straight-line stores, no branches
        // when the map holds no NOTHING site
        if (has_nothing) {
#pragma unroll
          for (int q = 0; q < Q; ++q, fs += n)
            if (kept(cx(q), cy(q), cz(q))) fs[cx(q) * sx32 + cy(q) * sy32 + cz(q)] = narrow<S>(v[q]);
        } else {
#pragma unroll
          for (int q = 0; q < Q; ++q, fs += n)
            fs[cx(q) * sx32 + cy(q) * sy32 + cz(q)] = narrow<S>(v[q]);
        }
      } else if (warp_xy_inner) {
        // a warp with a site on a z face: z's edge rule (push_targets)
        const Face fz = face(z, Z, pz, 1);
#pragma unroll
        for (int q = 0; q < Q; ++q, fs += n) {
          const int d = cx(q) * sx32 + cy(q) * sy32;
          const S val = narrow<S>(v[q]);
          if (fz.ok(cz(q)) && kept(cx(q), cy(q), cz(q))) fs[d + fz.delta(cz(q))] = val;
          if (fz.rep(cz(q)) && kept(cx(q), cy(q), 0)) fs[d] = val;  // replicated on s
        }
      } else {
        // a warp with a site on an x or y face, all its lanes on one path
        // (push_targets): along each axis the push lands at s + c, wrapped
        // on a periodic axis, where that exists, and at a closed face whose
        // outer neighbour would push inwards also on s itself (the edge
        // replication), so a push has up to 8 targets: its primary one and,
        // on the face sites only, those with the replicated axes at s.
        const Face fx = face(x, X, px, YZ), fy = face(y, Y, py, Z), fz = face(z, Z, pz, 1);
#pragma unroll
        for (int q = 0; q < Q; ++q, fs += n) {
          const bool okx = fx.ok(cx(q)), oky = fy.ok(cy(q)), okz = fz.ok(cz(q));
          const int64_t dx = fx.delta(cx(q)), dy = fy.delta(cy(q)), dz = fz.delta(cz(q));
          const int rep = fx.rep(cx(q)) | fy.rep(cy(q)) << 1 | fz.rep(cz(q)) << 2;
          const S val = narrow<S>(v[q]);
          if (okx && oky && okz && kept(cx(q), cy(q), cz(q))) fs[dx + dy + dz] = val;
          for (int r = rep; r; r = (r - 1) & rep)  // the targets with the axes of r at s
            if ((r & 1 || okx) && (r & 2 || oky) && (r & 4 || okz) &&
                kept(r & 1 ? 0 : cx(q), r & 2 ? 0 : cy(q), r & 4 ? 0 : cz(q)))
              fs[(r & 1 ? 0 : dx) + (r & 2 ? 0 : dy) + (r & 4 ? 0 : dz)] = val;
        }
      }
      if (with_macro) {
        rho_out[site] = rho;
        u_out[site] = ux;
        u_out[N + site] = uy;
        u_out[2 * N + site] = uz;
      }
    } else {
      mbar_arrive(&odd_done[(o - 1) % HANDOFF]);
    }
  }
}

}  // namespace march
}  // namespace lbm
