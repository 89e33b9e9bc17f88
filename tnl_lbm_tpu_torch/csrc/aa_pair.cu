// One-kernel A-A pair for D3Q27 CUM_WELL: two lattice steps (even, then
// odd) per launch, state stored in float32, float16 or bfloat16, every
// operation in float32.
//
// Replaces the Pallas kernel of tnl_lbm_tpu/kernels/fused_aa.py
// make_fused_pair2_aa (kernel at :794, pallas_call at :1115).  Per call
// f_out = narrow(odd(even(widen(f_in)))), with rho and u from the odd
// sub-step; even and odd are the per-step kernels' functions (aa_even.cu,
// aa_odd.cu) and their plain versions even_step_plain / odd_step_plain.
//
// Design (pair_march.cuh): an x-marching pipeline.  A block owns a y-z
// column tile of 8 x 32 sites and a segment of at most 32 x planes, and
// walks it plane by plane.  Its warps have one role each.  11 even warps run
// the even sub-step on window plane i (the tile and its one-site y-z halo:
// 340 sites, one thread each, 1.33 collisions per tile site); 8 odd warps
// run the odd sub-step on the tile's 256 sites of plane o, once even plane
// o + 1 is written.  The two hand planes over through mbarriers, not a
// block-wide barrier: the odd warps wait on `planes_done` of plane o + 1,
// the even warps on `odd_done` of plane i - 3 before they overwrite what it
// read, so the even warps run up to three planes ahead and every thread
// collides one site per plane.  The even output stays in shared memory as
// float32 and is never rounded to the store type (fused_aa.py:987-999).  It
// goes to a ring that keeps of each plane only the slots a later odd pull
// reads, until that pull has read them (pair_march.cuh): 81 values per
// window site in 110 KB.  Window sites outside a non-periodic domain take
// the even output of the clamped site and periodic axes wrap: pad_halo of
// the even output, what the odd sub-step reads (fused_aa.py:1001-1025).  The
// even output sits in the post-permutation slot order (out_perm = opp), so
// the odd read is aa_odd.cu's, ev[opp q](s - c_q).  NOTHING sites keep
// their DFs through the even sub-step.  The odd sub-step scatters with
// aa_odd.cu's one-writer rule (push_targets, one path per warp: a warp whose
// sites are all away from the faces in straight-line stores, one with a
// site on a z face by z's edge rule alone, any other by all three axes'); pushes aimed at NOTHING sites are dropped (the
// target's code comes from the window's codes in shared memory) and the
// even warps copy those sites' stored bits to the output, which is their
// even output narrowed (fused_aa.py:1064-1069).  Blocks read their neighbours'
// sites, so the kernel reads f_in and writes a second buffer.  Only the
// final store narrows, with round-to-nearest-even like torch's .to().
//
// Staging: input plane i + 1 is copied into shared memory while the even
// warps work on plane i (and the odd warps on earlier planes), through two
// stages, each completed on its own mbarrier.  Each of a plane's 270 window
// rows (27 components x 10 y rows, the y-halo rows' addresses wrapped or
// clamped per row) is one thread's: the row's 32 interior elements as one
// 1D bulk copy (TMA, 128 or 64 contiguous bytes, counted on the barrier's
// transaction count), each of its two z-halo elements, whose addresses wrap
// or clamp per element, as the 4-byte word that holds it (cp.async).  Not a
// tiled tensor map: it fills out-of-domain boxes with zeros where the
// window needs the wrap or the clamp, and its inner box would be 34 floats,
// not a multiple of 16 bytes.  Every even thread's
// cp.async.mbarrier.arrive.noinc arrives on the stage's barrier once its
// copies landed, and a named barrier of the even warps orders each refill
// after the reads of the stage.  A state whose z extent is not a whole
// number of 16-byte pieces, or that is not 16-byte aligned, is read
// straight from global memory by the even warps (no staging; the same
// function, slower).
//
// Bound: HBM bytes, one read and one write of f per two steps (216 B/site
// in float32, 108 B with 16-bit storage), plus the map and 16 B of rho and
// u; the collisions' FP32 operations take less at the card's peak rate.
// What holds it on an H100 (PERF.md, tests/pair_ablation.py): issue slots
// and the staging.  It runs 2.41 collisions a site at 256^3 (the even
// sub-step on 340 / 256 of the tile and 34 of each 32 planes, the odd one
// once) at 19 warps per SM; the even warps alone take three quarters of the
// kernel's time.  The same kernel with the even warps reading global memory
// instead of the stages ran 9-13% faster there, so the stages' per-plane
// barrier and copies cost more than they hide.  The ring and two float32
// stages take 198 KB (16-bit: 164 KB): one block of 608 threads per SM, 96
// registers a thread, a few bytes of it spilled.  Offsets into a state
// are 64-bit; offsets within one plane (Y Z < 2^31 sites) are 32-bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "lbm_site.cuh"
#include "pair_march.cuh"

using namespace lbm;
using namespace lbm::march;

namespace {

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

template <typename S>
__device__ __forceinline__ void aa_pair_body(const S* __restrict__ f, S* __restrict__ fout,
                                             const uint8_t* __restrict__ map,
                                             float* __restrict__ rho_out,
                                             float* __restrict__ u_out, int X, int Y, int Z,
                                             int periodic_bits, int has_nothing,
                                             int with_macro, int seg_len, int staged,
                                             SiteParams p) {
  constexpr int RB = row_bytes<S>(), SB = stage_bytes<S>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [RING_GROUPS][GROUP][WSITES]
  uint8_t* codes = smem + RING_BYTES;            // [CODE_PLANES][WSITES]
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
        bulk_copy(dst + 16, src + z0, nz * (uint32_t)sizeof(S), bar);
        const S* lo = src + zlo;
        const S* hi = src + zhi;
        if (sizeof(S) == 2) {  // the aligned words that hold the halo elements
          lo = reinterpret_cast<const S*>(reinterpret_cast<uintptr_t>(lo) & ~uintptr_t(3));
          hi = reinterpret_cast<const S*>(reinterpret_cast<uintptr_t>(hi) & ~uintptr_t(3));
        }
        cp_async4(dst, lo);
        cp_async4(dst + hi_halo_byte<S>(), hi);
      }
      cp_async_arrive(bar);
    };
    if (staged)
      for (int j = 0; j < NSTAGES - 1 && j < n_even; ++j) issue(j);
    uint8_t mnext = on ? map[neighbour(xs - 1, 0, X, px) * YZ + yz] : GEO_NOTHING;

    for (int i = 0; i < n_even; ++i) {
      if (staged && i + NSTAGES - 1 < n_even) {
        // every even thread has read the stage that plane i + 1 refills
        if (i > 0) asm volatile("bar.sync 1, %0;\n" ::"r"(EVEN_THREADS) : "memory");
        issue(i + NSTAGES - 1);
      }
      // the ring groups and codes that plane i overwrites were last read by
      // odd plane i - 3
      if (i >= 4) mbar_wait(&odd_done[(i - 4) % HANDOFF], ((i - 4) / HANDOFF) & 1);
      if (on) {
        // same-site read, opposite-slot result
        if (staged) mbar_wait(&full[i % NSTAGES], (i / NSTAGES) & 1);
        const uint8_t m = mnext;
        if (i + 1 < n_even) mnext = map[neighbour(xs - 1, i + 1, X, px) * YZ + yz];
        float v[Q];
        if (staged) {
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
        float* ringP = ring + (i % P_GROUPS) * GROUP * WSITES;
        float* ringZ = ring + (P_GROUPS + i % Z_GROUPS) * GROUP * WSITES;
        float* ringM = ring + (P_GROUPS + Z_GROUPS + i % M_GROUPS) * GROUP * WSITES;
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
          float rho, ux, uy, uz;
          stream_bc_collide(v, m, p, rho, ux, uy, uz);
#pragma unroll
          for (int r = 0; r < Q; ++r) {
            float* grp = cx(r) > 0 ? ringP : (cx(r) == 0 ? ringZ : ringM);
            grp[group_slot(r) * WSITES + t] = v[opp(r)];
          }
        }
        codes[(i % CODE_PLANES) * WSITES + t] = m;
      } else if (staged) {
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
      const float* ringP = ring + ((o + 1) % P_GROUPS) * GROUP * WSITES;
      const float* ringZ = ring + (P_GROUPS + o % Z_GROUPS) * GROUP * WSITES;
      const float* ringM = ring + (P_GROUPS + Z_GROUPS + (o - 1) % M_GROUPS) * GROUP * WSITES;
      float v[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int r = opp(q);
        const float* grp = cx(r) > 0 ? ringP : (cx(r) == 0 ? ringZ : ringM);
        v[q] = grp[group_slot(r) * WSITES + wc - cy(q) * WZ - cz(q)];
      }
      const uint8_t m = codes[(o % CODE_PLANES) * WSITES + wc];
      mbar_arrive(&odd_done[(o - 1) % HANDOFF]);  // the ring is read: the even warps may go on
      float rho, ux, uy, uz;
      stream_bc_collide(v, m, p, rho, ux, uy, uz);

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

}  // namespace

#define AA_PAIR_KERNEL(NAME, S)                                                              \
  extern "C" __global__ void __launch_bounds__(THREADS, 1)                                  \
      NAME(const S* __restrict__ f, S* __restrict__ fout, const uint8_t* __restrict__ map,  \
           float* __restrict__ rho, float* __restrict__ u, int X, int Y, int Z,             \
           int periodic_bits, int has_nothing, int with_macro, int seg_len, int staged,     \
           SiteParams p) {                                                                  \
    aa_pair_body<S>(f, fout, map, rho, u, X, Y, Z, periodic_bits, has_nothing, with_macro, \
                    seg_len, staged, p);                                                    \
  }

AA_PAIR_KERNEL(aa_pair_f32_kernel, float)
AA_PAIR_KERNEL(aa_pair_f16_kernel, __half)
AA_PAIR_KERNEL(aa_pair_bf16_kernel, __nv_bfloat16)

namespace {

template <typename S>
using PairKernel = void (*)(const S*, S*, const uint8_t*, float*, float*, int, int, int, int,
                            int, int, int, int, SiteParams);

int sm_count() {
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
int auto_seg_len(int X, int Y, int Z) {
  const int cols = column_tiles(Y, Z);
  const int segs = std::max(1, std::min(X, (sm_count() + cols - 1) / cols));
  return std::min(SEG_MAX, (X + segs - 1) / segs);
}

int store_smem(int store) {
  return store == 0 ? smem_bytes<float>() : smem_bytes<__half>();
}

template <typename S>
int launch(PairKernel<S> kernel, const void* f, void* fout, const uint8_t* map, float* rho,
           float* u, int X, int Y, int Z, int periodic_bits, int has_nothing, int with_macro,
           int seg_len, const SiteParams& p, cudaStream_t stream) {
  static const cudaError_t opted = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<S>());
  if (opted != cudaSuccess) return static_cast<int>(opted);
  if ((int64_t)Y * Z > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);  // 32-bit plane offsets
  if (seg_len <= 0) seg_len = auto_seg_len(X, Y, Z);
  constexpr int VEC = 16 / (int)sizeof(S);
  const int staged = Z % VEC == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0;
  const int blocks = column_tiles(Y, Z) * ((X + seg_len - 1) / seg_len);
  kernel<<<blocks, THREADS, smem_bytes<S>(), stream>>>(
      static_cast<const S*>(f), static_cast<S*>(fout), map, rho, u, X, Y, Z, periodic_bits,
      has_nothing, with_macro, seg_len, staged, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one float32 block (ring, codes and stages), in bytes.
extern "C" int tnl_lbm_aa_pair_smem_bytes() { return smem_bytes<float>(); }

// The launch geometry for a store code and a shape: out[0] dynamic shared
// memory per block (bytes), [1] stages, [2] TY, [3] TZ, [4] the automatic
// x segment length, [5] segments, [6] column tiles, [7] 1 if a state of
// this shape (16-byte aligned) is staged.
extern "C" int tnl_lbm_aa_pair_info(int store, int X, int Y, int Z, int* out) {
  const int seg = auto_seg_len(X, Y, Z);
  const int vec = store == 0 ? 4 : 8;
  const int vals[8] = {store_smem(store), NSTAGES, TY, TZ, seg, (X + seg - 1) / seg,
                       column_tiles(Y, Z), Z % vec == 0};
  for (int k = 0; k < 8; ++k) out[k] = vals[k];
  return 0;
}

// Launches on `stream`; returns the CUDA error of the launch (0 on success).
// store: 0 float32, 1 float16, 2 bfloat16.  periodic_bits: bit 0 x, 1 y,
// 2 z.  rho and u may be null when with_macro is 0.  seg_len: the x
// segment of one block, or 0 for the automatic one.
extern "C" int tnl_lbm_aa_pair_segmented(const void* f, void* fout, const uint8_t* map,
                                         float* rho, float* u, int X, int Y, int Z,
                                         int periodic_bits, int has_nothing, int with_macro,
                                         int store, float nu, float fx, float fy, float fz,
                                         int neumaier, int seg_len, void* stream) {
  const SiteParams p{1.0f / (3.0f * nu + 0.5f), fx, fy, fz, neumaier};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (store) {
    case 0:
      return launch<float>(aa_pair_f32_kernel, f, fout, map, rho, u, X, Y, Z, periodic_bits,
                           has_nothing, with_macro, seg_len, p, s);
    case 1:
      return launch<__half>(aa_pair_f16_kernel, f, fout, map, rho, u, X, Y, Z, periodic_bits,
                            has_nothing, with_macro, seg_len, p, s);
    case 2:
      return launch<__nv_bfloat16>(aa_pair_bf16_kernel, f, fout, map, rho, u, X, Y, Z,
                                   periodic_bits, has_nothing, with_macro, seg_len, p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The pair with the automatic x segment.
extern "C" int tnl_lbm_aa_pair(const void* f, void* fout, const uint8_t* map, float* rho,
                               float* u, int X, int Y, int Z, int periodic_bits,
                               int has_nothing, int with_macro, int store, float nu, float fx,
                               float fy, float fz, int neumaier, void* stream) {
  return tnl_lbm_aa_pair_segmented(f, fout, map, rho, u, X, Y, Z, periodic_bits, has_nothing,
                                   with_macro, store, nu, fx, fy, fz, neumaier, 0, stream);
}
