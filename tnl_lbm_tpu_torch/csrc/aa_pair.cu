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
// Design (pair_march.cuh's template pair_march, which the full-set pair
// aa_pair_full.cu shares; this file holds its FLUID/WALL/NOTHING site
// updates, PairSite): an x-marching pipeline.  A block owns a y-z
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

#include <climits>
#include <cstdint>

#include "lbm_site.cuh"
#include "pair_march.cuh"

using namespace lbm;
using namespace lbm::march;

namespace {

// B1's instance of the march: CUM_WELL on FLUID, WALL and NOTHING, its
// input planes staged, stored in S.
template <typename S>
struct PairSite {
  using Store = S;
  using Params = SiteParams;
  static constexpr bool STAGED = true, OUTFLOW = false;
  __device__ static __forceinline__ void even(float (&v)[Q], uint8_t m, const SiteParams& p) {
    float rho, ux, uy, uz;
    stream_bc_collide(v, m, p, rho, ux, uy, uz);
  }
  __device__ static __forceinline__ void odd(float (&v)[Q], uint8_t m, const SiteParams& p,
                                             float& rho, float& ux, float& uy, float& uz) {
    stream_bc_collide(v, m, p, rho, ux, uy, uz);
  }
};

}  // namespace

#define AA_PAIR_KERNEL(NAME, S)                                                              \
  extern "C" __global__ void __launch_bounds__(THREADS, 1)                                  \
      NAME(const S* __restrict__ f, S* __restrict__ fout, const uint8_t* __restrict__ map,  \
           float* __restrict__ rho, float* __restrict__ u, int X, int Y, int Z,             \
           int periodic_bits, int has_nothing, int with_macro, int seg_len, int staged,     \
           SiteParams p) {                                                                  \
    pair_march<PairSite<S>>(f, fout, map, rho, u, X, Y, Z, periodic_bits, has_nothing,      \
                            with_macro, seg_len, staged, p);                                \
  }

AA_PAIR_KERNEL(aa_pair_f32_kernel, float)
AA_PAIR_KERNEL(aa_pair_f16_kernel, __half)
AA_PAIR_KERNEL(aa_pair_bf16_kernel, __nv_bfloat16)

namespace {

template <typename S>
using PairKernel = void (*)(const S*, S*, const uint8_t*, float*, float*, int, int, int, int,
                            int, int, int, int, SiteParams);

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
