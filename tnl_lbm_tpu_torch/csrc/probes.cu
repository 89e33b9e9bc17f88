// Bandwidth probes of the A-A kernels, float32 state [27, X, Y, Z].
//
// copy_permute_kernel replaces scripts/profile_floor.py run_case (Pallas
// kernel at :24, pallas_call at :36): the even step's I/O with no
// collision, fout[q] = f[Q-1-q], rho = the sum of the permuted rows in
// order, u = (rho, rho, rho).  One thread per site, coalesced along z, as
// aa_even.cu; it measures the card's floor for 27 + 27 f32 and 16 B of
// macro per site (232 B/site).
//
// pair_pipeline_{stages,direct,ring}_kernel and pair_compute_only_kernel
// replace scripts/probe_pair2_pipeline.py make (:20, pallas_call :73) and
// make_compute_only (:113, pallas_call :151), with `passes` rounds of
// x * 1.000001 + 1e-12 in place of a pair's two collisions; multiply and
// add round separately (no FMA contraction), as the plain versions do.
// pair_pipeline (P2a) is the memory half of the one-kernel pair's x-march
// (pair_march.cuh: 8 x 32 column tiles, x segments, one-site y-z halo
// windows, each window plane loaded once a segment), through one of three
// load paths (p2a::pipeline below), the tile's interior run through the
// passes and stored.  pair_compute_only (P2b) is its compute half on the
// same decomposition (p2b::compute below): the passes on every site of
// every column tile and x segment, only the first column tile's first
// segment loaded and stored; the other sites compute on whatever their
// shared-memory slots hold and store the result back there, as the Pallas
// kernel's other programs compute on stale VMEM: the march's arithmetic
// with no traffic.
//
// element_pipeline_kernel replaces scripts/probe_element_pipeline.py make
// (Pallas kernel at :21, pallas_call at :32): every (tx, ty) tile of a
// padded [27, X+4, Y+16, Z] state reads its overlapping (tx+4, ty+16)
// window, runs `passes` rounds of the affine map on the tile's interior
// and writes it to the same place of the output, whose ring is left
// unwritten as the Pallas kernel leaves it.  Built the way Hopper stages
// data: blocks march along x over a column of tiles, a producer lane loads
// each window plane once by TMA into a ring of plane buffers with full and
// empty mbarriers (P4's), and consumer warps run the passes on a plane's
// interior while later planes are in flight (element_pipeline_kernel
// below).  So the question of the script - do the staged copies and the
// compute overlap - is asked of this card: compare passes 0, 20 and 60
// with pair_compute_only's compute-only time.  Bound: HBM bytes, the state
// read once and the interior written once (216 B/site); the windows'
// (ty+16)/ty rows and the march's 4 halo planes per segment are read
// beside it, from L2 where neighbouring blocks march side by side.
//
// window_copy_kernel<LOAD> replaces scripts/probe_dma_align.py make_copy
// (Pallas kernel at :23, pallas_call at :50): tiles of TX x TY = 16 x 32
// sites; each block copies its [TX+4, wy, Z] window of one component,
// whose y rows start at j TY + y_off, one x plane at a time into shared
// memory at row dst_off, and writes each plane's interior rows - those of
// fpad[:, 2:X+2, 8:Y+8, :] - to the [27, X, Y, Z] output.  On the TPU a y
// offset moved the window's start within an (8, 128) tile, which its DMA
// engine may refuse.  On this card a y offset moves the window by whole
// rows of Z * 4 bytes, so it changes no 16-byte alignment: the variants
// differ only in the window's size.  What the probe measures here is the
// load path: LOAD_4B (4-byte cp.async), LOAD_16B (16-byte cp.async) or
// LOAD_TMA (one bulk copy of the plane's wy Z contiguous floats).  The
// planes go through a ring of 2-4 plane buffers with a full and an empty
// mbarrier each (window_copy below), so later planes' copies are in flight
// while a plane's interior is stored; the stores (16-byte, every thread)
// and the output are the same in all three.  Bound: HBM bytes, the
// interior read once and written once (216 B/site).

#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

#include "lbm_site.cuh"
#include "pair_march.cuh"

using namespace lbm;

namespace {

__device__ __forceinline__ float affine(float x, int passes) {
  for (int i = 0; i < passes; ++i) x = __fadd_rn(__fmul_rn(x, 1.000001f), 1e-12f);
  return x;
}

}  // namespace

extern "C" __global__ void __launch_bounds__(128)
copy_permute_kernel(const float* __restrict__ f, float* __restrict__ fout,
                    float* __restrict__ rho, float* __restrict__ u, int Y, int Z,
                    int with_macro) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  if (z >= Z) return;
  const int64_t N = (int64_t)gridDim.z * Y * Z;
  const int64_t site = ((int64_t)blockIdx.z * Y + blockIdx.y) * Z + z;
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float r = f[(Q - 1 - q) * N + site];
    fout[q * N + site] = r;
    s = q == 0 ? r : s + r;
  }
  if (with_macro) {
    rho[site] = s;
    u[site] = s;
    u[N + site] = s;
    u[2 * N + site] = s;
  }
}

// P2a, the march's memory half (pair_march.cuh's geometry).  Block b owns
// the column tile b mod ncol of x segment b / ncol, as the pair's blocks
// (aa_pair.cu), and walks its window planes xs - 1 .. xe, each loaded once,
// with the pair's split of roles: the 11 window warps (the pair's even
// warps) bring each plane into a ring of plane buffers by the block's load
// path, and 8 tile warps (the odd warps), one thread per tile site, wait
// for a plane, run the passes on the tile's 27 values of an interior plane,
// store them and hand the buffer back.  Every buffer has a full and an
// empty mbarrier, so the loads of later planes go on while a plane is
// computed.  Load paths:
//   LOAD_STAGES  the pair's staged rows (march::stage_row): each of a
//                plane's 270 rows one bulk copy of its interior and two
//                4-byte cp.async halo words, issued by the window threads
//                into NSTAGES stages (B1's copies);
//   LOAD_DIRECT  every window thread reads its site's 27 values from global
//                memory and writes them to a [Q][WSITES] plane buffer (B1
//                unstaged, its even warps' ring writes);
//   LOAD_RING    RING_PLANES plane buffers (P3's ring): for a tile whose
//                window needs no wrap or clamp, one lane of a producer warp
//                copies each plane as one tensor-map box of 40 z x 10 y x 27
//                components (its z range and 4 each side, 160 bytes a row:
//                the low halo at byte 12); for any other the window warps
//                copy the staged rows into the ring.
// Every path runs one block per SM, as the pair: the stages and the direct
// path's plane buffers sit after the pair's ring and codes (STAGE_OFFSET),
// in the pair's shared memory; the ring's 4 planes exceed half an SM.
namespace p2a {

namespace M = lbm::march;

constexpr int LOAD_STAGES = 0, LOAD_DIRECT = 1, LOAD_RING = 2;
constexpr int PRODUCER = 32;                          // the ring's producer warp
constexpr int LOADERS = M::EVEN_THREADS;              // the window warps
constexpr int THREADS = LOADERS + M::ODD_THREADS + PRODUCER;  // 640
constexpr int RING_PLANES = 4;
constexpr int DIRECT_PLANES = 2;
constexpr int DIRECT_PLANE_BYTES = Q * M::WSITES * (int)sizeof(float);  // 36,720
constexpr int BOX_Z = M::TZ + 8;                      // 40 floats: a staged row's 160 bytes
constexpr int RB = M::row_bytes<float>();             // 160
constexpr int PITCH = M::WY * RB;                     // 1600: a component's rows
constexpr int PLANE_BYTES = (Q * PITCH + 127) / 128 * 128;  // 43,264: a box, 128-byte aligned
constexpr int LO_BOX = 12;                            // byte of z0 - 1 in a box row
static_assert(BOX_Z * (int)sizeof(float) == RB, "a box row is a staged row");
static_assert(M::STAGE_OFFSET + DIRECT_PLANES * DIRECT_PLANE_BYTES <= M::smem_bytes<float>(),
              "the direct path's planes fit the pair's shared memory");

__host__ __device__ constexpr int smem_bytes(int load) {
  return load == LOAD_RING ? RING_PLANES * PLANE_BYTES : M::smem_bytes<float>();
}

template <int LOAD>
__device__ __forceinline__ void pipeline(const float* __restrict__ f, float* __restrict__ fout,
                                         int X, int Y, int Z, int periodic_bits, int passes,
                                         int seg_len, const CUtensorMap* tmap) {
  extern __shared__ __align__(128) unsigned char p2a_smem[];
  __shared__ uint64_t full[RING_PLANES], empty[RING_PLANES];
  const bool px = periodic_bits & 1, py = periodic_bits & 2, pz = periodic_bits & 4;
  const int64_t YZ = (int64_t)Y * Z, N = X * YZ;
  const int nzt = (Z + M::TZ - 1) / M::TZ, ncol = ((Y + M::TY - 1) / M::TY) * nzt;
  const int col = blockIdx.x % ncol, seg = blockIdx.x / ncol;
  const int y0 = (col / nzt) * M::TY, z0 = (col % nzt) * M::TZ;
  const int ny = min(M::TY, Y - y0), nz = min(M::TZ, Z - z0);
  const int xs = seg * seg_len, xe = min(xs + seg_len, X);
  const int planes = xe - xs + 2;  // window planes xs - 1 .. xe
  const int t = threadIdx.x;
  const int zlo = neighbour(z0 - 1, 0, Z, pz), zhi = neighbour(z0 - 1, nz + 1, Z, pz);
  const bool boxed = LOAD == LOAD_RING && ny == M::TY && nz == M::TZ && y0 >= 1 &&
                     y0 + M::TY < Y && z0 >= 1 && z0 + M::TZ < Z;
  constexpr int stages =
      LOAD == LOAD_RING ? RING_PLANES : (LOAD == LOAD_DIRECT ? DIRECT_PLANES : M::NSTAGES);
  constexpr int buf_bytes = LOAD == LOAD_RING ? PLANE_BYTES
                            : (LOAD == LOAD_DIRECT ? DIRECT_PLANE_BYTES : M::stage_bytes<float>());
  constexpr int lo_byte = LOAD == LOAD_RING ? LO_BOX : 0;
  unsigned char* bufs = p2a_smem + (LOAD == LOAD_RING ? 0 : M::STAGE_OFFSET);
  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      M::mbar_init(&full[s], boxed ? 1 : LOADERS);
      M::mbar_init(&empty[s], M::ODD_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // row r of window plane j (component r / WY, window row r % WY) into its buffer
  auto copy_row = [&](int j, int r) {
    constexpr int comp_bytes = LOAD == LOAD_RING ? PITCH : M::WY * RB;
    const float* src = f + neighbour(xs - 1, j, X, px) * YZ + (int64_t)(r / M::WY) * N +
                       neighbour(y0 - 1, r % M::WY, Y, py) * (int64_t)Z;
    unsigned char* dst = bufs + (j % stages) * buf_bytes + (r / M::WY) * comp_bytes +
                         (r % M::WY) * RB;
    M::stage_row<float>(dst, src, z0, nz, zlo, zhi, lo_byte, &full[j % stages]);
  };

  if (t < LOADERS) {  // ================= the window warps
    if (boxed) return;
    const int lyw = t / M::WZ, lzw = t % M::WZ;
    const bool on = t < M::WSITES && lyw <= ny + 1 && lzw <= nz + 1;
    const int yz = neighbour(y0 - 1, lyw, Y, py) * Z + neighbour(z0 - 1, lzw, Z, pz);
    const bool copier = t < Q * M::WY && t % M::WY <= ny + 1;
    for (int j = 0; j < planes; ++j) {
      const int s = j % stages;
      if (j >= stages) M::mbar_wait(&empty[s], (j / stages - 1) & 1);
      if (LOAD != LOAD_DIRECT) {
        if (copier) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the reads
          copy_row(j, t);
        }
        M::cp_async_arrive(&full[s]);
      } else {
        if (on) {
          const float* src = f + neighbour(xs - 1, j, X, px) * YZ + yz;
          float* dst = reinterpret_cast<float*>(bufs + s * buf_bytes) + t;
          float v[Q];
#pragma unroll
          for (int q = 0; q < Q; ++q) v[q] = src[q * N];
#pragma unroll
          for (int q = 0; q < Q; ++q) dst[q * M::WSITES] = v[q];
        }
        M::mbar_arrive(&full[s]);  // releases this thread's writes
      }
    }
    return;
  }

  if (t >= LOADERS + M::ODD_THREADS) {  // ================= the ring's producer lane
    if (!boxed || t != LOADERS + M::ODD_THREADS) return;
    for (int j = 0; j < planes; ++j) {
      const int s = j % stages;
      if (j >= stages) M::mbar_wait(&empty[s], (j / stages - 1) & 1);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the reads
      const uint32_t bar = M::smem_addr(&full[s]);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(Q * M::WY * RB)
                   : "memory");
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(M::smem_addr(bufs + s * PLANE_BYTES)),
          "l"(reinterpret_cast<uint64_t>(tmap)), "r"(z0 - 4), "r"(y0 - 1),
          "r"(neighbour(xs - 1, j, X, px)), "r"(0), "r"(bar)
          : "memory");
    }
    return;
  }

  // ================= the tile warps: tile site (ly, lz) of every interior plane
  const int ot = t - LOADERS, ly = ot / M::TZ, lz = ot % M::TZ;
  const bool mine = ly < ny && lz < nz;
  const int yz = (y0 + ly) * Z + z0 + lz;
  const int lyw = ly + 1, lzw = lz + 1;  // the site in the window
  const int off = LOAD == LOAD_DIRECT ? (lyw * M::WZ + lzw) * (int)sizeof(float)
                                      : lyw * RB + 16 + (lzw - 1) * (int)sizeof(float);
  constexpr int comp_bytes = LOAD == LOAD_RING ? PITCH
                             : (LOAD == LOAD_DIRECT ? M::WSITES * (int)sizeof(float)
                                                    : M::WY * RB);
  for (int i = 0; i < planes; ++i) {
    const int s = i % stages;
    M::mbar_wait(&full[s], (i / stages) & 1);
    if (mine && i >= 1 && i + 1 < planes) {
      const unsigned char* src = bufs + s * buf_bytes + off;
      float v[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) v[q] = *reinterpret_cast<const float*>(src + q * comp_bytes);
      M::mbar_arrive(&empty[s]);  // the buffer is read
      for (int r = 0; r < passes; ++r)  // the 27 values' passes side by side
#pragma unroll
        for (int q = 0; q < Q; ++q) v[q] = __fadd_rn(__fmul_rn(v[q], 1.000001f), 1e-12f);
      float* dst = fout + (int64_t)(xs + i - 1) * YZ + yz;
#pragma unroll
      for (int q = 0; q < Q; ++q) dst[q * N] = v[q];
    } else {
      M::mbar_arrive(&empty[s]);
    }
  }
}

}  // namespace p2a

#define PAIR_PIPELINE_KERNEL(NAME, LOAD)                                                      \
  extern "C" __global__ void __launch_bounds__(p2a::THREADS, 1)                              \
      NAME(const float* __restrict__ f, float* __restrict__ fout, int X, int Y, int Z,        \
           int periodic_bits, int passes, int seg_len, const __grid_constant__ CUtensorMap tmap) { \
    p2a::pipeline<LOAD>(f, fout, X, Y, Z, periodic_bits, passes, seg_len, &tmap);             \
  }

PAIR_PIPELINE_KERNEL(pair_pipeline_stages_kernel, p2a::LOAD_STAGES)
PAIR_PIPELINE_KERNEL(pair_pipeline_direct_kernel, p2a::LOAD_DIRECT)
PAIR_PIPELINE_KERNEL(pair_pipeline_ring_kernel, p2a::LOAD_RING)

// P2b, the march's compute half (pair_march.cuh's geometry).  The march's
// work items are its column tiles (TY x TZ) over x segments of SEG_MAX
// planes, item k the column k mod ncol of segment k / ncol as the pair's
// blocks; a unit is one x plane of an item, TILE_SITES sites, the units
// numbered item by item, plane by plane.  A persistent grid of as many
// blocks as are resident at once (at least MIN_BLOCKS an SM: 32 warps)
// splits the units into equal runs, so the card's SMs get the same work
// within one unit, and each block walks its run plane by plane, one thread
// per tile site.  A thread holds its site's 27 values in registers and runs
// the passes outside, the 27 components inside: 27 independent chains of a
// multiply and an add, so one warp's issue never waits on its own results.
// The sites of item 0 (the first column tile's first segment) are read from
// f and written to `tile`; every other site starts from the thread's slot
// of shared memory, whatever it holds, and writes its result back there,
// both as volatile 16-byte accesses, so no block's arithmetic can be
// dropped.  Sites beyond a partial tile compute nothing.
namespace p2b {

namespace M = lbm::march;

constexpr int THREADS = M::TILE_SITES;  // 256: one thread per site of a unit
constexpr int MIN_BLOCKS = 4;           // resident blocks an SM at least: 32 warps
constexpr int SLOT = 28;                // floats of a thread's slot: 27 and a pad, 7 float4
constexpr int SMEM_BYTES = THREADS * SLOT * (int)sizeof(float);  // 28,672
static_assert(SLOT % 4 == 0 && SLOT >= Q, "a slot is whole float4s holding Q values");

__device__ __forceinline__ float4 ld_slot(const float4* p) {
  float4 v;
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(M::smem_addr(p)));
  return v;
}

__device__ __forceinline__ void st_slot(float4* p, float4 v) {
  asm volatile("st.volatile.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(M::smem_addr(p)),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// The march's items for a shape: column tiles, segments, the units.
struct Items {
  int nzt, ncol, nseg, last_len;
  int64_t units;
  __host__ __device__ Items(int X, int Y, int Z)
      : nzt((Z + M::TZ - 1) / M::TZ),
        ncol(((Y + M::TY - 1) / M::TY) * nzt),
        nseg((X + M::SEG_MAX - 1) / M::SEG_MAX),
        last_len(X - (nseg - 1) * M::SEG_MAX),
        units((int64_t)ncol * X) {}
  // Item and plane within it of unit u.
  __device__ void locate(int64_t u, int& item, int& plane) const {
    const int64_t full = (int64_t)(nseg - 1) * ncol * M::SEG_MAX;
    if (u < full) {
      item = (int)(u / M::SEG_MAX);
      plane = (int)(u % M::SEG_MAX);
    } else {
      item = (nseg - 1) * ncol + (int)((u - full) / last_len);
      plane = (int)((u - full) % last_len);
    }
  }
  __device__ int length(int item) const {
    return item / ncol == nseg - 1 ? last_len : M::SEG_MAX;
  }
};

// `passes` rounds of the affine map on the 27 values, the components inside.
__device__ __forceinline__ void run_passes(float (&v)[SLOT], int passes) {
#pragma unroll 4
  for (int r = 0; r < passes; ++r)
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = __fadd_rn(__fmul_rn(v[q], 1.000001f), 1e-12f);
}

__device__ __forceinline__ void compute(const float* __restrict__ f, float* __restrict__ tile,
                                        int X, int Y, int Z, int passes) {
  extern __shared__ __align__(16) float4 p2b_smem[];
  float4* slot = p2b_smem + threadIdx.x * (SLOT / 4);
  const Items it(X, Y, Z);
  const int64_t u1 = it.units * (blockIdx.x + 1) / gridDim.x;
  int64_t u = it.units * blockIdx.x / gridDim.x;
  if (u >= u1) return;
  const int64_t YZ = (int64_t)Y * Z, N = X * YZ;
  const int ly = threadIdx.x / M::TZ, lz = threadIdx.x % M::TZ;
  int item, plane;
  it.locate(u, item, plane);
  while (u < u1) {  // the run's part of one item: planes plane .. plane + n - 1
    const int col = item % it.ncol;
    const int y0 = (col / it.nzt) * M::TY, z0 = (col % it.nzt) * M::TZ;
    const int len = it.length(item) - plane;
    const int n = u1 - u < len ? (int)(u1 - u) : len;
    if (ly < min(M::TY, Y - y0) && lz < min(M::TZ, Z - z0)) {
      float v[SLOT];
      if (item == 0) {  // the first item: [Q][tx][ty][tz] of f's sites, into `tile`
        const int ty = min(M::TY, Y), tz = min(M::TZ, Z);
        const int64_t tn = (int64_t)min(M::SEG_MAX, X) * ty * tz;
        for (int x = plane; x < plane + n; ++x) {
          const float* src = f + x * YZ + (int64_t)ly * Z + lz;
#pragma unroll
          for (int q = 0; q < Q; ++q) v[q] = src[q * N];
          run_passes(v, passes);
          float* dst = tile + ((int64_t)x * ty + ly) * tz + lz;
#pragma unroll
          for (int q = 0; q < Q; ++q) dst[q * tn] = v[q];
        }
      } else {
        for (int k = 0; k < n; ++k) {
#pragma unroll
          for (int j = 0; j < SLOT / 4; ++j) {
            const float4 a = ld_slot(slot + j);
            v[4 * j] = a.x, v[4 * j + 1] = a.y, v[4 * j + 2] = a.z, v[4 * j + 3] = a.w;
          }
          run_passes(v, passes);
#pragma unroll
          for (int j = 0; j < SLOT / 4; ++j)
            st_slot(slot + j, make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]));
        }
      }
    }
    u += n;
    ++item;
    plane = 0;
  }
}

}  // namespace p2b

// tile: [27, min(SEG_MAX, X), min(TY, Y), min(TZ, Z)], the first item's sites.
extern "C" __global__ void __launch_bounds__(p2b::THREADS, p2b::MIN_BLOCKS)
pair_compute_only_kernel(const float* __restrict__ f, float* __restrict__ tile, int X, int Y,
                         int Z, int passes) {
  p2b::compute(f, tile, X, Y, Z, passes);
}

namespace {

// threads per block of the window probes
constexpr int WTHREADS = 256;
// tile of the alignment probe (scripts/probe_dma_align.py TX, TY)
constexpr int ATX = 16, ATY = 32;
// dynamic shared memory the window probes may ask for
constexpr int WINDOW_SMEM_MAX = 200 * 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

}  // namespace

constexpr int LOAD_4B = 0, LOAD_16B = 1, LOAD_TMA = 2;
// plane buffers of a window copy block, at most
constexpr int WSTAGES_MAX = 4;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrives on `bar` once all of this thread's earlier cp.async copies landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// grid (X / 16, Y / 32, 27); dynamic shared memory: `stages` plane buffers
// of (dst_off + wy) Z floats.  fpad: [27, X+4, Y+16, Z], out: [27, X, Y, Z];
// Z % 4 == 0, and the window covers its tile's interior rows (the wrapper
// checks).
//
// The block walks its TX + 4 window planes through a ring of `stages`
// plane buffers (4 at the script's sizes, one block per SM), each with a
// full and an empty mbarrier: the copy of plane k + stages is issued as
// soon as plane k's interior has been stored, so stages - 1 planes are in
// flight while a plane is stored.  Full barriers
// complete on cp.async.mbarrier.arrive.noinc (every thread's 4- or 16-byte
// copies) or on the bulk copy's complete_tx (TMA: one thread arrives with
// the plane's bytes and issues one cp.async.bulk); empty barriers complete
// when every thread has stored its share of the interior.  Odd x tiles walk
// their planes backwards, so the two halo planes that neighbouring tiles
// share are read by both at about the same time (from L2 the second time).
template <int LOAD>
__device__ __forceinline__ void window_copy(const float* __restrict__ fpad,
                                            float* __restrict__ out, int X, int Y, int Z,
                                            int y_off, int wy, int dst_off, int stages) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t full[WSTAGES_MAX], empty[WSTAGES_MAX];
  float* buf = reinterpret_cast<float*>(smem4);
  const int XP = X + 4, YP = Y + 16, q = blockIdx.z;
  const int i = blockIdx.x, j = blockIdx.y;
  const int n = wy * Z;                // floats per window plane, contiguous in fpad
  const int stride = (dst_off + wy) * Z;  // floats per plane buffer
  const int interior = (dst_off + 8 - y_off) * Z;  // the tile's rows in a buffer
  constexpr int PLANES = ATX + 4;
  const bool backwards = i & 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], LOAD == LOAD_TMA ? 1u : WTHREADS);
      mbar_init(&empty[s], WTHREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // copies walk step k (window plane lx) into buffer k % stages
  auto produce = [&](int k) {
    const int s = k % stages, lx = backwards ? PLANES - 1 - k : k;
    if (k >= stages && (LOAD != LOAD_TMA || threadIdx.x == 0))
      mbar_wait(smem_addr(&empty[s]), (k / stages - 1) & 1);
    const float* src = fpad + (((int64_t)q * XP + i * ATX + lx) * YP + j * ATY + y_off) * Z;
    float* dst = buf + s * stride + dst_off * Z;
    if constexpr (LOAD == LOAD_4B) {
      for (int k4 = threadIdx.x; k4 < n; k4 += WTHREADS) cp_async4(dst + k4, src + k4);
      cp_async_arrive(&full[s]);
    } else if constexpr (LOAD == LOAD_16B) {
      for (int k4 = threadIdx.x; k4 < n / 4; k4 += WTHREADS)
        cp_async16(dst + 4 * k4, src + 4 * k4);
      cp_async_arrive(&full[s]);
    } else if (threadIdx.x == 0) {
      const uint32_t b = smem_addr(&full[s]), bytes = static_cast<uint32_t>(n) * 4u;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the generic reads
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(dst)),
          "l"(src), "r"(bytes), "r"(b)
          : "memory");
    }
  };

  for (int k = 0; k < stages && k < PLANES; ++k) produce(k);
  for (int k = 0; k < PLANES; ++k) {
    const int s = k % stages, lx = backwards ? PLANES - 1 - k : k;
    mbar_wait(smem_addr(&full[s]), (k / stages) & 1);
    if (lx >= 2 && lx < ATX + 2) {
      const float4* src = reinterpret_cast<const float4*>(buf + s * stride + interior);
      float4* o = reinterpret_cast<float4*>(
          out + (((int64_t)q * X + i * ATX + lx - 2) * Y + j * ATY) * Z);
      for (int k4 = threadIdx.x; k4 < ATY * Z / 4; k4 += WTHREADS) o[k4] = src[k4];
    }
    mbar_arrive(&empty[s]);
    if (k + stages < PLANES) produce(k + stages);
  }
}

// P3, the element pipeline, as an x march over a plane ring.  grid
// (Y / ty, segments, 27), EPRODUCER + ECONSUMERS warps; dynamic shared
// memory: `stages` plane buffers of (ty+16) Z floats.  fpad and out:
// [27, X+4, Y+16, Z]; X % tx == 0, Y % ty == 0, Z % 4 == 0 (the wrapper
// checks).
//
// Block (j, g, q) walks the column of y tile j of component q over x
// segment g: tiles [g seg_tiles, g seg_tiles + seg_tiles) (fewer in the
// last segment), so its window planes are padded x [g seg_tiles tx,
// + n tx + 4), each loaded once - the x overlap of neighbouring windows once
// per march, not once per tile.  One lane of the producer warp copies each
// (ty+16) Z window plane, contiguous in fpad, with one bulk copy (TMA) into
// the next buffer of the ring, as soon as its empty mbarrier says the
// consumers are done with it; the full mbarrier completes on the copy's
// bytes.  The consumer warps wait for a plane, run the passes on its
// interior rows (8, 8 + ty) - every plane but the two halo planes at each
// end of the march - with 16-byte loads from shared memory, store them to
// out with 16-byte stores, and arrive on the plane's empty mbarrier.  So
// stages - 1 planes are in flight while one is computed.  Odd segments
// walk backwards, so the halo planes two neighbouring segments share are
// read by both at about the same time (from L2 the second time); the
// neighbouring y tiles of a component, adjacent block indices, march side
// by side and share their 16 halo rows the same way.
constexpr int EPRODUCER = 1, ECONSUMERS = 8;
constexpr int ETHREADS = 32 * (EPRODUCER + ECONSUMERS);
constexpr int ESTAGES_MAX = 4;

extern "C" __global__ void __launch_bounds__(ETHREADS, 1)
element_pipeline_kernel(const float* __restrict__ fpad, float* __restrict__ out, int X, int Y,
                        int Z, int tx, int ty, int seg_tiles, int stages, int passes) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t full[ESTAGES_MAX], empty[ESTAGES_MAX];
  float* buf = reinterpret_cast<float*>(smem4);
  const int XP = X + 4, YP = Y + 16, wy = ty + 16, j = blockIdx.x, g = blockIdx.y;
  const int q = blockIdx.z;
  const int t0 = g * seg_tiles, t1 = min(t0 + seg_tiles, X / tx);
  const int planes = (t1 - t0) * tx + 4, first = t0 * tx;
  const bool backwards = g & 1;
  const int n = wy * Z;  // floats per window plane, contiguous in fpad
  constexpr int CONSUMER_THREADS = 32 * ECONSUMERS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1u);
      mbar_init(&empty[s], CONSUMER_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int64_t column = (int64_t)q * XP * YP * Z + (int64_t)j * ty * Z;

  if (threadIdx.x < 32 * EPRODUCER) {  // the producer: one lane issues every copy
    if (threadIdx.x != 0) return;
    const uint32_t bytes = static_cast<uint32_t>(n) * 4u;
    for (int k = 0; k < planes; ++k) {
      const int s = k % stages, px = first + (backwards ? planes - 1 - k : k);
      if (k >= stages) {
        mbar_wait(smem_addr(&empty[s]), (k / stages - 1) & 1);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the reads
      }
      const uint32_t b = smem_addr(&full[s]);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(buf + (int64_t)s * n)),
          "l"(fpad + column + (int64_t)px * YP * Z), "r"(bytes), "r"(b)
          : "memory");
    }
    return;
  }

  const int c = threadIdx.x - 32 * EPRODUCER;
  const int n4 = ty * Z / 4;  // the interior rows of a plane, in float4
  for (int k = 0; k < planes; ++k) {
    const int s = k % stages, px = first + (backwards ? planes - 1 - k : k);
    mbar_wait(smem_addr(&full[s]), (k / stages) & 1);
    if (px >= first + 2 && px < first + planes - 2) {
      const float4* src = reinterpret_cast<const float4*>(buf + (int64_t)s * n + 8 * Z);
      float4* o = reinterpret_cast<float4*>(out + column + ((int64_t)px * YP + 8) * Z);
      int i = c;
      for (; i + CONSUMER_THREADS < n4; i += 2 * CONSUMER_THREADS) {  // two vectors at a time
        float4 a = src[i], b = src[i + CONSUMER_THREADS];
        for (int r = 0; r < passes; ++r) {
          a.x = __fadd_rn(__fmul_rn(a.x, 1.000001f), 1e-12f);
          a.y = __fadd_rn(__fmul_rn(a.y, 1.000001f), 1e-12f);
          a.z = __fadd_rn(__fmul_rn(a.z, 1.000001f), 1e-12f);
          a.w = __fadd_rn(__fmul_rn(a.w, 1.000001f), 1e-12f);
          b.x = __fadd_rn(__fmul_rn(b.x, 1.000001f), 1e-12f);
          b.y = __fadd_rn(__fmul_rn(b.y, 1.000001f), 1e-12f);
          b.z = __fadd_rn(__fmul_rn(b.z, 1.000001f), 1e-12f);
          b.w = __fadd_rn(__fmul_rn(b.w, 1.000001f), 1e-12f);
        }
        o[i] = a;
        o[i + CONSUMER_THREADS] = b;
      }
      for (; i < n4; i += CONSUMER_THREADS) {
        float4 a = src[i];
        a.x = affine(a.x, passes);
        a.y = affine(a.y, passes);
        a.z = affine(a.z, passes);
        a.w = affine(a.w, passes);
        o[i] = a;
      }
    }
    mbar_arrive(&empty[s]);
  }
}

#define WINDOW_COPY_KERNEL(NAME, LOAD)                                                        \
  extern "C" __global__ void __launch_bounds__(WTHREADS)                                     \
      NAME(const float* __restrict__ fpad, float* __restrict__ out, int X, int Y, int Z,      \
           int y_off, int wy, int dst_off, int stages) {                                      \
    window_copy<LOAD>(fpad, out, X, Y, Z, y_off, wy, dst_off, stages);                        \
  }

WINDOW_COPY_KERNEL(window_copy_ld4_kernel, LOAD_4B)
WINDOW_COPY_KERNEL(window_copy_ld16_kernel, LOAD_16B)
WINDOW_COPY_KERNEL(window_copy_tma_kernel, LOAD_TMA)

namespace {

// The window needs more shared memory than the 48 KB default.
cudaError_t opt_in(const void* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Each launches on `stream` and returns the CUDA error of the launch.
extern "C" int tnl_lbm_copy_permute(const float* f, float* fout, float* rho, float* u, int X,
                                    int Y, int Z, int with_macro, void* stream) {
  const int block = Z >= 128 ? 128 : ((Z + 31) / 32) * 32;
  const dim3 grid((Z + block - 1) / block, Y, X);
  copy_permute_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      f, fout, rho, u, Y, Z, with_macro);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static void* fn = nullptr;
  if (fn == nullptr) {
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault) != cudaSuccess)
      fn = nullptr;
#endif
  }
  return reinterpret_cast<EncodeTiled>(fn);
}

// The [27, X, Y, Z] state as a 4D tensor map (z fastest) with boxes of
// BOX_Z x WY x 1 x Q: a window plane's rows, every component.
cudaError_t state_map(CUtensorMap* map, const float* f, int X, int Y, int Z) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)Z, (cuuint64_t)Y, (cuuint64_t)X, (cuuint64_t)Q};
  const cuuint64_t strides[3] = {(cuuint64_t)Z * 4, (cuuint64_t)Y * Z * 4,
                                 (cuuint64_t)X * Y * Z * 4};
  const cuuint32_t box[4] = {(cuuint32_t)p2a::BOX_Z, (cuuint32_t)march::WY, 1, (cuuint32_t)Q};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(f), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

using PipelineKernel = void (*)(const float*, float*, int, int, int, int, int, int,
                                const CUtensorMap);
const PipelineKernel PIPELINE[3] = {pair_pipeline_stages_kernel, pair_pipeline_direct_kernel,
                                    pair_pipeline_ring_kernel};

int boxed_columns(int Y, int Z) {
  const int ny = (Y + march::TY - 1) / march::TY, nzt = (Z + march::TZ - 1) / march::TZ;
  int n = 0;
  for (int j = 0; j < ny; ++j)
    for (int k = 0; k < nzt; ++k) {
      const int y0 = j * march::TY, z0 = k * march::TZ;
      n += y0 >= 1 && y0 + march::TY < Y && z0 >= 1 && z0 + march::TZ < Z;
    }
  return n;
}

}  // namespace

// P2a's launch geometry for a load path (0 stages, 1 direct, 2 ring) and a
// shape: out[0] dynamic shared memory per block (bytes), [1] threads per
// block, [2] the x segment, [3] segments, [4] column tiles, [5] plane
// buffers, [6] columns loaded as tensor boxes (the ring's; 0 for the
// other paths).
extern "C" int tnl_lbm_pair_pipeline_info(int load, int X, int Y, int Z, int* out) {
  if (load < 0 || load > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int seg = march::auto_seg_len(X, Y, Z);
  const int vals[7] = {p2a::smem_bytes(load), p2a::THREADS, seg, (X + seg - 1) / seg,
                       march::column_tiles(Y, Z),
                       load == p2a::LOAD_STAGES ? march::NSTAGES
                       : (load == p2a::LOAD_RING ? p2a::RING_PLANES : p2a::DIRECT_PLANES),
                       load == p2a::LOAD_RING ? boxed_columns(Y, Z) : 0};
  for (int k = 0; k < 7; ++k) out[k] = vals[k];
  return 0;
}

// load: 0 stages, 1 direct, 2 ring, over the pair's automatic x segments.
// The stages and the ring need Z % 4 == 0 and a 16-byte aligned state.
extern "C" int tnl_lbm_pair_pipeline(const float* f, float* fout, int X, int Y, int Z,
                                     int periodic_bits, int passes, int load, void* stream) {
  static cudaError_t opted[3] = {cudaErrorNotReady, cudaErrorNotReady, cudaErrorNotReady};
  if (load < 0 || load > 2 || passes < 0 || (int64_t)Y * Z > INT_MAX ||
      (load != p2a::LOAD_DIRECT && (Z % 4 != 0 || reinterpret_cast<uintptr_t>(f) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (opted[load] == cudaErrorNotReady)
    opted[load] = opt_in(reinterpret_cast<const void*>(PIPELINE[load]), p2a::smem_bytes(load));
  if (opted[load] != cudaSuccess) return static_cast<int>(opted[load]);
  CUtensorMap map{};
  if (load == p2a::LOAD_RING) {
    const cudaError_t e = state_map(&map, f, X, Y, Z);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int seg_len = march::auto_seg_len(X, Y, Z);
  const int blocks = march::column_tiles(Y, Z) * ((X + seg_len - 1) / seg_len);
  PIPELINE[load]<<<blocks, p2a::THREADS, p2a::smem_bytes(load),
                   static_cast<cudaStream_t>(stream)>>>(f, fout, X, Y, Z, periodic_bits, passes,
                                                        seg_len, map);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// P2b's grid: every block resident at once, at most one a unit.
int compute_only_blocks(int64_t units, int* per_sm) {
  static int resident = 0;
  if (resident == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &resident, pair_compute_only_kernel, p2b::THREADS, p2b::SMEM_BYTES) != cudaSuccess)
    resident = 0;
  if (per_sm != nullptr) *per_sm = resident;
  return (int)std::min<int64_t>(units, (int64_t)std::max(resident, 1) * march::sm_count());
}

}  // namespace

// P2b's launch for a shape: out[0] threads per block, [1] dynamic shared
// memory per block (bytes), [2] the x segment, [3] segments, [4] column
// tiles, [5] units (column tile planes), [6] blocks, [7] resident blocks
// an SM.
extern "C" int tnl_lbm_pair_compute_only_info(int X, int Y, int Z, int* out) {
  const p2b::Items it(X, Y, Z);
  int per_sm = 0;
  const int blocks = compute_only_blocks(it.units, &per_sm);
  const int vals[8] = {p2b::THREADS, p2b::SMEM_BYTES, march::SEG_MAX, it.nseg, it.ncol,
                       (int)std::min<int64_t>(it.units, INT_MAX), blocks, per_sm};
  for (int k = 0; k < 8; ++k) out[k] = vals[k];
  return per_sm >= p2b::MIN_BLOCKS ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

extern "C" int tnl_lbm_pair_compute_only(const float* f, float* tile, int X, int Y, int Z,
                                         int passes, void* stream) {
  if (passes < 0 || X < 1 || Y < 1 || Z < 1) return static_cast<int>(cudaErrorInvalidValue);
  const p2b::Items it(X, Y, Z);
  int per_sm = 0;
  const int blocks = compute_only_blocks(it.units, &per_sm);
  if (per_sm < p2b::MIN_BLOCKS) return static_cast<int>(cudaErrorInvalidConfiguration);
  pair_compute_only_kernel<<<blocks, p2b::THREADS, p2b::SMEM_BYTES,
                             static_cast<cudaStream_t>(stream)>>>(f, tile, X, Y, Z, passes);
  return static_cast<int>(cudaGetLastError());
}

// fpad, out: [27, X+4, Y+16, Z]; X % tx == 0, Y % ty == 0, Z % 4 == 0,
// `stages` (2 to ESTAGES_MAX) plane buffers of (ty+16) Z floats within
// WINDOW_SMEM_MAX, seg_tiles >= 1 (kernels/probes.py element_geometry).
extern "C" int tnl_lbm_element_pipeline(const float* fpad, float* out, int X, int Y, int Z,
                                        int tx, int ty, int seg_tiles, int stages, int passes,
                                        void* stream) {
  static const cudaError_t opted =
      opt_in(reinterpret_cast<const void*>(element_pipeline_kernel), WINDOW_SMEM_MAX);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const long long plane = (long long)(ty + 16) * Z * (long long)sizeof(float);
  if (tx < 1 || ty < 1 || X % tx != 0 || Y % ty != 0 || Z % 4 != 0 || seg_tiles < 1 ||
      stages < 2 || stages > ESTAGES_MAX || stages * plane > WINDOW_SMEM_MAX || passes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int segments = (X / tx + seg_tiles - 1) / seg_tiles;
  element_pipeline_kernel<<<dim3(Y / ty, segments, Q), ETHREADS, (int)(stages * plane),
                            static_cast<cudaStream_t>(stream)>>>(fpad, out, X, Y, Z, tx, ty,
                                                                 seg_tiles, stages, passes);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// Plane buffers of a window copy block: one block per SM, its ring as deep
// as fits (4 planes at wy = 48 measured 4% faster than 2 planes for each of
// two blocks on an H100), at least 2 and at most WSTAGES_MAX.
int window_stages(int Z, int wy, int dst_off) {
  const int plane = (dst_off + wy) * Z * (int)sizeof(float);
  return std::max(2, std::min(WSTAGES_MAX, WINDOW_SMEM_MAX / std::max(plane, 1)));
}

}  // namespace

extern "C" int tnl_lbm_window_copy_stages(int Z, int wy, int dst_off) {
  return window_stages(Z, wy, dst_off);
}

// load: 0 4-byte cp.async, 1 16-byte cp.async, 2 bulk copies (TMA).  fpad:
// [27, X+4, Y+16, Z], out: [27, X, Y, Z]; X % 16 == 0, Y % 32 == 0,
// Z % 4 == 0, 0 <= y_off <= 8, y_off + wy <= 48 and 8 - y_off + 32 <= wy
// (the window covers its tile; the wrapper checks and names the fault).
extern "C" int tnl_lbm_window_copy(const float* fpad, float* out, int X, int Y, int Z,
                                   int y_off, int wy, int dst_off, int load, void* stream) {
  using Kernel = void (*)(const float*, float*, int, int, int, int, int, int, int);
  static const Kernel kernels[3] = {window_copy_ld4_kernel, window_copy_ld16_kernel,
                                    window_copy_tma_kernel};
  static const cudaError_t opted[3] = {
      opt_in(reinterpret_cast<const void*>(window_copy_ld4_kernel), WINDOW_SMEM_MAX),
      opt_in(reinterpret_cast<const void*>(window_copy_ld16_kernel), WINDOW_SMEM_MAX),
      opt_in(reinterpret_cast<const void*>(window_copy_tma_kernel), WINDOW_SMEM_MAX)};
  if (load < 0 || load > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (opted[load] != cudaSuccess) return static_cast<int>(opted[load]);
  const int stages = window_stages(Z, wy, dst_off);
  const int smem = stages * (dst_off + wy) * Z * (int)sizeof(float);
  if (smem > WINDOW_SMEM_MAX || X % ATX != 0 || Y % ATY != 0 || Z % 4 != 0 || y_off < 0 ||
      y_off > 8 || dst_off < 0 || y_off + wy > ATY + 16 || 8 - y_off + ATY > wy)
    return static_cast<int>(cudaErrorInvalidValue);
  kernels[load]<<<dim3(X / ATX, Y / ATY, Q), WTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      fpad, out, X, Y, Z, y_off, wy, dst_off, stages);
  return static_cast<int>(cudaGetLastError());
}
