// Block geometry of the one-kernel A-A pair (aa_pair.cu): column tiles that
// march along x, a ring of even-output planes and staged input planes.
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
// sits at 3 (c_y + 1) + (c_z + 1).  The site codes of the window ride along
// in CODE_PLANES planes: odd plane o reads those of planes o - 1 .. o + 1 for
// its pushes after it released the ring, so the codes even plane i
// overwrites (plane i - 5) were last read by odd plane i - 4, finished
// before odd plane i - 3 released.
//
// The stages.  NSTAGES input planes of the window, each [Q][WY] rows of
// ROW bytes: a word holding the low z halo (z0 - 1, wrapped or clamped), 12
// bytes of padding, the TZ interior elements from byte 16 (16-byte aligned,
// so copied as one bulk copy), and a word holding the high z halo at byte
// 16 + TZ * sizeof(S).  A 16-bit halo element is copied as the aligned word
// that contains it.  Plane i + 1 is copied while the even warps work on
// plane i.  Tiles at the high faces of a shape that no tile divides are
// partial: their high halo is the site just past the tile's last, and
// their threads beyond the domain are masked.

#pragma once

#include <cuda_runtime.h>

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
constexpr int CODE_PLANES = 5;
constexpr int HANDOFF = 4;                   // plane barriers between the even and odd warps
constexpr int CODE_BYTES = CODE_PLANES * WSITES;
// the stages start 128-byte aligned after the ring and the codes
constexpr int STAGE_OFFSET = (RING_BYTES + CODE_BYTES + 127) / 128 * 128;  // 111,872

// Bytes of one staged row for storage type S: 160 (float32), 96 (16-bit).
template <typename S>
__host__ __device__ constexpr int row_bytes() {
  return 16 + ((TZ * (int)sizeof(S) + 4 + 15) / 16) * 16;
}
template <typename S>
__host__ __device__ constexpr int hi_halo_byte() { return 16 + TZ * (int)sizeof(S); }
template <typename S>
__host__ __device__ constexpr int stage_bytes() { return Q * WY * row_bytes<S>(); }
// Dynamic shared memory of one block: 198,272 B (float32), 163,712 B (16-bit).
template <typename S>
__host__ __device__ constexpr int smem_bytes() {
  return STAGE_OFFSET + NSTAGES * stage_bytes<S>();
}

// Slot of direction r within its c_x group.
__host__ __device__ constexpr int group_slot(int r) { return dir_code(r) % 9; }

inline int column_tiles(int Y, int Z) { return ((Y + TY - 1) / TY) * ((Z + TZ - 1) / TZ); }

}  // namespace march
}  // namespace lbm
