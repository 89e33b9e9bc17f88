// The per-step kernels (B4, B2, B3; coll_step.cuh), the step's and the
// force_field ones, of the SRT and BGK family: SRT, SRT_MODIF_FORCE and
// SRT_WELL (collisions.cuh Srt, SrtModifForce, SrtWell), BGK and BGK_WELL
// (Bgk, BgkWell).  Entry tnl_lbm_coll_srt, collision index in that order.

#include "coll_step.cuh"

COLL_KERNELS(srt, lbm::Srt, false)
COLL_KERNELS(srt_modif_force, lbm::SrtModifForce, false)
COLL_KERNELS(srt_well, lbm::SrtWell, true)
COLL_KERNELS(bgk, lbm::Bgk, false)
COLL_KERNELS(bgk_well, lbm::BgkWell, true)

static const lbm::CollRow SRT_FAMILY[] = {COLL_ROW(srt), COLL_ROW(srt_modif_force),
                                          COLL_ROW(srt_well), COLL_ROW(bgk), COLL_ROW(bgk_well)};

COLL_ENTRY(tnl_lbm_coll_srt, SRT_FAMILY)
