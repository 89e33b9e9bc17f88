// B1b's instances (pair_coll.cuh) of the SRT and BGK family: SRT,
// SRT_MODIF_FORCE, SRT_WELL, BGK and BGK_WELL (collisions.cuh).  Entry
// tnl_lbm_pair_coll_srt, collision index in that order (as
// tnl_lbm_coll_srt's).

#include "pair_coll.cuh"

PAIR_COLL_KERNEL(srt, lbm::Srt, false)
PAIR_COLL_KERNEL(srt_modif_force, lbm::SrtModifForce, false)
PAIR_COLL_KERNEL(srt_well, lbm::SrtWell, true)
PAIR_COLL_KERNEL(bgk, lbm::Bgk, false)
PAIR_COLL_KERNEL(bgk_well, lbm::BgkWell, true)

static const lbm::march::PairCollKernel PAIR_SRT_FAMILY[] = {
    aa_pair_full_srt_kernel, aa_pair_full_srt_modif_force_kernel, aa_pair_full_srt_well_kernel,
    aa_pair_full_bgk_kernel, aa_pair_full_bgk_well_kernel};

PAIR_COLL_ENTRY(tnl_lbm_pair_coll_srt, PAIR_SRT_FAMILY)
