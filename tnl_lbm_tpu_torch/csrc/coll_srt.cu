// The per-step kernels (B4, B2, B3; coll_step.cuh) of the SRT and BGK
// family: SRT, SRT_MODIF_FORCE and SRT_WELL (collisions.cuh Srt,
// SrtModifForce, SrtWell), BGK and BGK_WELL (Bgk, BgkWell).  Entry
// tnl_lbm_coll_srt, collision index in that order.

#include "coll_step.cuh"

COLL_KERNELS(srt, lbm::Srt, false)
COLL_KERNELS(srt_modif_force, lbm::SrtModifForce, false)
COLL_KERNELS(srt_well, lbm::SrtWell, true)
COLL_KERNELS(bgk, lbm::Bgk, false)
COLL_KERNELS(bgk_well, lbm::BgkWell, true)

static const lbm::CollKernel SRT_FAMILY[][3] = {
    {ab_step_srt_kernel, aa_even_srt_kernel, aa_odd_srt_kernel},
    {ab_step_srt_modif_force_kernel, aa_even_srt_modif_force_kernel,
     aa_odd_srt_modif_force_kernel},
    {ab_step_srt_well_kernel, aa_even_srt_well_kernel, aa_odd_srt_well_kernel},
    {ab_step_bgk_kernel, aa_even_bgk_kernel, aa_odd_bgk_kernel},
    {ab_step_bgk_well_kernel, aa_even_bgk_well_kernel, aa_odd_bgk_well_kernel}};

COLL_ENTRY(tnl_lbm_coll_srt, SRT_FAMILY)
