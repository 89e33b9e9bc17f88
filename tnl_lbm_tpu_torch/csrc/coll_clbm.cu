// The per-step kernels (B4, B2, B3; coll_step.cuh) of the moment-space
// family: MRT_LES (collisions.cuh MrtLes), CLBM and CLBM_WELL (Clbm<false>,
// Clbm<true>).  Entry tnl_lbm_coll_clbm, collision index in that order.

#include "coll_step.cuh"

COLL_KERNELS(mrt_les, lbm::MrtLes, false)
COLL_KERNELS(clbm, lbm::Clbm<false>, false)
COLL_KERNELS(clbm_well, lbm::Clbm<true>, true)

static const lbm::CollKernel CLBM_FAMILY[][3] = {
    {ab_step_mrt_les_kernel, aa_even_mrt_les_kernel, aa_odd_mrt_les_kernel},
    {ab_step_clbm_kernel, aa_even_clbm_kernel, aa_odd_clbm_kernel},
    {ab_step_clbm_well_kernel, aa_even_clbm_well_kernel, aa_odd_clbm_well_kernel}};

COLL_ENTRY(tnl_lbm_coll_clbm, CLBM_FAMILY)
