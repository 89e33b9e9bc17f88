// B1b's instances (pair_coll.cuh) of the moment-space family: MRT_LES,
// CLBM, CLBM_WELL (collisions.cuh) and the cumulant cascade on total DFs
// with the equilibrium kind read at run time (CUM with eq_entropic; its
// other instances are aa_pair_full.cu's).  Entry tnl_lbm_pair_coll_clbm,
// collision index in that order (as tnl_lbm_coll_clbm's).

#include "pair_coll.cuh"

PAIR_COLL_KERNEL(mrt_les, lbm::MrtLes, false)
PAIR_COLL_KERNEL(clbm, lbm::Clbm<false>, false)
PAIR_COLL_KERNEL(clbm_well, lbm::Clbm<true>, true)
PAIR_COLL_KERNEL(cum, lbm::Cum<false>, false)

static const lbm::march::PairCollKernel PAIR_CLBM_FAMILY[] = {
    aa_pair_full_mrt_les_kernel, aa_pair_full_clbm_kernel, aa_pair_full_clbm_well_kernel,
    aa_pair_full_cum_kernel};

PAIR_COLL_ENTRY(tnl_lbm_pair_coll_clbm, PAIR_CLBM_FAMILY)
