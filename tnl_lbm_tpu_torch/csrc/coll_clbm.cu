// The per-step kernels (B4, B2, B3; coll_step.cuh), the step's and the
// force_field ones, of the moment-space family: MRT_LES (collisions.cuh
// MrtLes), CLBM and CLBM_WELL (Clbm<false>, Clbm<true>), and the cumulant
// cascade on total DFs (Cum<false>) with the equilibrium kind read at run
// time, CUM's instance for eq_entropic (its quadratic and inverse-cumulant
// instances are ab_step.cu's, aa_even.cu's and aa_odd.cu's).  Entry
// tnl_lbm_coll_clbm, collision index in that order.

#include "coll_step.cuh"

COLL_KERNELS(mrt_les, lbm::MrtLes, false)
COLL_KERNELS(clbm, lbm::Clbm<false>, false)
COLL_KERNELS(clbm_well, lbm::Clbm<true>, true)
COLL_KERNELS(cum, lbm::Cum<false>, false)

static const lbm::CollRow CLBM_FAMILY[] = {COLL_ROW(mrt_les), COLL_ROW(clbm),
                                           COLL_ROW(clbm_well), COLL_ROW(cum)};

COLL_ENTRY(tnl_lbm_coll_clbm, CLBM_FAMILY)
