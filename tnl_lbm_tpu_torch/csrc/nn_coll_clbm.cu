// B10's instances (nn_coll.cuh) of the moment-space family: MRT_LES, CLBM,
// CLBM_WELL (collisions.cuh) and the cumulant cascade on total DFs with the
// equilibrium kind read at run time (CUM with eq_entropic), per mode.  Entry
// tnl_lbm_nn_coll_clbm, collision index in that order (as
// tnl_lbm_coll_clbm's).

#include "nn_coll.cuh"

NN_COLL_KERNELS(mrt_les, MrtLes, false)
NN_COLL_KERNELS(clbm, Clbm<false>, false)
NN_COLL_KERNELS(clbm_well, Clbm<true>, true)
NN_COLL_KERNELS(cum, Cum<false>, false)

static const NNCollRow NN_CLBM_FAMILY[] = {NN_COLL_ROW(mrt_les), NN_COLL_ROW(clbm),
                                           NN_COLL_ROW(clbm_well), NN_COLL_ROW(cum)};

NN_COLL_ENTRY(tnl_lbm_nn_coll_clbm, NN_CLBM_FAMILY)
