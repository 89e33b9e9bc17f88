// B10's instances (nn_coll.cuh) of the KBC family (collisions.cuh Kbc): one
// per mode for the eight variants, chosen at run time by the kbc bits.
// Entry tnl_lbm_nn_coll_kbc, collision 0.

#include "nn_coll.cuh"

NN_COLL_KERNELS(kbc, Kbc, false)

static const NNCollRow NN_KBC_FAMILY[] = {NN_COLL_ROW(kbc)};

NN_COLL_ENTRY(tnl_lbm_nn_coll_kbc, NN_KBC_FAMILY)
