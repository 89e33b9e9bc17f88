// B1b's instance (pair_coll.cuh) of the KBC family (collisions.cuh Kbc): one
// for the eight variants, chosen at run time by the kbc bits.  Entry
// tnl_lbm_pair_coll_kbc, collision 0.

#include "pair_coll.cuh"

PAIR_COLL_KERNEL(kbc, lbm::Kbc, false)

static const lbm::march::PairCollKernel PAIR_KBC_FAMILY[] = {aa_pair_full_kbc_kernel};

PAIR_COLL_ENTRY(tnl_lbm_pair_coll_kbc, PAIR_KBC_FAMILY)
