// The per-step kernels (B4, B2, B3; coll_step.cuh), the step's and the
// force_field ones, of the KBC family (collisions.cuh Kbc): one instance per
// pattern and mode for the eight variants N1-N4 and C1-C4, chosen at run
// time by the kbc bits (1 the trace, 2 the heat flux, 4 its central
// moments).  Entry tnl_lbm_coll_kbc, collision 0.

#include "coll_step.cuh"

COLL_KERNELS(kbc, lbm::Kbc, false)

static const lbm::CollRow KBC_FAMILY[] = {COLL_ROW(kbc)};

COLL_ENTRY(tnl_lbm_coll_kbc, KBC_FAMILY)
