// B10's instances (nn_coll.cuh) of the SRT and BGK family: SRT,
// SRT_MODIF_FORCE, SRT_WELL, BGK and BGK_WELL (collisions.cuh), per mode.
// Entry tnl_lbm_nn_coll_srt, collision index in that order (as
// tnl_lbm_coll_srt's).

#include "nn_coll.cuh"

NN_COLL_KERNELS(srt, Srt, false)
NN_COLL_KERNELS(srt_modif_force, SrtModifForce, false)
NN_COLL_KERNELS(srt_well, SrtWell, true)
NN_COLL_KERNELS(bgk, Bgk, false)
NN_COLL_KERNELS(bgk_well, BgkWell, true)

static const NNCollRow NN_SRT_FAMILY[] = {NN_COLL_ROW(srt), NN_COLL_ROW(srt_modif_force),
                                          NN_COLL_ROW(srt_well), NN_COLL_ROW(bgk),
                                          NN_COLL_ROW(bgk_well)};

NN_COLL_ENTRY(tnl_lbm_nn_coll_srt, NN_SRT_FAMILY)
