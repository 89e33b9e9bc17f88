"""The sharded lattice: plans over a grid of devices, the halo exchange and
the sharded steps (counterpart of ``tnl_lbm_tpu/parallel``)."""
