"""Immersed boundary method (Wu-Shu velocity correction) subsystem
(counterpart of ``tnl_lbm_tpu/ibm``)."""

from tnl_lbm_tpu_torch.ibm.dirac import dirac_delta, dirac_support
from tnl_lbm_tpu_torch.ibm.lagrange import IBM

__all__ = ["IBM", "dirac_delta", "dirac_support"]
