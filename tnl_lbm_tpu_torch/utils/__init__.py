"""Common utilities: physical-unit conversions, dtype policy, logging, files."""

from tnl_lbm_tpu_torch.utils.dtypes import Traits, TraitsDP, TraitsSP
from tnl_lbm_tpu_torch.utils.units import Lattice

__all__ = ["Lattice", "Traits", "TraitsSP", "TraitsDP"]
