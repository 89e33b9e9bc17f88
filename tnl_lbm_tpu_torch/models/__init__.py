"""Lattice velocity sets (the port's own, ``models/descriptors.py``)."""

from tnl_lbm_tpu_torch.models.descriptors import D2Q9, D3Q7, D3Q27, LatticeDescriptor

__all__ = ["LatticeDescriptor", "D3Q27", "D2Q9", "D3Q7"]
