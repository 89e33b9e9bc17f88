"""Lattice velocity sets: the JAX package's jax-free descriptors, re-exported."""

from tnl_lbm_tpu.models.descriptors import D2Q9, D3Q7, D3Q27, LatticeDescriptor

__all__ = ["LatticeDescriptor", "D3Q27", "D2Q9", "D3Q7"]
