"""Vectorized LBM operators on torch tensors: BCs, moments, streaming, collision."""
