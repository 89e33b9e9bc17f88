"""PyTorch/CUDA port of the tnl_lbm_tpu Lattice Boltzmann framework.

The JAX package ``tnl_lbm_tpu`` is the reference; this package mirrors its
layout (``models``, ``utils``, ``ops``, ``sim``, ``kernels``, ``apps``) and
its function names, on torch tensors:

- state is ``f: [Q, X, Y, Z]``, contiguous, z fastest (the JAX layout), so a
  port state can be compared with the JAX state after every step;
- every entry point takes an explicit ``device``; asking for ``cuda``
  without a card raises, nothing moves to the CPU by itself;
- the A-A kernels (even, odd, and the one-kernel pair with optional
  16-bit storage) and the bandwidth probes are hand-written CUDA C++ for
  Hopper (``csrc/``); their plain PyTorch versions sit beside them in
  ``kernels/fused_aa.py`` and ``kernels/probes.py`` and serve CPU tensors
  and the tests.

This package never imports jax.
"""

__version__ = "0.1.0"
