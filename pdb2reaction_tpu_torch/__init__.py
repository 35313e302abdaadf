"""pdb2reaction_tpu_torch: the PyTorch + CUDA port of pdb2reaction_tpu.

The package mirrors the layout of ``pdb2reaction_tpu`` module by module.
It imports ``torch`` and never ``jax``: the JAX package is the reference
that the port is tested against, not a dependency. The eSCN force path's
two fused kernels (``mlip/escn_edge_kernel.py``, ``mlip/escn_ffn_kernel.py``)
are hand-written CUDA C++ for Hopper (``csrc/``), each with a plain
PyTorch version beside it that CPU tensors take.
"""

__version__ = "0.1.0"
