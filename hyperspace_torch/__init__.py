"""PyTorch/CUDA port of hyperspace_tpu.

The JAX package ``hyperspace_tpu`` is the reference; this package mirrors
its module names (``manifolds/``, ``kernels/``, ``serve/``, ``cli/``) so a
reader can find each counterpart.  It imports ``torch``, numpy and the
standard library only.  Kernels are hand-written CUDA C++ for Hopper
(``kernels/csrc/``), built with ``nvcc`` at first use; every kernel has a
plain PyTorch version beside it that runs only for tensors on the CPU.

Ported so far: the exact k-NN / edge-score serving path (artifact →
``serve.QueryEngine`` → ``serve.RequestBatcher`` → ``cli.serve``).
"""
