"""Hand-written CUDA kernels for Hopper (``csrc/``) with their plain
PyTorch versions (counterpart of ``hyperspace_tpu.kernels``)."""
