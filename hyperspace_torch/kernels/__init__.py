"""Hand-written CUDA kernels for Hopper (``csrc/``) with their plain
PyTorch versions (counterpart of ``hyperspace_tpu.kernels``).

The public ops under the JAX package's names.  The fused top-k scans
live in the submodule ``hyperspace_torch.kernels.scan_topk`` and are not
re-exported here: the entry point shares the module's name, and a
function attribute would shadow the submodule."""

from hyperspace_torch.kernels.attention import flash_attention
from hyperspace_torch.kernels.hyplinear import hyp_linear
from hyperspace_torch.kernels.mlr import hyp_mlr
from hyperspace_torch.kernels.pointwise import (expmap, expmap0, logmap,
                                                logmap0, mobius_add,
                                                mobius_scalar_mul, ptransp)

__all__ = ["mobius_add", "mobius_scalar_mul", "expmap", "logmap", "expmap0",
           "logmap0", "ptransp", "hyp_mlr", "hyp_linear", "flash_attention"]
