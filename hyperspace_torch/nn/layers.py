"""The fully-hyperbolic Lorentz linear layer (counterpart of
``hyperspace_tpu/nn/layers.py``, ``LorentzLinear``; Chen et al. ACL 2022).

The full ambient input (time and space coordinates) feeds an ordinary
matmul that gives the output's space coordinates; the time coordinate is
rebuilt from the hyperboloid constraint t = √(1/c + ‖space‖²).  An
activation, when given, acts on the whole ambient input, time coordinate
included, as in the JAX layer.  The kernel keeps JAX's (d_in, d_out)
layout.  ``HypLinear`` and ``HypAct`` are not ported yet (``hyp_linear``
is another slice's kernel).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from hyperspace_torch.manifolds.lorentz import with_time_coordinate
from hyperspace_torch.precision import compute_matmul


def glorot_uniform(shape, generator: Optional[torch.Generator] = None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax's ``glorot_uniform`` for a (fan_in, fan_out) matrix: uniform
    in ±√(6 / (fan_in + fan_out)) (other bits than JAX's)."""
    lim = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    return (torch.rand(shape, generator=generator, dtype=dtype) * 2.0
            - 1.0) * lim


class LorentzLinear(nn.Module):
    """Hyperboloid points [..., d_in] → hyperboloid points [..., dim + 1].

    ``compute_dtype`` (the precision policy's) runs the matmul alone in
    that dtype; the bias add and the time coordinate stay in the input's
    dtype."""

    def __init__(self, d_in: int, dim: int, manifold, *,
                 activation: Optional[Callable] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.manifold = manifold
        self.activation = activation
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(glorot_uniform((d_in, dim), generator,
                                                  dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.activation is None else self.activation(x)
        space = compute_matmul(h, self.kernel, self.compute_dtype)
        return with_time_coordinate(space + self.bias, self.manifold.c)
