"""Hyperbolic layers (counterpart of ``hyperspace_tpu/nn/layers.py``):
the gyro-linear layer ``HypLinear`` (Ganea et al. 2018, kernel N5), the
fully-hyperbolic ``LorentzLinear`` (Chen et al. ACL 2022) and the
tangent-space activation ``HypAct`` (Chami et al. 2019).

``LorentzLinear``: the full ambient input (time and space coordinates)
feeds an ordinary matmul that gives the output's space coordinates; the
time coordinate is rebuilt from the hyperboloid constraint
t = √(1/c + ‖space‖²).  An activation, when given, acts on the whole
ambient input, time coordinate included, as in the JAX layer.  Every
kernel keeps JAX's (d_in, d_out) layout, and a manifold-valued bias is
stored as a tangent vector at the origin, mapped by ``expmap0`` in the
forward pass.  :func:`params_from_flax` carries a flax parameter tree
across as a ``state_dict``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from hyperspace_torch.kernels.hyplinear import hyp_linear
from hyperspace_torch.manifolds.lorentz import with_time_coordinate
from hyperspace_torch.precision import compute_matmul


def params_from_flax(tree, dtype: torch.dtype = torch.float32) -> dict:
    """A ``state_dict`` from a flax parameter tree of numpy arrays: nested
    names joined by dots, kernels in JAX's (d_in, d_out) layout, every
    leaf in ``dtype``.  A ``HypLinear``'s ``{"kernel", "bias"}`` becomes
    the port layer's state as it is."""
    out = {}

    def walk(prefix, node):
        for name, sub in node.items():
            key = f"{prefix}{name}"
            if isinstance(sub, dict) or hasattr(sub, "items"):
                walk(key + ".", sub)
            else:
                out[key] = torch.as_tensor(np.array(sub, np.float64)).to(dtype)

    walk("", tree)
    return out


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


class HypLinear(nn.Module):
    """Gyro-linear layer on the Poincaré ball: y = proj((M ⊗_c x) ⊕_c b),
    ball points [..., d_in] → ball points [..., features], through the
    fused kernel ``hyp_linear``.  The bias is a tangent vector at the
    origin, mapped by the manifold's ``expmap0`` (a method, not the
    kernel); without one, b = 0 (x ⊕ 0 = x exactly)."""

    def __init__(self, d_in: int, features: int, manifold, *,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.manifold = manifold
        self.kernel = nn.Parameter(glorot_uniform((d_in, features),
                                                  generator, dtype))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=dtype))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None:
            b = torch.zeros(self.kernel.shape[1], dtype=x.dtype,
                            device=x.device)
        else:
            b = self.manifold.expmap0(self.bias)
        return hyp_linear(x, self.kernel, b, self.manifold.c)


class HypAct(nn.Module):
    """Tangent-space activation with curvature transfer (HGCN):
    y = exp0^{out}(tangent(act(coords(log0^{in}(x))))), the activation
    taken in the origin chart's orthonormal coordinates, so that any
    elementwise nonlinearity keeps a valid tangent vector."""

    def __init__(self, manifold_in: Any, manifold_out: Any,
                 activation: Callable = torch.relu):
        super().__init__()
        self.manifold_in = manifold_in
        self.manifold_out = manifold_out
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m_in, m_out = self.manifold_in, self.manifold_out
        v = m_in.origin_coords_from_tangent(m_in.logmap0(x))
        v = self.activation(v)
        return m_out.expmap0(m_out.tangent_from_origin_coords(v))
