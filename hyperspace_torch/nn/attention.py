"""Hyperbolic attention (counterpart of ``hyperspace_tpu/nn/attention.py``;
Gulcehre et al. 2019, HyboNet: Chen et al. ACL 2022).

The score of query q against key k is affine in their squared Lorentz
distance, s(q, k) = (−d²_L(q, k) + β)/τ = (2/c + 2⟨q, k⟩_L + β)/τ, and
the values aggregate to the Lorentz centroid of the softmax weights, so
outputs stay on the hyperboloid.  The score matrix is one Minkowski Gram
matmul, the centroid numerator another.

- :func:`lorentz_attention`: the dense manifold form;
- :func:`lorentz_attention_tiled`: the same over KV blocks with an
  online softmax (``impl="scan"``);
- :class:`HypMultiHeadAttention`: Q/K/V projections into per-head
  hyperboloids, attention (``impl="flash"``, the default, is
  ``kernels.attention.flash_attention``), heads merged by
  ``with_time_coordinate`` and an output :class:`LorentzLinear`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from hyperspace_torch.kernels.attention import flash_attention
from hyperspace_torch.manifolds import smath
from hyperspace_torch.manifolds.lorentz import with_time_coordinate
from hyperspace_torch.nn.layers import LorentzLinear, glorot_uniform
from hyperspace_torch.precision import compute_matmul


def minkowski_gram(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[..., Nq, D] × [..., Nk, D] → ⟨q_i, k_j⟩_L as one matmul."""
    k_flip = torch.cat([-k[..., :1], k[..., 1:]], dim=-1)
    return torch.matmul(q, k_flip.transpose(-1, -2))


def _mdot_self(s: torch.Tensor) -> torch.Tensor:
    return (torch.sum(s[..., 1:] * s[..., 1:], dim=-1, keepdim=True)
            - s[..., :1] * s[..., :1])


def _normalize(s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    nrm = smath.safe_sqrt(smath.clamp_min(-_mdot_self(s),
                                          smath.eps_for(s.dtype)))
    return s / (smath.safe_sqrt(c) * nrm)


def lorentz_attention(q, k, v, manifold, *, beta=0.0, tau=1.0, mask=None):
    """Dense hyperbolic attention; returns hyperboloid points [..., Nq, D].
    ``mask`` [..., Nq, Nk], True attends."""
    c = smath.as_scalar(manifold.c, q)
    sqd = -2.0 / c - 2.0 * minkowski_gram(q, k)   # squared Lorentz distance
    logits = (-sqd + beta) / tau
    if mask is not None:
        logits = torch.where(mask, logits, -math.inf)
    w = torch.softmax(logits, dim=-1)
    w = torch.where(torch.isnan(w), torch.zeros_like(w), w)  # empty rows
    return _normalize(torch.matmul(w, v), c)


def lorentz_attention_tiled(q, k, v, manifold, *, beta=0.0, tau=1.0,
                            mask=None, block_size: int = 128):
    """:func:`lorentz_attention` over KV blocks of ``block_size`` with an
    online softmax, carrying (running max, denominator, numerator)."""
    c = smath.as_scalar(manifold.c, q)
    nk = k.shape[-2]
    pad = (-nk) % block_size
    if pad:
        zeros = k.new_zeros(k.shape[:-2] + (pad, k.shape[-1]))
        k, v = torch.cat([k, zeros], dim=-2), torch.cat([v, zeros], dim=-2)
        if mask is None:
            live = torch.arange(nk + pad, device=q.device) < nk
            mask = torch.broadcast_to(live, q.shape[:-1] + (nk + pad,))
        else:
            mask = torch.cat([mask, torch.zeros(
                mask.shape[:-1] + (pad,), dtype=torch.bool,
                device=mask.device)], dim=-1)
    m = torch.full(q.shape[:-1], -math.inf, dtype=q.dtype, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    s = torch.zeros_like(q)
    for j0 in range(0, k.shape[-2], block_size):
        kj, vj = k[..., j0:j0 + block_size, :], v[..., j0:j0 + block_size, :]
        maskj = None if mask is None else mask[..., j0:j0 + block_size]
        logits = (2.0 / c + 2.0 * minkowski_gram(q, kj) + beta) / tau
        if maskj is not None:
            logits = torch.where(maskj, logits, -math.inf)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        alpha = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                      -math.inf))
        p = torch.exp(logits - m_safe[..., None])
        if maskj is not None:
            p = torch.where(maskj, p, 0.0)
        l = alpha * l + torch.sum(p, dim=-1)
        s = alpha[..., None] * s + torch.matmul(p, vj)
        m = m_new
    s = s / smath.clamp_min(l, smath.min_norm(q.dtype))[..., None]
    return _normalize(s, c)


class HypMultiHeadAttention(nn.Module):
    """Multi-head hyperbolic self-attention on the hyperboloid (the JAX
    module's cross-attention input ``x_kv`` has no caller and is not
    ported).

    ``d_in`` is the ambient width of the inputs (``dim + 1`` inside
    HyboNet), ``dim`` the total manifold width over the heads.  Q/K/V are
    bias-free projections into ``num_heads`` hyperboloids of dimension
    ``dim // num_heads``; per-head β (zeros) and τ = softplus(τ_raw) +
    1e-4 (τ = 1 at init) shape [h, 1, 1].
    ``torch.nn.functional.softplus`` switches to the identity above 20
    where ``jax.nn.softplus`` does not; the two agree at float32 there
    (the dropped term, log1p(e^-20), is below half an ulp of 20)."""

    def __init__(self, d_in: int, dim: int, num_heads: int = 4,
                 manifold=None, *, impl: str = "flash",
                 compute_dtype: Optional[torch.dtype] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h = num_heads
        if dim % h:
            raise ValueError(f"dim {dim} must divide num_heads {h}")
        if impl not in ("flash", "scan"):
            raise ValueError(f"unknown attention impl {impl!r}")
        self.num_heads, self.head_dim = h, dim // h
        self.manifold, self.impl = manifold, impl
        self.compute_dtype = compute_dtype
        for name in ("q", "k", "v"):
            setattr(self, f"{name}_kernel", nn.Parameter(
                glorot_uniform((d_in, dim), generator, dtype)))
        self.beta = nn.Parameter(torch.zeros((h, 1, 1), dtype=dtype))
        self.tau_raw = nn.Parameter(torch.full(
            (h, 1, 1), math.log(math.expm1(1.0)), dtype=dtype))
        self.out = LorentzLinear(dim + 1, dim, manifold,
                                 compute_dtype=compute_dtype, dtype=dtype,
                                 generator=generator)

    def _proj(self, kernel: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """[..., N, d_in] → h stacked head hyperboloids [..., h, N, dh+1]."""
        space = compute_matmul(x, kernel, self.compute_dtype)
        space = space.reshape(space.shape[:-1]
                              + (self.num_heads, self.head_dim))
        return with_time_coordinate(space.transpose(-3, -2), self.manifold.c)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [..., N, d_in], mask [..., N, N] (True attends) →
        [..., N, dim + 1]."""
        q, k, v = (self._proj(w, x) for w in (self.q_kernel, self.k_kernel,
                                              self.v_kernel))
        tau = nn.functional.softplus(self.tau_raw) + 1e-4
        if mask is not None:
            mask = mask[..., None, :, :]               # broadcast over heads
        if self.impl == "scan":
            o = lorentz_attention_tiled(q, k, v, self.manifold,
                                        beta=self.beta, tau=tau, mask=mask)
        else:
            o = flash_attention(q, k, v, self.manifold.c, beta=self.beta,
                                tau=tau, mask=mask)
        o_sp = o[..., 1:].transpose(-3, -2)             # [..., N, h, dh]
        o_sp = o_sp.reshape(o_sp.shape[:-2] + (-1,))
        return self.out(with_time_coordinate(o_sp, self.manifold.c))
