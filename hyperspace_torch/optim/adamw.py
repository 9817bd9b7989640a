"""optax's AdamW, optionally behind ``clip_by_global_norm``, by hand
(counterpart of ``optax.chain(clip_by_global_norm, adamw)`` and of
``optax.adamw`` as the JAX package's models use them)."""

from __future__ import annotations

from typing import Optional

import torch


class AdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(lr, wd))`` by
    hand, in optax's order of operations: b1 0.9, b2 0.999, eps 1e-8
    outside the square root, decoupled decay on every parameter;
    ``max_norm=None`` (the default) is plain ``optax.adamw``, with no clip
    at all.  Parameters are taken in sorted name order, the order of the
    flax tree's leaves."""

    def __init__(self, named_params, lr: float, weight_decay: float,
                 max_norm: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.names = sorted(named_params)
        self.params = [named_params[k] for k in self.names]
        self.lr, self.wd, self.max_norm = lr, weight_decay, max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads=None) -> None:
        """One update from ``grads`` (default: each parameter's
        ``.grad``), in place."""
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        if self.max_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            trigger = g_norm < self.max_norm
            grads = [torch.where(trigger, g, (g / g_norm) * self.max_norm)
                     for g in grads]
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.wd * p
            p.add_(-self.lr * u)

    def state_dict(self) -> dict:
        """The update count and the moments (the live tensors), for
        ``train/checkpoint.py``."""
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Set the count and copy the moments into the live tensors."""
        self.count = int(sd["count"])
        for live, saved in zip(self.mu + self.nu, list(sd["mu"])
                               + list(sd["nu"])):
            if saved is not live:
                live.copy_(saved)
