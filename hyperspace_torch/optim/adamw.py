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
    flax tree's leaves.

    The update count is a 0-dim int64 tensor on the parameters' device,
    so a CUDA graph of a step replays each step's own bias corrections.
    ``1 − b^t`` is computed in float64 on the device and the moments are
    divided by it as PyTorch divides a tensor by a Python float (on the
    CPU by the correction rounded to the parameter's dtype, on the card
    times its float64 reciprocal so rounded), so a step's bits are those
    of the Python-count update it replaces: on the CPU always, on the card
    wherever CUDA's float64 ``pow`` gives the host's bits (it differs by
    an ulp for some t, which moves the rounded correction only when it
    sits at a rounding boundary)."""

    def __init__(self, named_params, lr: float, weight_decay: float,
                 max_norm: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.names = sorted(named_params)
        self.params = [named_params[k] for k in self.names]
        self.lr, self.wd, self.max_norm = lr, weight_decay, max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        dev = self.params[0].device if self.params else None
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self._betas = torch.tensor([b1, b2], dtype=torch.float64,
                                   device=dev)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads=None, apply: Optional[torch.Tensor] = None) -> None:
        """One update from ``grads`` (default: each parameter's
        ``.grad``), in place.  ``apply``, a 0-dim bool tensor, keeps the
        update only where it is true (parameters, moments and count stay
        as they were otherwise): the choice is made on the device."""
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        if self.max_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            trigger = g_norm < self.max_norm
            grads = [torch.where(trigger, g, (g / g_norm) * self.max_norm)
                     for g in grads]
        self.count.add_(1 if apply is None else apply.to(torch.int64))
        bc = 1.0 - torch.pow(self._betas, self.count)
        by_dtype = {}
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            if p.dtype not in by_dtype:   # one rounding a dtype
                by_dtype[p.dtype] = divisors(bc, p.dtype, p.is_cuda)
            (f1, bc1), (f2, bc2) = by_dtype[p.dtype]
            m = (1.0 - self.b1) * g + self.b1 * mu
            v = (1.0 - self.b2) * (g * g) + self.b2 * nu
            u = f1(m, bc1) / (torch.sqrt(f2(v, bc2)) + self.eps)
            u = u + self.wd * p
            if apply is None:
                mu.copy_(m)
                nu.copy_(v)
                p.add_(-self.lr * u)
            else:
                mu.copy_(torch.where(apply, m, mu))
                nu.copy_(torch.where(apply, v, nu))
                p.copy_(torch.where(apply, p + (-self.lr * u), p))

    def state_dict(self) -> dict:
        """The update count and the moments (the live tensors), for
        ``train/checkpoint.py``."""
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy the count (a tensor, or the number of a checkpoint that
        held one) and the moments into the live tensors."""
        set_count(self.count, sd["count"])
        for live, saved in zip(self.mu + self.nu, list(sd["mu"])
                               + list(sd["nu"])):
            if saved is not live:
                live.copy_(saved)


def divisors(bc: torch.Tensor, dtype: torch.dtype, cuda: bool) -> list:
    """``[(op, operand)]`` for each float64 bias correction in ``bc``,
    dividing as PyTorch divides a ``dtype`` tensor by a Python float: on
    the CPU by the correction rounded to ``dtype``; on the card times its
    reciprocal, taken in float64 and rounded to ``dtype``."""
    if cuda:
        return [(torch.mul, r) for r in (1.0 / bc).to(dtype).unbind()]
    return [(torch.div, d) for d in bc.to(dtype).unbind()]


@torch.no_grad()
def set_count(live: torch.Tensor, saved) -> None:
    """Copy a saved count (a tensor or a Python number) into ``live``."""
    if isinstance(saved, torch.Tensor):
        if saved is not live:
            live.copy_(saved)
    else:
        live.fill_(int(saved))
