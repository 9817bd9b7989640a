"""Gradient accumulation (counterpart of ``hyperspace_tpu/optim/accum.py``,
``optax.MultiSteps(opt, every_k_schedule=k)``).

Every k-th update applies the inner optimizer to the mean of the last k
microbatch gradients; the other updates leave the parameters, the inner
optimizer's state and its count as they were.  The mean is optax's
running (Welford) form, ``acc + (g − acc) / (n + 1)``, and the buffer is
zeroed after the k-th microstep.

Two forms, one for each kind of optimizer in the port:

- a :class:`~hyperspace_torch.optim.common.Transformation` (the HVAE's
  Adam) is wrapped functionally: the state is :class:`MultiStepsState`,
  every quantity a device tensor and the choice between the inner update
  and none a ``torch.where``, so a CUDA graph of the step replays it (as
  optax, the inner update is computed every microstep and kept on the
  k-th);
- a stateful optimizer with ``step(grads)`` (``optim/adamw.py``,
  HyboNet's) is wrapped by :class:`GradAccumulation`, which steps the
  inner optimizer in place on the k-th microstep only.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.utils._pytree as pytree

from hyperspace_torch.optim.common import Transformation, first_leaf


class MultiStepsState(NamedTuple):
    mini_step: torch.Tensor          # 0-dim int64: microsteps since an update
    gradient_step: torch.Tensor      # 0-dim int64: updates applied
    inner_opt_state: Any
    acc_grads: Any                   # running mean of the microbatch grads


def multi_steps(inner: Transformation, every_k: int) -> Transformation:
    """``optax.MultiSteps(inner, every_k_schedule=every_k)`` with the mean
    of the gradients."""
    k = int(every_k)

    def init(params):
        dev = first_leaf(params).device
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return MultiStepsState(zero, zero.clone(), inner.init(params),
                               pytree.tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        n = state.mini_step
        acc = pytree.tree_map(lambda g, a: a + (g - a) / (n + 1).to(a.dtype),
                              grads, state.acc_grads)
        updates, inner_state = inner.update(acc, state.inner_opt_state,
                                            params)
        emit = n == k - 1
        new = MultiStepsState(
            mini_step=(n + 1) % k,
            gradient_step=state.gradient_step + emit.to(torch.int64),
            inner_opt_state=pytree.tree_map(
                lambda new, old: torch.where(emit, new, old), inner_state,
                state.inner_opt_state),
            acc_grads=pytree.tree_map(lambda a: a * (~emit).to(a.dtype),
                                      acc))
        return pytree.tree_map(lambda u: u * emit.to(u.dtype), updates), new

    return Transformation(init, update)


class GradAccumulation:
    """A stateful optimizer (``params``, ``step(grads=None)``,
    ``state_dict``) behind microbatch accumulation: ``step`` adds the
    gradients (default each parameter's ``.grad``) into the running mean
    and steps ``inner`` with it on every ``every_k``-th call."""

    def __init__(self, inner, every_k: int):
        self.inner, self.k = inner, int(every_k)
        self.params = inner.params
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads=None) -> None:
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        n = self.mini_step
        for a, g in zip(self.acc, grads):
            a.copy_(a + (g - a) / (n + 1))
        if n == self.k - 1:
            self.inner.step(self.acc)
            for a in self.acc:
                a.zero_()
            self.gradient_step += 1
        self.mini_step = (n + 1) % self.k

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step,
                "gradient_step": self.gradient_step, "acc": self.acc,
                "inner": self.inner.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self.mini_step = int(sd["mini_step"])
        self.gradient_step = int(sd["gradient_step"])
        for live, saved in zip(self.acc, sd["acc"]):
            if saved is not live:
                live.copy_(saved)
        self.inner.load_state_dict(sd["inner"])


def with_grad_accumulation(opt, params, every_k: int):
    """``(optimizer, fresh state)`` accumulating ``every_k`` microbatch
    gradients an update; ``every_k <= 1`` returns ``opt`` itself.  A
    :class:`Transformation` gets its fresh state from ``params``; a
    stateful optimizer (state ``None``) is wrapped in
    :class:`GradAccumulation`.  A wrapped optimizer has another state, so
    the old one must not be reused."""
    if isinstance(opt, Transformation):
        if every_k <= 1:
            return opt, opt.init(params)
        wrapped = multi_steps(opt, every_k)
        return wrapped, wrapped.init(params)
    if every_k <= 1:
        return opt, None
    return GradAccumulation(opt, every_k), None
