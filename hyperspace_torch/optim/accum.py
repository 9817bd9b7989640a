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
- a stateful optimizer with ``step(grads, apply=)`` (``optim/adamw.py``,
  HyboNet's) is wrapped by :class:`GradAccumulation`, which steps the
  inner optimizer on the k-th microstep only: chosen on the host in an
  eager step, on the device in a step a CUDA graph captures.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.utils._pytree as pytree

from hyperspace_torch.optim.adamw import divisors, set_count
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
    """A stateful optimizer (``params``, ``step(grads=None, apply=None)``,
    ``state_dict``; ``optim/adamw.py``) behind microbatch accumulation:
    ``step`` adds the gradients (default each parameter's ``.grad``) into
    the running mean and steps ``inner`` with it on every
    ``every_k``-th call.

    The counts are 0-dim device tensors, so that a CUDA graph of the step
    advances them.  Two forms of one step, bit for bit the same: an eager
    step chooses on the host, from a host copy of ``mini_step`` (read from
    the device once after a restore or a replayed graph), and runs the
    inner update on the k-th microstep only; a step that a CUDA graph
    captures (:meth:`step_on_device`) chooses on the device with
    ``torch.where`` (``inner.step(..., apply=)``), so it computes the
    inner update every microstep and keeps it on the k-th, and divides the
    running mean as PyTorch divides by a Python number
    (``adamw.divisors``)."""

    def __init__(self, inner, every_k: int):
        self.inner, self.k = inner, int(every_k)
        self.params = inner.params
        dev = self.params[0].device if self.params else None
        self.mini_step = torch.zeros((), dtype=torch.int64, device=dev)
        self.gradient_step = torch.zeros((), dtype=torch.int64, device=dev)
        self.acc = [torch.zeros_like(p) for p in self.params]
        self._n = 0             # mini_step on the host; None: unknown

    @torch.no_grad()
    def step(self, grads=None) -> None:
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        if self.mini_step.is_cuda and torch.cuda.is_current_stream_capturing():
            self.step_on_device(grads)
            return
        if self._n is None:
            self._n = int(self.mini_step)
        n = self._n
        for a, g in zip(self.acc, grads):
            a.copy_(a + (g - a) / (n + 1))
        if n == self.k - 1:
            self.inner.step(self.acc)
            for a in self.acc:
                a.zero_()
            self.gradient_step.add_(1)
        self._n = (n + 1) % self.k
        self.mini_step.fill_(self._n)

    @torch.no_grad()
    def step_on_device(self, grads) -> None:
        """:meth:`step` with the choice made on the device (the form a
        CUDA graph captures); the host copy of the count is dropped."""
        self._n = None          # replays advance the count unseen
        n = self.mini_step
        by_dtype = {}
        for a, g in zip(self.acc, grads):
            if a.dtype not in by_dtype:     # (g − a) / (n + 1) as a Python n
                by_dtype[a.dtype] = divisors(
                    (n + 1).to(torch.float64).reshape(1), a.dtype,
                    a.is_cuda)[0]
            op, d = by_dtype[a.dtype]
            a.copy_(a + op(g - a, d))
        emit = n == self.k - 1
        self.inner.step(self.acc, apply=emit)
        for a in self.acc:
            a.masked_fill_(emit, 0.0)
        self.gradient_step.add_(emit.to(torch.int64))
        self.mini_step.copy_((n + 1) % self.k)

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step,
                "gradient_step": self.gradient_step, "acc": self.acc,
                "inner": self.inner.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self._n = None
        set_count(self.mini_step, sd["mini_step"])
        set_count(self.gradient_step, sd["gradient_step"])
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
