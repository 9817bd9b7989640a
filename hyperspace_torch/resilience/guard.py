"""Training divergence guard: detect, rewind, back off, retry
(counterpart of ``hyperspace_tpu/resilience/guard.py``).

When the loop (``train/loop.py:run_loop``) sees a non-finite loss at a
log boundary, a save boundary or the run's end, or the health monitor
flags a boundary-margin or constraint violation past tolerance, the
:class:`RollbackController`:

1. records the incident in the run's JSONL stream (a ``rollback`` event:
   the step it fired at, the step it restored, the reason, the attempt
   number and the learning-rate backoff scale) and counts
   ``resilience/rollbacks``;
2. rewinds the training state to the last committed checkpoint (the
   commit rule resume trusts: an interrupted save is never a target);
3. re-projects the restored parameters onto their manifolds;
4. hands ``(restored_step, attempt, lr_scale)`` to the caller's
   ``on_rollback`` hook (``lr_scale = lr_backoff ** attempt``; the
   incident record carries it either way);
5. past ``max_rollbacks`` raises :class:`RollbackExhausted`: a
   divergence that persists ends the run.

The restore copies into the live tensors (``train/checkpoint.py``), where
JAX's copies the restored arrays for donation: a graphed chunked stepper
holds the state by address, and its captured graph stays valid after a
rollback.  The guard reads only the loss the log boundary reads anyway,
plus one host read per crossed save boundary, so with the guard on and
no fault the trajectory is bitwise the unguarded one.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional


class DivergenceError(FloatingPointError):
    """A divergence with no committed checkpoint to rewind to."""


class RollbackExhausted(RuntimeError):
    """Divergence persisted past the rollback budget."""


class RollbackController:
    """The run loop's rewind arm (made only when ``rollback > 0``).

    ``ck`` is the loop's :class:`~hyperspace_torch.train.checkpoint.
    CheckpointManager`, ``project`` the re-projection a restore applies,
    ``on_rollback(restored_step, attempt, lr_scale)`` the caller's hook
    (optional)."""

    def __init__(self, ck, *, max_rollbacks: int = 1,
                 lr_backoff: float = 0.5,
                 project: Optional[Callable] = None,
                 on_rollback: Optional[Callable[[int, int, float],
                                               None]] = None):
        if max_rollbacks < 1:
            raise ValueError(
                f"max_rollbacks must be >= 1; got {max_rollbacks}")
        if not 0.0 < lr_backoff <= 1.0:
            raise ValueError(
                f"lr_backoff must be in (0, 1]; got {lr_backoff}")
        self.ck = ck
        self.max_rollbacks = int(max_rollbacks)
        self.lr_backoff = float(lr_backoff)
        self.project = project
        self.on_rollback = on_rollback
        self.rollbacks = 0

    @property
    def lr_scale(self) -> float:
        return self.lr_backoff ** self.rollbacks

    def divergent(self, loss_val: float) -> bool:
        """The loss-side trigger, on the boundary's host value."""
        return not math.isfinite(loss_val)

    def rollback(self, state: Any, step: int, log=None,
                 reason: str = "non-finite loss") -> tuple[Any, int]:
        """Rewind to the last committed checkpoint; returns ``(state,
        restored_step)``.  Raises :class:`RollbackExhausted` past the
        budget and :class:`DivergenceError` with no committed step."""
        from hyperspace_torch.telemetry import registry as telem

        if self.rollbacks >= self.max_rollbacks:
            raise RollbackExhausted(
                f"divergence at step {step} persisted after "
                f"{self.rollbacks} rollback(s): {reason}")
        self.rollbacks += 1
        self.ck.wait()
        if self.ck.latest_committed_step() is None:
            raise DivergenceError(
                f"divergence at step {step} with no committed "
                f"checkpoint to roll back to: {reason}")
        state, restored = self.ck.restore(state, project=self.project)
        telem.inc("resilience/rollbacks")
        scale = self.lr_scale
        print(f"[resilience] rollback {self.rollbacks}/"
              f"{self.max_rollbacks}: step {step} -> {restored} "
              f"({reason}); lr_scale={scale:g}", flush=True)
        if log is not None:
            log.event("rollback", step=int(step),
                      restored_step=int(restored), reason=reason,
                      attempt=self.rollbacks, lr_scale=scale)
        if self.on_rollback is not None:
            self.on_rollback(int(restored), self.rollbacks, scale)
        return state, int(restored)
