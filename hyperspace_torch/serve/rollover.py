"""Blue-green rollover: warm a standby engine, gate, flip, drain
(counterpart of ``hyperspace_tpu/serve/rollover.py``).

A rollover replaces the whole serving stack behind the front door (new
artifact, engine, batcher and collator) without dropping an in-flight
request:

1. **Prepare (blocking, off the loop).**  Build the standby batcher from
   the target artifact and run its :meth:`RequestBatcher.prewarm` ladder,
   then sync the card, so the standby's tables and every bucket's first
   launch are done before it can take traffic.
2. **Gate.**  The flip is refused unless the standby's health body (the
   identity fields ``GET /healthz`` serves) is present, ok and
   undegraded (:func:`gate_flip`).
3. **Flip (one event-loop step).**  The door's ``batcher`` and
   ``collator`` are reassigned together: a request routed before the
   step uses the old stack end to end, one routed after the new.  The
   batcher caches are keyed by fingerprint and scan signature, so the
   old engine's cached rows are unreachable.
4. **Drain the old stack.**  Its pending buckets flush (they answer from
   the old engine, the prefix they were admitted under) and its
   executor is released without blocking the loop.  Once its last
   dispatch returns, nothing holds the old engine and its tensors go
   back to the caching allocator.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, Optional, Sequence

import torch

from hyperspace_torch.serve.batcher import RequestBatcher
from hyperspace_torch.serve.collator import Collator
from hyperspace_torch.telemetry import registry as telem

# the health fields a flip inspects; all must be present
GATE_FIELDS = ("ok", "fingerprint", "scan_signature", "precision",
               "degrade_level")

DEFAULT_PREWARM_KS = (10,)


def standby_health(batcher: RequestBatcher) -> dict:
    """The health body of a batcher that does not serve yet: the
    identity fields ``GET /healthz`` exposes, minus the uptime."""
    eng = batcher.engine
    return {
        "ok": True,
        "fingerprint": eng.fingerprint,
        "scan_signature": list(eng.scan_signature),
        "precision": eng.precision,
        "degrade_level": batcher.degrade_level,
    }


def gate_flip(body: dict) -> None:
    """Refuse a flip unless the standby's health body is green: every
    :data:`GATE_FIELDS` entry present, ``ok`` true, ``degrade_level``
    0."""
    missing = [f for f in GATE_FIELDS if body.get(f) is None]
    if missing:
        raise ValueError(
            f"rollover gate: standby health body is missing {missing} "
            "— refusing to flip onto an engine whose identity the "
            "cache key cannot express")
    if body["ok"] is not True:
        raise ValueError("rollover gate: standby reports ok=false")
    if int(body["degrade_level"]) != 0:
        raise ValueError(
            f"rollover gate: standby is degraded "
            f"(level {body['degrade_level']}) — it must come up at "
            "full quality before taking traffic")


class RolloverCoordinator:
    """Drives blue-green flips for one
    :class:`~hyperspace_torch.serve.server.HttpFrontDoor`.

    ``builder(target)`` constructs the standby ``RequestBatcher`` for a
    rollover target (the CLI passes its artifact loader); it runs on the
    loop's default executor and may block."""

    def __init__(self, door, builder: Callable[[str], RequestBatcher], *,
                 prewarm_ks: Optional[Sequence[int]] = None):
        self.door = door
        self.builder = builder
        self.prewarm_ks = list(prewarm_ks or DEFAULT_PREWARM_KS)
        self.flips = 0
        self._busy = False  # one rollover at a time (loop-affine flag)

    def _prepare(self, target: str) -> tuple[RequestBatcher, dict]:
        """Build and prewarm the standby; its work on the card is done
        when this returns.  Runs off the loop."""
        standby = self.builder(target)
        info = standby.prewarm(self.prewarm_ks)
        dev = standby.engine.device
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        return standby, info

    async def rollover(self, target: str) -> dict:
        """Prepare → gate → flip → drain; returns the flip report.
        Raises ``ValueError`` when the gate refuses (the old stack keeps
        serving, untouched)."""
        if self._busy:
            raise ValueError(
                "rollover already in progress — one at a time (the "
                "standby build owns the device build bandwidth)")
        self._busy = True
        try:
            t0 = time.perf_counter()
            loop = asyncio.get_running_loop()
            old_fp = self.door.batcher.engine.fingerprint
            standby, info = await loop.run_in_executor(
                None, self._prepare, target)
            health = standby_health(standby)
            gate_flip(health)
            self.flip(standby)
            self.flips += 1
            telem.inc("serve/rollover_flips", 1)
            return {
                "flipped": True,
                "old_fingerprint": old_fp,
                "new_fingerprint": standby.engine.fingerprint,
                "scan_signature": health["scan_signature"],
                "prewarmed_programs": info["programs"],
                "seconds": round(time.perf_counter() - t0, 3),
            }
        finally:
            self._busy = False

    def flip(self, standby: RequestBatcher) -> None:
        """The swap: one event-loop step reassigns the door's batcher and
        collator, then drains the old stack.  Under a registry the new
        collator keeps the shared executor and fair dispatcher (two
        one-worker executors would race on the card)."""
        door = self.door
        old_collator = door.collator
        new_collator = Collator(
            standby, max_wait_us=old_collator.max_wait_s * 1e6,
            executor=(None if old_collator._owns_exec
                      else old_collator._exec),
            dispatcher=old_collator._dispatcher,
            tenant=old_collator.tenant)
        door.batcher = standby
        door.collator = new_collator
        old_collator.flush_all()
        old_collator.close(wait=False)
