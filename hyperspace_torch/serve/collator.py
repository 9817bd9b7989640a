"""Continuous-batching collator (counterpart of
``hyperspace_tpu/serve/collator.py``): fill a bucket or flush at T µs.

Requests arriving on the asyncio event loop run the batcher's validation
and cache pass at once; their cold ids gather in a pending bucket per
``(k, exclude_self, effective nprobe)`` group.  A group flushes when its
unique pending ids exactly fill a power-of-two rung of the batcher's
ladder (or reach the top bucket), or when ``max_wait_us`` has passed
since the group became non-empty, whichever comes first.

A flush is one :meth:`~hyperspace_torch.serve.batcher.RequestBatcher.
dispatch_topk` call on the **single dispatch executor** (a one-worker
thread pool).  All device work and every device-to-host copy run on that
thread, never on the event loop, so the loop keeps accepting while the
card works; PyTorch's current stream is per thread, so the traffic
launches on the dispatch thread's default stream, and :meth:`prewarm`
runs on the same thread so the caching allocator's blocks for each
bucket belong to that stream.  The shared dispatch is attributed to
every member's lifecycle while engine slots count once;
``serve/collator_flushes`` counts flushes, so ``serve/cache_miss /
serve/collator_flushes`` is the realized batching factor.

Deadlines count from the caller's ``t_enq`` (socket accept in the HTTP
front door).  At flush each member is re-checked: an expired member
answers ``deadline_exceeded`` and its ids leave the union without
failing the rest.  A member that expires mid-flight still caches its
rows and answers ``deadline_exceeded`` at completion.

Every structure here is touched only on the event loop; the batcher's
admission counter, ladder and LRU carry their own locks.  With spans on,
a flush builds one shared ``flush`` span adopted into every member's
tree and scoped on the dispatch thread with ``spans.use``.  JAX's
``FairDispatcher`` (multi-tenant fair dispatch) is not ported yet.
"""

from __future__ import annotations

import asyncio
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from hyperspace_torch.serve.batcher import (RequestBatcher, _CACHE_ONLY,
                                            _REQUEST_ERRORS, _Lifecycle,
                                            bucket_for)
from hyperspace_torch.serve.errors import (DeadlineExceededError,
                                           OverloadedError, kind_of)
from hyperspace_torch.telemetry import registry as telem
from hyperspace_torch.telemetry import spans

# default max-wait before a non-full pending bucket flushes (µs)
DEFAULT_MAX_WAIT_US = 2000


class _Member:
    """One awaiting topk request's share of a pending bucket."""

    __slots__ = ("fut", "misses", "life")

    def __init__(self, fut: asyncio.Future, misses: list, life: _Lifecycle):
        self.fut = fut
        self.misses = misses
        self.life = life


class _Group:
    """The pending bucket for one (k, exclude_self, nprobe_ov) key."""

    __slots__ = ("members", "pending", "timer", "keyf")

    def __init__(self, keyf):
        self.members: list[_Member] = []
        self.pending: set = set()  # unique cold ids across members
        self.timer = None
        self.keyf = keyf


class Collator:
    """Continuous batching over a :class:`RequestBatcher` (module
    docstring).  One collator serves one batcher and owns its dispatch
    executor; construct and use it on one event loop.  ``dispatcher=``
    (JAX's multi-tenant fair dispatch) raises: not ported yet."""

    def __init__(self, batcher: RequestBatcher, *,
                 max_wait_us: float = DEFAULT_MAX_WAIT_US,
                 dispatcher=None):
        if dispatcher is not None:
            raise ValueError("dispatcher= needs the multi-tenant "
                             "registry, which is not ported yet")
        if max_wait_us < 0:
            raise ValueError(
                f"max_wait_us must be >= 0; got {max_wait_us}")
        self.batcher = batcher
        self.max_wait_s = float(max_wait_us) / 1e6
        self._groups: dict[tuple, _Group] = {}
        self._exec = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="serve-dispatch")
        self._closed = False
        # monotone flush id, stamped on every member a flush examines
        # (expired ones included: a 504 names the flush that missed it)
        self._flush_seq = 0

    def _submit(self, fn) -> asyncio.Future:
        return asyncio.get_running_loop().run_in_executor(self._exec, fn)

    def prewarm(self, ks: Sequence[int], **kw) -> dict:
        """:meth:`RequestBatcher.prewarm` on the dispatch thread, waited
        for (blocking: call it before the listener opens)."""
        return self._exec.submit(
            functools.partial(self.batcher.prewarm, ks, **kw)).result()

    # --- public ops -----------------------------------------------------------

    async def topk(self, ids, k: int, *, exclude_self: bool = True,
                   deadline_ms: Optional[float] = None,
                   t_enq: Optional[float] = None,
                   request_id: Optional[str] = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """The batcher's ``topk`` contract, collated: the cold ids ride
        a shared flush with whatever else is pending."""
        b = self.batcher
        life = b._begin("topk", deadline_ms, t_enq, request_id)
        try:
            ids, k = b.validate_topk_request(ids, k)
            keyf, nprobe_ov, cache_only = b.plan_topk(k, exclude_self)
            rows, misses = b.cache_pass(ids, keyf, cache_only)
            life.cache_hits = len(rows)
            life.cache_misses = len(misses)
            life.check_deadline("after the cache pass")
            if misses:
                life.collated()
                computed = await self._enqueue(misses, k, exclude_self,
                                               nprobe_ov, keyf, life)
                life.result_ready()
                for qid in misses:
                    rows[qid] = computed[qid]
            else:
                life.formed()        # all hits: the request never queues
                life.result_ready()
                b._update_gauges()
            out_i = np.stack([rows[qid][0] for qid in ids])
            out_d = np.stack([rows[qid][1] for qid in ids])
            life.check_deadline("at completion")
            life.finish()
            b.emit_access(life)
            return out_i, out_d
        except _REQUEST_ERRORS as e:
            b.emit_access(life, kind_of(e))
            raise
        finally:
            b._release()

    async def score(self, u_ids, v_ids, *, prob: bool = False,
                    fd_r: float = 2.0, fd_t: float = 1.0,
                    deadline_ms: Optional[float] = None,
                    t_enq: Optional[float] = None,
                    request_id: Optional[str] = None) -> np.ndarray:
        """The batcher's ``score`` through the dispatch executor: admitted
        on arrival, not collated (pairs rarely repeat), serialized with
        the topk flushes."""
        b = self.batcher
        life = b._begin("score", deadline_ms, t_enq, request_id)
        try:
            if b._mode() == _CACHE_ONLY:
                raise OverloadedError(
                    "cache-only degradation: edge scoring is uncached")
            u, v = b.validate_score_request(u_ids, v_ids)
            life.formed()
            life.check_deadline("after validation")
            if self._closed:
                raise OverloadedError("server draining: dispatch closed")
            out = await self._submit(functools.partial(
                b.dispatch_score, u, v, prob=prob, fd_r=fd_r, fd_t=fd_t,
                lives=(life,), deadline_life=life, span_parent=life.span))
            life.result_ready()
            life.check_deadline("at completion")
            life.finish()
            b.emit_access(life)
            return out
        except _REQUEST_ERRORS as e:
            b.emit_access(life, kind_of(e))
            raise
        finally:
            b._release()

    async def upsert(self, ids, rows, *,
                     deadline_ms: Optional[float] = None,
                     t_enq: Optional[float] = None,
                     request_id: Optional[str] = None) -> dict:
        """The batcher's ``upsert`` on the dispatch executor (a frozen
        engine's ``validation`` answer)."""
        if self._closed:
            raise OverloadedError("server draining: dispatch closed")
        return await self._submit(functools.partial(
            self.batcher.upsert, ids, rows, deadline_ms=deadline_ms,
            t_enq=t_enq, request_id=request_id))

    async def delete(self, ids, *,
                     deadline_ms: Optional[float] = None,
                     t_enq: Optional[float] = None,
                     request_id: Optional[str] = None) -> dict:
        if self._closed:
            raise OverloadedError("server draining: dispatch closed")
        return await self._submit(functools.partial(
            self.batcher.delete, ids, deadline_ms=deadline_ms,
            t_enq=t_enq, request_id=request_id))

    # --- pending buckets ------------------------------------------------------

    def _enqueue(self, misses: list, k: int, exclude_self: bool,
                 nprobe_ov, keyf, life: _Lifecycle) -> asyncio.Future:
        loop = asyncio.get_running_loop()
        key = (k, exclude_self, nprobe_ov)
        g = self._groups.get(key)
        if g is None:
            g = _Group(keyf)
            self._groups[key] = g
            # the max-wait clock starts when the group becomes non-empty
            g.timer = loop.call_later(self.max_wait_s, self._flush, key)
        m = _Member(loop.create_future(), misses, life)
        g.members.append(m)
        g.pending.update(misses)
        n = len(g.pending)
        # an exactly full rung never waits (zero padding), nor does the
        # top bucket; a count that skips a rung waits for the next one
        # or the timer
        if n >= self.batcher.buckets[-1] or n == bucket_for(
                n, self.batcher.buckets):
            self._flush(key)
        return m.fut

    def _flush(self, key: tuple) -> None:
        """Form and dispatch one group's batch (timer or fill path)."""
        g = self._groups.pop(key, None)
        if g is None:
            return  # the other trigger flushed it already
        g.timer.cancel()
        self._flush_seq += 1
        flush_id = self._flush_seq
        alive: list[_Member] = []
        ids: list[int] = []
        seen: set = set()
        for m in g.members:
            m.life.flush_id = flush_id
            try:
                m.life.check_deadline("while queued in the collator")
            except DeadlineExceededError as e:
                if not m.fut.done():
                    m.fut.set_exception(e)
                continue
            m.life.formed()
            alive.append(m)
            for qid in m.misses:
                if qid not in seen:
                    seen.add(qid)
                    ids.append(qid)
        if not alive:
            return
        if self._closed:
            err = OverloadedError("server draining: dispatch closed")
            for m in alive:
                if not m.fut.done():
                    m.fut.set_exception(err)
            return
        telem.inc("serve/collator_flushes")
        k, exclude_self, nprobe_ov = key
        fspan = None
        if spans.enabled():
            fspan = spans.Span("flush", meta={
                "flush_id": flush_id, "members": len(alive),
                "ids": len(ids)})
            for m in alive:
                if m.life.span is not None:
                    m.life.span.adopt(fspan)
        fut = self._submit(functools.partial(
            self.batcher.dispatch_topk, ids, k, exclude_self=exclude_self,
            nprobe_ov=nprobe_ov, keyf=g.keyf,
            lives=[m.life for m in alive], span_parent=fspan))
        fut.add_done_callback(functools.partial(self._deliver, alive, fspan))

    @staticmethod
    def _deliver(members: list, fspan, fut) -> None:
        if fspan is not None:
            fspan.close()
        exc = None if fut.cancelled() else fut.exception()
        for m in members:
            if m.fut.done():
                continue
            if fut.cancelled():
                m.fut.cancel()
            elif exc is not None:
                m.fut.set_exception(exc)
            else:
                m.fut.set_result(fut.result())

    # --- drain ----------------------------------------------------------------

    def flush_all(self) -> None:
        """Flush every pending group now (drain)."""
        for key in list(self._groups):
            self._flush(key)

    def close(self, wait: bool = True) -> None:
        """Release the dispatch executor; idempotent.  The front door's
        drain passes ``wait=False`` after it has awaited every in-flight
        request: joining the thread from the event loop would block it."""
        if not self._closed:
            self._closed = True
            self._exec.shutdown(wait=wait)
