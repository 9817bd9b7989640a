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
tree and scoped on the dispatch thread with ``spans.use``.

A multi-tenant front door (``serve/registry.py``) runs one collator per
tenant on one **shared** dispatch executor (``executor=``): device work
stays serialized across tenants.  :class:`FairDispatcher` interposes
per-tenant job queues drained by deficit round robin, so a hot tenant's
flushes cannot starve the others.
"""

from __future__ import annotations

import asyncio
import collections
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
from hyperspace_torch.telemetry.exposition import tenant_metric

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


class FairDispatcher:
    """Deficit round robin (Shreedhar & Varghese) over per-tenant job
    queues in front of the shared one-worker dispatch executor.

    Each visit to a tenant's non-empty queue adds ``weight × quantum``
    to its deficit; its head job dispatches once the deficit covers the
    job's cost (the flush's unique id count: the device work), paying
    the cost down.  A tenant whose queue empties forfeits its deficit,
    so an idle tenant banks no burst credit.  One job is in flight at a
    time (the executor has one worker; a second would reorder inside the
    pool and bypass the policy); its completion re-pumps on the event
    loop.  Every structure is touched on the event loop only."""

    def __init__(self, executor: ThreadPoolExecutor, *,
                 weights: Optional[dict] = None, quantum: int = 8):
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1; got {quantum}")
        self._exec = executor
        self._weights = dict(weights or {})
        self._quantum = int(quantum)
        self._queues: dict = {}    # tenant -> deque[(cost, fn, fut)]
        self._deficit: dict = {}   # tenant -> accumulated credit
        self._rr: collections.deque = collections.deque()  # visit order
        self._busy = False

    def weight(self, tenant) -> float:
        """The tenant's share (default 1.0; floored above 0, so a zero
        weight throttles hard instead of halting)."""
        return max(float(self._weights.get(tenant, 1.0)), 1e-6)

    def set_weight(self, tenant, weight: float) -> None:
        self._weights[tenant] = float(weight)

    def submit(self, loop: asyncio.AbstractEventLoop, tenant,
               cost: int, fn) -> asyncio.Future:
        """Enqueue ``fn`` for ``tenant`` at ``cost`` work units; a future
        of ``fn()``'s result (``run_in_executor``'s shape)."""
        fut = loop.create_future()
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = collections.deque()
            self._deficit.setdefault(tenant, 0.0)
            self._rr.append(tenant)
        q.append((max(1, int(cost)), fn, fut))
        self._pump(loop)
        return fut

    def _pump(self, loop) -> None:
        if self._busy:
            return
        # deficits grow on every visit to a non-empty queue, so the scan
        # ends at the first affordable head job or when all queues drain
        while self._rr:
            tenant = self._rr[0]
            q = self._queues.get(tenant)
            while q and q[0][2].done():
                q.popleft()  # the caller gave up while queued: never run
            if not q:
                self._rr.popleft()
                self._queues.pop(tenant, None)
                self._deficit[tenant] = 0.0
                continue
            self._deficit[tenant] += self.weight(tenant) * self._quantum
            cost, fn, fut = q[0]
            if self._deficit[tenant] < cost:
                self._rr.rotate(-1)
                continue
            q.popleft()
            self._deficit[tenant] -= cost
            self._rr.rotate(-1)
            self._busy = True
            telem.inc("serve/fair_dispatches")
            if tenant:
                telem.inc(tenant_metric("serve/fair_dispatches", tenant))
            efut = loop.run_in_executor(self._exec, fn)
            efut.add_done_callback(
                functools.partial(self._done, loop, fut))
            return

    def _done(self, loop, fut: asyncio.Future, efut) -> None:
        self._busy = False
        if not fut.done():
            if efut.cancelled():
                fut.cancel()
            elif efut.exception() is not None:
                fut.set_exception(efut.exception())
            else:
                fut.set_result(efut.result())
        self._pump(loop)

    def pending(self) -> dict:
        """{tenant: queued jobs}."""
        return {t: len(q) for t, q in self._queues.items() if q}


class Collator:
    """Continuous batching over a :class:`RequestBatcher` (module
    docstring).  One collator serves one batcher; construct and use it
    on one event loop.  ``executor=`` shares a dispatch executor owned
    by someone else (the registry's; ``close()`` then leaves it
    running), ``dispatcher=`` routes this collator's submissions through
    a :class:`FairDispatcher` under its ``tenant``."""

    def __init__(self, batcher: RequestBatcher, *,
                 max_wait_us: float = DEFAULT_MAX_WAIT_US,
                 executor: Optional[ThreadPoolExecutor] = None,
                 dispatcher: Optional[FairDispatcher] = None,
                 tenant: Optional[str] = None):
        if max_wait_us < 0:
            raise ValueError(
                f"max_wait_us must be >= 0; got {max_wait_us}")
        self.batcher = batcher
        self.tenant = tenant if tenant is not None else batcher.tenant
        self.max_wait_s = float(max_wait_us) / 1e6
        self._groups: dict[tuple, _Group] = {}
        self._owns_exec = executor is None
        self._exec = executor if executor is not None else (
            ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix="serve-dispatch"))
        self._dispatcher = dispatcher
        self._closed = False
        # monotone flush id, stamped on every member a flush examines
        # (expired ones included: a 504 names the flush that missed it)
        self._flush_seq = 0

    def _submit(self, cost: int, fn) -> asyncio.Future:
        """One dispatch submission: through the fair dispatcher under
        this collator's tenant when armed, else straight to the
        executor."""
        loop = asyncio.get_running_loop()
        if self._dispatcher is not None:
            return self._dispatcher.submit(loop, self.tenant, cost, fn)
        return loop.run_in_executor(self._exec, fn)

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
            out = await self._submit(len(u), functools.partial(
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
        """The batcher's ``upsert`` on the dispatch executor: mutations
        are serialized with the topk and score work, so a flush never
        scans a half-applied generation."""
        if self._closed:
            raise OverloadedError("server draining: dispatch closed")
        return await self._submit(_cost(ids), functools.partial(
            self.batcher.upsert, ids, rows, deadline_ms=deadline_ms,
            t_enq=t_enq, request_id=request_id))

    async def delete(self, ids, *,
                     deadline_ms: Optional[float] = None,
                     t_enq: Optional[float] = None,
                     request_id: Optional[str] = None) -> dict:
        """The batcher's ``delete``, serialized the same way."""
        if self._closed:
            raise OverloadedError("server draining: dispatch closed")
        return await self._submit(_cost(ids), functools.partial(
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
        fut = self._submit(len(ids), functools.partial(
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
        request: joining the thread from the event loop would block it.
        A shared executor is its owner's to shut down."""
        if not self._closed:
            self._closed = True
            if self._owns_exec:
                self._exec.shutdown(wait=wait)


def _cost(ids) -> int:
    """A mutation's fair-dispatch cost: its id count (1 for a malformed
    list, which the batcher rejects)."""
    try:
        return len(ids)
    except TypeError:
        return 1
