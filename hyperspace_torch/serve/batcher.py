"""Request micro-batcher: bucket padding, the per-query LRU result cache,
the request lifecycle, admission control and the degradation ladder
(counterpart of ``hyperspace_tpu/serve/batcher.py``).

- **Bucketing.**  Query batches are padded (by repeating the last id —
  always a valid row) up to the smallest power-of-two bucket from
  ``min_bucket`` to ``max_bucket``; bigger requests are split into
  ``max_bucket`` slabs, so the engine sees a handful of batch shapes and
  :meth:`RequestBatcher.prewarm` can launch every one before traffic.
  Padded slots are counted in ``serve/padded_waste`` beside
  ``serve/slots``.
- **Result cache.**  An LRU keyed by (artifact fingerprint, query id, k,
  exclude_self, precision, scan signature) holding per-query top-k
  rows; a request mixing hot and cold ids computes only the cold ones.
  The scan signature names the exact scan or the IVF probe with its
  width (the ladder's narrowed widths included) and index fingerprint,
  plus the fused marker and the PQ lane with its codebooks'
  fingerprint.  Edge scoring is uncached.
- **Lifecycle.**  Each request is stamped at enqueue (``t_enq=``
  backdates it to socket accept), batch-form, collator hand-off, result
  and completion, and observes ``serve/queue_wait_ms``,
  ``serve/dispatch_ms`` (engine call plus the device-to-host copy, so it
  times the device, not the launch) and ``serve/e2e_ms``; with spans on,
  the stages ``queue_wait``/``collate_wait``/``dispatch``/``serialize``
  (consecutive stamp differences that sum to e2e) and the engine's
  ``device_compute``.
- **Overload safety.**  ``queue_max=N`` arms a bounded admission counter
  (a request past N in flight sheds ``overloaded``), whose occupancy —
  or, with ``slo_ms`` and a window, the windowed p99 — drives a
  :class:`~hyperspace_torch.resilience.degrade.HysteresisLadder`: IVF
  ``nprobe`` halves toward 1, then cache-only answering.  ``deadline_ms``
  is checked after the cache pass, before each slab dispatch and at
  completion.  Off by default: ``queue_max=0`` builds none of it.
- **Counters** live in the process-wide telemetry registry under the
  JAX package's names (``serve/requests``, ``serve/cache_hit``,
  ``serve/slots``, ...), so ``stats()`` is process-cumulative: two
  batchers in one process share them; per-run numbers are
  ``Registry.mark()``/``snapshot(baseline=)`` deltas.

The pipeline stages (:meth:`~RequestBatcher.validate_topk_request`,
:meth:`~RequestBatcher.plan_topk`, :meth:`~RequestBatcher.cache_pass`,
:meth:`~RequestBatcher.dispatch_topk`) are shared with the asyncio
collator (``serve/collator.py``), which puts its own queueing between
the cache pass and the dispatch; ``dispatch_topk`` attributes one shared
dispatch to every member lifecycle and counts engine slots once.

- **Mutations** (``upsert``/``delete``) go to a live engine
  (``serve/delta.py``) inside the same admission, deadline and
  access-record envelope, observing ``serve/upsert_visible_ms`` (enqueue
  to the generation bump); a frozen engine answers ``validation``.
- **Tenants.**  ``tenant=`` (the multi-tenant registry,
  ``serve/registry.py``) double-writes the key series (requests, e2e,
  shed, deadline, errors) under a ``<name>@tenant=<t>`` twin that the
  exposition renders as a ``tenant`` label, and stamps access records
  with the tenant.
"""

from __future__ import annotations

import collections
import operator
import threading
import time
from typing import Optional, Sequence

import numpy as np

from hyperspace_torch.resilience import faults
from hyperspace_torch.serve.access import new_request_id
from hyperspace_torch.serve.engine import QueryEngine
from hyperspace_torch.serve.errors import (DeadlineExceededError,
                                           OverloadedError, ServeError,
                                           kind_of)
from hyperspace_torch.telemetry import registry as telem
from hyperspace_torch.telemetry import spans
from hyperspace_torch.telemetry.exposition import tenant_metric
from hyperspace_torch.telemetry.trace import span, tracing

DEFAULT_MIN_BUCKET = 8
DEFAULT_MAX_BUCKET = 1024
DEFAULT_CACHE_SIZE = 65536
_CACHE_ONLY = "cache_only"  # the ladder's terminal level
# the failures a request answers (``kind_of`` classifies them); a
# RuntimeError — a kernel that failed to build or launch — is ``internal``
_REQUEST_ERRORS = (ServeError, ValueError, KeyError, TypeError,
                   OverflowError, OSError, RuntimeError)


def bucket_sizes(min_bucket: int = DEFAULT_MIN_BUCKET,
                 max_bucket: int = DEFAULT_MAX_BUCKET) -> tuple:
    """The power-of-two bucket ladder, smallest to largest."""
    if min_bucket < 1 or max_bucket < min_bucket:
        raise ValueError(f"bad bucket range [{min_bucket}, {max_bucket}]")
    out, b = [], 1
    while b < min_bucket:
        b *= 2
    while b < max_bucket:
        out.append(b)
        b *= 2
    out.append(max_bucket)
    return tuple(out)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (larger requests are split into top-bucket
    slabs first)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _checked_ids(ids, name: str, num_nodes: int) -> list[int]:
    """Validate a request's id list on the host before any dtype cast:
    every id integral (a float like 1.9 fails, never truncates) and in
    [0, num_nodes) (a huge int never wraps through the int32 cast)."""
    if isinstance(ids, np.ndarray):
        ids = ids.reshape(-1).tolist()
    elif np.isscalar(ids):
        raise ValueError(f"{name} must be a list of ids")
    if not len(ids):
        raise ValueError(f"{name} must be a non-empty id list")
    out = []
    for i in ids:
        if isinstance(i, bool):  # bools index-coerce to 0/1 — reject
            raise ValueError(f"{name} must be integer ids; got bool")
        try:
            i = operator.index(i)
        except TypeError:
            raise ValueError(
                f"{name} must be integer ids; got "
                f"{type(i).__name__}") from None
        if not 0 <= i < num_nodes:
            raise ValueError(f"{name} id {i} out of range [0, {num_nodes})")
        out.append(i)
    return out


class _LRU:
    """Tiny lock-guarded LRU: cache key -> (idx row, dist row)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._d: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            try:
                self._d.move_to_end(key)
                return self._d[key]
            except KeyError:
                return None

    def put(self, key, value) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


class _Lifecycle:
    """One request's lifecycle stamps and its ``serve/*`` histograms.

    Construct at enqueue (``t_enq`` backdates it; the deadline counts
    from it), ``formed()`` once the batch exists, ``slab()`` +
    ``add_dispatch()`` per shared device dispatch (the device-to-host
    copy inside the timed window), ``finish()`` to observe.
    ``serve/dispatch_ms`` is observed only when a slab dispatched, so
    all-hit requests do not pull it toward zero.  ``info`` is the host
    trace span's ``args`` (None when tracing is off)."""

    __slots__ = ("t_enq", "t_form", "info", "buckets_used",
                 "dispatch_s", "t_deadline", "op", "request_id",
                 "flush_id", "cache_hits", "cache_misses", "t_done",
                 "t_coll", "t_result", "span", "tenant")

    def __init__(self, op: str, deadline_ms: Optional[float] = None,
                 t_enq: Optional[float] = None,
                 request_id: Optional[str] = None,
                 tenant: Optional[str] = None):
        self.t_enq = time.perf_counter() if t_enq is None else t_enq
        self.tenant = tenant   # drives the tenant twins and the record
        self.t_form = self.t_enq
        self.op = op
        self.request_id = request_id
        self.flush_id: Optional[int] = None
        self.cache_hits = 0
        self.cache_misses = 0
        self.t_done: Optional[float] = None
        self.info: Optional[dict] = {"op": op} if tracing() else None
        if self.info is not None and request_id is not None:
            self.info["request_id"] = request_id
        self.buckets_used: list = []
        self.dispatch_s = 0.0
        # stage boundaries: t_coll is the collator hand-off (None on the
        # sync path: collate_wait is then zero), t_result the results'
        # arrival (serialize is the remainder)
        self.t_coll: Optional[float] = None
        self.t_result: Optional[float] = None
        # the request's span tree (None when spans are off); the front
        # door's request envelope, if any, adopts it
        self.span = spans.root(op, request_id)
        if self.span is not None:
            self.span.t0 = self.t_enq
        self.t_deadline = (self.t_enq + deadline_ms / 1e3
                           if deadline_ms else None)

    def formed(self) -> None:
        self.t_form = time.perf_counter()

    def collated(self) -> None:
        """Stamp the collator hand-off: validation and cache pass done,
        the request now waits for its flush group."""
        self.t_coll = time.perf_counter()

    def result_ready(self) -> None:
        self.t_result = time.perf_counter()

    def check_deadline(self, where: str) -> None:
        """Raise ``deadline_exceeded`` once the request's budget is
        spent (after the cache pass, before each slab dispatch, at
        completion)."""
        if (self.t_deadline is not None
                and time.perf_counter() > self.t_deadline):
            telem.inc("serve/deadline_exceeded")
            if self.tenant:
                telem.inc(tenant_metric("serve/deadline_exceeded",
                                        self.tenant))
            raise DeadlineExceededError(
                f"deadline_ms expired {where} "
                f"({(time.perf_counter() - self.t_enq) * 1e3:.1f} ms "
                "elapsed)")

    def slab(self, bucket: int) -> None:
        self.buckets_used.append(bucket)

    def add_dispatch(self, seconds: float) -> None:
        self.dispatch_s += seconds

    def finish(self) -> None:
        if self.info is not None:
            self.info["buckets"] = self.buckets_used
        self.t_done = time.perf_counter()
        telem.observe("serve/queue_wait_ms", (self.t_form - self.t_enq) * 1e3)
        if self.buckets_used:
            telem.observe("serve/dispatch_ms", self.dispatch_s * 1e3)
        telem.observe("serve/e2e_ms", (self.t_done - self.t_enq) * 1e3)
        if self.tenant:
            telem.observe(tenant_metric("serve/e2e_ms", self.tenant),
                          (self.t_done - self.t_enq) * 1e3)
        if self.span is not None:
            st = self.stages_ms()
            telem.observe("serve/stage/queue_wait_ms", st["queue_wait"])
            telem.observe("serve/stage/collate_wait_ms", st["collate_wait"])
            telem.observe("serve/stage/dispatch_ms", st["dispatch"])
            telem.observe("serve/stage/serialize_ms", st["serialize"])
            t_coll = self.t_coll if self.t_coll is not None else self.t_form
            t_res = (self.t_result if self.t_result is not None
                     else self.t_done)
            self.span.add("queue_wait", self.t_enq, t_coll)
            self.span.add("collate_wait", t_coll, self.t_form)
            self.span.add("dispatch", self.t_form, t_res)
            self.span.add("serialize", t_res, self.t_done)
            self.span.t1 = self.t_done

    def stages_ms(self) -> dict:
        """The per-stage decomposition in ms: consecutive stamp
        differences that sum to ``e2e_ms``."""
        end = self.t_done if self.t_done is not None else time.perf_counter()
        t_coll = self.t_coll if self.t_coll is not None else self.t_form
        t_res = self.t_result if self.t_result is not None else end
        return {
            "queue_wait": round((t_coll - self.t_enq) * 1e3, 3),
            "collate_wait": round((self.t_form - t_coll) * 1e3, 3),
            "dispatch": round((t_res - self.t_form) * 1e3, 3),
            "serialize": round((end - t_res) * 1e3, 3),
        }

    def access_record(self, outcome: str, degrade_level: int) -> dict:
        """One access-log line's payload (JAX's record shape; ``tenant``
        is None on a single-tenant batcher).  A failed request still
        carries its elapsed time and flush id."""
        end = self.t_done if self.t_done is not None else time.perf_counter()
        return {
            "request_id": self.request_id,
            "route": self.op,
            "tenant": self.tenant,
            "outcome": outcome,
            "bucket": list(self.buckets_used),
            "flush_id": self.flush_id,
            "queue_wait_ms": round((self.t_form - self.t_enq) * 1e3, 3),
            "dispatch_ms": round(self.dispatch_s * 1e3, 3),
            "e2e_ms": round((end - self.t_enq) * 1e3, 3),
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "degrade_level": degrade_level,
            "stages": self.stages_ms(),
        }


class _Admission:
    """Bounded in-flight counter.  ``try_admit`` returns the share of the
    bound OTHER callers hold, ``(inflight − 1) / queue_max``, or None
    when full (the caller sheds).  A lone caller exerts zero pressure,
    so the blocking stdin loop never walks the ladder down."""

    def __init__(self, queue_max: int):
        self.queue_max = int(queue_max)
        self.inflight = 0
        self._lock = threading.Lock()

    def try_admit(self) -> Optional[float]:
        with self._lock:
            if self.inflight >= self.queue_max:
                return None
            self.inflight += 1
            return (self.inflight - 1) / self.queue_max

    def release(self) -> None:
        with self._lock:
            self.inflight -= 1


def _ladder_modes(engine: QueryEngine) -> list:
    """Quality modes best-first: full (None), IVF probe widths halving
    toward 1, then cache-only."""
    modes: list = [None]
    if engine.scan_strategy == "ivf":
        p = engine.nprobe // 2
        while p >= 1:
            modes.append(p)
            p //= 2
    modes.append(_CACHE_ONLY)
    return modes


def _to_host(x) -> np.ndarray:
    """A result tensor as a host array: the blocking device-to-host copy
    that ends a dispatch."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


class RequestBatcher:
    """Pads requests onto the bucket ladder and fronts the LRU cache.

    ``queue_max=N`` arms overload safety (module docstring): admission,
    the ladder (``ladder_high``/``ladder_low``/``ladder_down_after``/
    ``ladder_up_after``) and deadlines (``deadline_ms`` is the default a
    request without its own gets).  ``window`` (a
    :class:`~hyperspace_torch.telemetry.window.SloWindow`) and
    ``slo_ms`` feed ``stats()`` and the ladder's latency signal;
    ``access_sink``, ``recorder`` and ``slow_sink`` take access records,
    degrade transitions and SLO breaches.  ``tenant`` names the
    registry tenant this batcher serves (module docstring)."""

    def __init__(self, engine: QueryEngine, *,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 max_bucket: int = DEFAULT_MAX_BUCKET,
                 cache_size: int = DEFAULT_CACHE_SIZE,
                 queue_max: int = 0,
                 deadline_ms: float = 0.0,
                 ladder_high: float = 0.75, ladder_low: float = 0.25,
                 ladder_down_after: int = 1, ladder_up_after: int = 8,
                 window=None, slo_ms: float = 0.0,
                 access_sink=None, recorder=None, slow_sink=None,
                 tenant: Optional[str] = None):
        self.engine = engine
        self.tenant = tenant
        self.buckets = bucket_sizes(min_bucket, max_bucket)
        self.cache = _LRU(cache_size)
        if queue_max < 0:
            raise ValueError(f"queue_max must be >= 0; got {queue_max}")
        if deadline_ms < 0:
            raise ValueError(
                f"deadline_ms must be >= 0; got {deadline_ms}")
        if slo_ms < 0:
            raise ValueError(f"slo_ms must be >= 0; got {slo_ms}")
        self.default_deadline_ms = float(deadline_ms) or None
        self.window = window
        self.slo_ms = float(slo_ms)
        self.access_sink = access_sink
        self.recorder = recorder
        self.slow_sink = slow_sink
        self._admission = None
        self._ladder = None
        self._modes: list = [None]
        # (bucket, k, exclude_self, probe width) already launched here
        self._launched: set = set()
        if queue_max > 0:
            from hyperspace_torch.resilience.degrade import HysteresisLadder

            self._admission = _Admission(queue_max)
            self._modes = _ladder_modes(engine)
            self._ladder = HysteresisLadder(
                len(self._modes), high=ladder_high, low=ladder_low,
                down_after=ladder_down_after, up_after=ladder_up_after,
                on_change=self._on_ladder_change)

    def _on_ladder_change(self, old: int, new: int) -> None:
        telem.inc("serve/degraded" if new > old else "serve/degrade_recovered")
        telem.set_gauge("serve/degrade_level", new)
        if self.recorder is not None:
            self.recorder.note_degrade(old, new)

    def _admit(self) -> None:
        """Shed with ``overloaded`` when the bounded queue is full; feed
        the ladder the post-admit occupancy, or the latency pressure
        when that is the worse signal."""
        if self._admission is None:
            return
        occ = self._admission.try_admit()
        if occ is None:
            # serve/shed ticks in emit_access (every overloaded answer)
            self._ladder.observe(1.0)
            raise OverloadedError(
                "admission queue full "
                f"(queue_max={self._admission.queue_max})")
        if self.window is not None and self.slo_ms > 0:
            occ = max(occ, self.window.latency_pressure(self.slo_ms))
        self._ladder.observe(occ)

    def _release(self) -> None:
        if self._admission is not None:
            self._admission.release()

    def count_request(self) -> None:
        """Bump ``serve/requests`` (and its tenant twin) — the one place
        a request is counted (shared with the collator)."""
        telem.inc("serve/requests")
        if self.tenant:
            telem.inc(tenant_metric("serve/requests", self.tenant))

    def new_lifecycle(self, op: str, deadline_ms: Optional[float] = None,
                      t_enq: Optional[float] = None,
                      request_id: Optional[str] = None) -> _Lifecycle:
        return _Lifecycle(op, deadline_ms, t_enq=t_enq,
                          request_id=request_id, tenant=self.tenant)

    def _begin(self, op: str, deadline_ms, t_enq, request_id) -> _Lifecycle:
        """Start a request: its lifecycle (the batcher's default
        deadline, a generated id when a sink needs one), counted and
        admitted — a shed is access-logged and re-raised."""
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        if request_id is None and self.access_sink is not None:
            request_id = new_request_id()
        life = self.new_lifecycle(op, deadline_ms, t_enq=t_enq,
                                  request_id=request_id)
        self.count_request()
        try:
            self._admit()
        except OverloadedError:
            self.emit_access(life, "overloaded")
            raise
        return life

    def emit_access(self, life: _Lifecycle, outcome: str = "ok") -> None:
        """One request is done (any outcome): tick the SLO window, count
        ``serve/shed`` (every overloaded answer) or ``serve/errors``
        (parse/validation/internal), check the SLO, and hand the record
        to the armed sinks."""
        if self.window is not None:
            self.window.tick()
        if outcome == "overloaded":
            telem.inc("serve/shed")
            if self.tenant:
                telem.inc(tenant_metric("serve/shed", self.tenant))
        elif outcome not in ("ok", "deadline_exceeded"):
            telem.inc("serve/errors")
            if self.tenant:
                telem.inc(tenant_metric("serve/errors", self.tenant))
        if life.span is not None:
            life.span.close()
        breach = False
        if self.slo_ms > 0:
            end = (life.t_done if life.t_done is not None
                   else time.perf_counter())
            breach = (end - life.t_enq) * 1e3 > self.slo_ms
            if breach:
                telem.inc("serve/slow_queries")
        if self.access_sink is None and self.slow_sink is None:
            return
        rec = life.access_record(outcome, self.degrade_level)
        if life.span is not None and (outcome != "ok" or breach):
            rec["span"] = life.span.to_dict()
        for sink in (self.access_sink, self.slow_sink if breach else None):
            if sink is not None:
                try:
                    sink(rec)
                except OSError:
                    pass  # a full disk loses evidence, never a request

    def emit_synthetic_access(self, op: str, *,
                              request_id: Optional[str] = None,
                              outcome: str = "ok",
                              t_enq: Optional[float] = None) -> None:
        """Account a request that failed before reaching the batcher
        (HTTP framing, body parse, unknown route or op)."""
        if request_id is None and self.access_sink is not None:
            request_id = new_request_id()
        self.emit_access(self.new_lifecycle(op, t_enq=t_enq,
                                            request_id=request_id),
                         outcome)

    def _mode(self):
        """Current quality mode: None (full), an int nprobe override, or
        ``"cache_only"``."""
        if self._ladder is None:
            return None
        return self._modes[self._ladder.level]

    @property
    def degrade_level(self) -> int:
        """The ladder's level (0 = full quality, also with no ladder)."""
        return self._ladder.level if self._ladder is not None else 0

    def _narrowed(self, mode, k: int) -> Optional[int]:
        """A ladder width clamped so the probe still holds k rows
        (capacity = p × max_cell); None when it clamps back to full."""
        mc = self.engine.index.max_cell
        p = min(max(mode, -(-k // mc)), self.engine.nprobe)
        return None if p >= self.engine.nprobe else p

    # --- startup prewarm ------------------------------------------------------

    def prewarm(self, ks: Sequence[int], *, buckets=None,
                exclude_self=(True, False)) -> dict:
        """Launch every (bucket, k, exclude_self, ladder width) through
        the engine before traffic: the first call builds each kernel of
        the engine's lane (``nvcc``, seconds) and the caching allocator
        takes each bucket's blocks on the calling thread's stream, so
        call this on the thread that dispatches traffic (the collator's
        executor).  Each launch ends in the device-to-host copy.

        Dispatches go straight to the engine: no LRU writes, request
        counters or latency histograms (only ``serve/prewarmed`` and
        ``serve/prewarm_s``).  Each launch marks its shape, so traffic
        at it counts no ``serve/cold_dispatches``.  A narrowed probe
        that under-fills still launched its kernels, so its
        ``ValueError`` is swallowed.  Returns ``{programs, seconds,
        buckets, ks}``."""
        eng = self.engine
        ks = sorted({int(k) for k in ks})
        limit = eng.num_nodes - (1 if any(exclude_self) else 0)
        for k in ks:
            if not 1 <= k <= limit:
                raise ValueError(
                    f"prewarm k={k} out of range [1, {limit}] for a "
                    f"{eng.num_nodes}-row table")
        widths = [None] + sorted({m for m in self._modes
                                  if isinstance(m, int)}, reverse=True)
        buckets = tuple(buckets or self.buckets)
        t0 = time.perf_counter()
        warmed = 0
        for b in buckets:
            q = np.arange(b, dtype=np.int64) % eng.num_nodes
            for k in ks:
                for ex in exclude_self:
                    seen_p = set()
                    for p in widths:
                        if p is not None:
                            p = self._narrowed(p, k)
                            if p is None or p in seen_p:
                                continue
                            seen_p.add(p)
                        self._launched.add((b, k, bool(ex), p))
                        try:
                            out = eng.topk_neighbors(
                                q, k, exclude_self=bool(ex), nprobe=p)
                            for x in out:
                                _to_host(x)
                        except ValueError:
                            pass  # under-filled narrowed probe
                        warmed += 1
        dt = time.perf_counter() - t0
        telem.inc("serve/prewarmed", warmed)
        telem.inc("serve/prewarm_s", dt)
        return {"programs": warmed, "seconds": dt,
                "buckets": list(buckets), "ks": ks}

    # --- pipeline stages ------------------------------------------------------

    def validate_topk_request(self, ids, k) -> tuple[list[int], int]:
        """Host-side validation of the id list and k (reject, don't
        coerce)."""
        ids = _checked_ids(ids, "ids", self.engine.num_nodes)
        if isinstance(k, bool):  # True would index-coerce to k=1
            raise ValueError("k must be an integer; got bool")
        try:
            k = operator.index(k)
        except TypeError:
            raise ValueError(
                f"k must be an integer; got {type(k).__name__}") from None
        return ids, k

    def plan_topk(self, k: int, exclude_self: bool):
        """``(keyf, nprobe_ov, cache_only)``: the ladder's mode resolved
        into an nprobe override (None = full width), the cache key
        function for this (k, exclude_self) under it, and whether only
        the cache answers."""
        mode = self._mode()
        nprobe_ov = self._narrowed(mode, k) if isinstance(mode, int) else None
        eng = self.engine
        fp, prec = eng.fingerprint, eng.precision
        scan = (eng.scan_signature_for(nprobe_ov) if nprobe_ov is not None
                else eng.scan_signature)
        keyf = lambda qid: (fp, qid, k, exclude_self, prec, scan)  # noqa: E731
        return keyf, nprobe_ov, mode == _CACHE_ONLY

    def cache_pass(self, ids: Sequence[int], keyf,
                   cache_only: bool) -> tuple[dict, list[int]]:
        """``(rows, misses)`` over the request's unique ids; under
        cache-only a cold id sheds the request (not a miss: nothing was
        computed)."""
        rows: dict[int, tuple] = {}
        misses: list[int] = []
        for qid in dict.fromkeys(ids):
            hit = self.cache.get(keyf(qid))
            if hit is not None:
                rows[qid] = hit
            else:
                misses.append(qid)
        telem.inc("serve/cache_hit", len(rows))
        if cache_only and misses:
            raise OverloadedError(
                f"cache-only degradation: {len(misses)} cold "
                "id(s) in the request")
        telem.inc("serve/cache_miss", len(misses))
        return rows, misses

    def dispatch_topk(self, misses: Sequence[int], k: int, *,
                      exclude_self: bool, nprobe_ov, keyf,
                      lives: Sequence[_Lifecycle],
                      deadline_life: Optional[_Lifecycle] = None,
                      span_parent=None) -> dict:
        """Dispatch ``misses`` in bucket-padded slabs; returns ``{qid:
        (idx row, dist row)}`` (rows also land in the LRU).  Each slab's
        wall time — the ``serve.dispatch`` fault site excluded, the
        engine call and the device-to-host copy included — is attributed
        to every lifecycle in ``lives``; ``serve/slots`` counts the slab
        once.  A slab at a (bucket, k, exclude_self, probe width) this
        batcher never launched counts one ``serve/cold_dispatches``: the
        first launch at a shape, which :meth:`prewarm` exists to take.  ``deadline_life`` (the sync path's own request) is
        checked before each slab; ``span_parent`` scopes the engine's
        ``device_compute`` stage (the collator passes its flush span:
        contextvars do not cross its executor on their own)."""
        rows: dict[int, tuple] = {}
        top = self.buckets[-1]
        with spans.use(span_parent):
            for s in range(0, len(misses), top):
                if deadline_life is not None:
                    deadline_life.check_deadline("before dispatch")
                slab = list(misses[s:s + top])
                b = bucket_for(len(slab), self.buckets)
                telem.inc("serve/slots", b)
                telem.inc("serve/padded_waste", b - len(slab))
                for life in lives:
                    life.slab(b)
                padded = slab + [slab[-1]] * (b - len(slab))
                shape = (b, k, bool(exclude_self), nprobe_ov)
                if shape not in self._launched:
                    self._launched.add(shape)
                    telem.inc("serve/cold_dispatches")
                if faults.active():
                    faults.hit("serve.dispatch")
                t0 = time.perf_counter()
                try:
                    idx, dist = self.engine.topk_neighbors(
                        np.asarray(padded, np.int32), k,
                        exclude_self=exclude_self, nprobe=nprobe_ov)
                except ValueError as e:
                    if nprobe_ov is not None and "under-filled" in str(e):
                        # the server narrowed the probe, not the client
                        raise OverloadedError(
                            f"degraded probe width {nprobe_ov} "
                            f"under-filled for k={k}; retry later") from e
                    raise
                idx, dist = _to_host(idx), _to_host(dist)
                dt = time.perf_counter() - t0
                for life in lives:
                    life.add_dispatch(dt)
                for j, qid in enumerate(slab):
                    val = (idx[j].copy(), dist[j].copy())
                    rows[qid] = val
                    self.cache.put(keyf(qid), val)
        self._update_gauges()
        return rows

    # --- top-k ----------------------------------------------------------------

    def topk(self, ids, k: int, *, exclude_self: bool = True,
             deadline_ms: Optional[float] = None,
             t_enq: Optional[float] = None,
             request_id: Optional[str] = None
             ) -> tuple[np.ndarray, np.ndarray]:
        """``(neighbors [B, k] int32, dists [B, k])`` in request order;
        cache-aware, bucket-padded.  ``deadline_ms`` overrides the
        default; ``t_enq`` backdates the enqueue stamp; ``request_id``
        rides the span args and the access record."""
        life = self._begin("topk", deadline_ms, t_enq, request_id)
        try:
            with span("query", args=life.info):
                ids, k = self.validate_topk_request(ids, k)
                keyf, nprobe_ov, cache_only = self.plan_topk(
                    k, exclude_self)
                rows, misses = self.cache_pass(ids, keyf, cache_only)
                life.cache_hits = len(rows)
                life.cache_misses = len(misses)
                life.formed()
                life.check_deadline("after the cache pass")
                if life.info is not None:
                    life.info.update(requests=len(ids), k=k,
                                     cache_hits=len(rows),
                                     cache_misses=len(misses))
                rows.update(self.dispatch_topk(
                    misses, k, exclude_self=exclude_self,
                    nprobe_ov=nprobe_ov, keyf=keyf, lives=(life,),
                    deadline_life=life, span_parent=life.span))
                life.result_ready()
                out_i = np.stack([rows[qid][0] for qid in ids])
                out_d = np.stack([rows[qid][1] for qid in ids])
                # a result computed past the deadline is answered
                # deadline_exceeded (its rows stay cached)
                life.check_deadline("at completion")
                life.finish()
                self.emit_access(life)
                return out_i, out_d
        except _REQUEST_ERRORS as e:
            self.emit_access(life, kind_of(e))
            raise
        finally:
            self._release()

    # --- edge scores ----------------------------------------------------------

    def validate_score_request(self, u_ids,
                               v_ids) -> tuple[np.ndarray, np.ndarray]:
        """Host-side score validation: matching int id arrays."""
        n = self.engine.num_nodes
        u = np.asarray(_checked_ids(u_ids, "u", n), np.int64)
        v = np.asarray(_checked_ids(v_ids, "v", n), np.int64)
        if u.shape != v.shape:
            raise ValueError(f"score: need matching id lists; got "
                             f"{u.shape} vs {v.shape}")
        return u, v

    def dispatch_score(self, u: np.ndarray, v: np.ndarray, *,
                       prob: bool, fd_r: float, fd_t: float,
                       lives: Sequence[_Lifecycle],
                       deadline_life: Optional[_Lifecycle] = None,
                       span_parent=None) -> np.ndarray:
        """Slab-dispatch validated edge pairs (the score analogue of
        :meth:`dispatch_topk`)."""
        out = np.empty((u.size,), np.float64)
        top = self.buckets[-1]
        with spans.use(span_parent):
            for s in range(0, u.size, top):
                if deadline_life is not None:
                    deadline_life.check_deadline("before dispatch")
                su, sv = u[s:s + top], v[s:s + top]
                b = bucket_for(su.size, self.buckets)
                telem.inc("serve/slots", b)
                telem.inc("serve/padded_waste", b - su.size)
                for life in lives:
                    life.slab(b)
                pu = np.concatenate([su, np.full(b - su.size, su[-1])])
                pv = np.concatenate([sv, np.full(b - sv.size, sv[-1])])
                if faults.active():
                    faults.hit("serve.dispatch")
                t0 = time.perf_counter()
                d = self.engine.score_edges(pu.astype(np.int32),
                                            pv.astype(np.int32), prob=prob,
                                            fd_r=fd_r, fd_t=fd_t)
                out[s:s + su.size] = _to_host(d)[:su.size]
                dt = time.perf_counter() - t0
                for life in lives:
                    life.add_dispatch(dt)
        self._update_gauges()
        return out

    def score(self, u_ids, v_ids, *, prob: bool = False,
              fd_r: float = 2.0, fd_t: float = 1.0,
              deadline_ms: Optional[float] = None,
              t_enq: Optional[float] = None,
              request_id: Optional[str] = None) -> np.ndarray:
        """Bucket-padded ``engine.score_edges`` ([B] in request order);
        :meth:`topk`'s admission and deadline contract.  Edge scoring is
        uncached, so cache-only degradation sheds every score."""
        life = self._begin("score", deadline_ms, t_enq, request_id)
        try:
            with span("query", args=life.info):
                if self._mode() == _CACHE_ONLY:
                    raise OverloadedError(
                        "cache-only degradation: edge scoring is uncached")
                u, v = self.validate_score_request(u_ids, v_ids)
                life.formed()
                life.check_deadline("after validation")
                if life.info is not None:
                    life.info["requests"] = int(u.size)
                out = self.dispatch_score(u, v, prob=prob, fd_r=fd_r,
                                          fd_t=fd_t, lives=(life,),
                                          deadline_life=life,
                                          span_parent=life.span)
                life.result_ready()
                life.check_deadline("at completion")
                life.finish()
                self.emit_access(life)
                return out
        except _REQUEST_ERRORS as e:
            self.emit_access(life, kind_of(e))
            raise
        finally:
            self._release()

    # --- mutations ------------------------------------------------------------

    def _live_engine(self):
        """The engine, when it takes mutations (``serve/delta.py``); a
        frozen engine answers ``validation`` and says how to get one."""
        if not hasattr(self.engine, "upsert"):
            raise ValueError(
                "engine is frozen: mutations need a live engine "
                "(serve with live=true, or wrap the base in "
                "serve.delta.LiveQueryEngine)")
        return self.engine

    def _mutate(self, op: str, apply, *, deadline_ms: Optional[float],
                t_enq: Optional[float],
                request_id: Optional[str]) -> dict:
        """The mutation envelope: :meth:`topk`'s admission, deadline and
        access-record contract around ``apply(engine)``.  A success
        observes ``serve/upsert_visible_ms`` (enqueue to the generation
        bump).  A mutation past its deadline stays applied (the
        generation moved) and answers ``deadline_exceeded``."""
        life = self._begin(op, deadline_ms, t_enq, request_id)
        try:
            with span("query", args=life.info):
                eng = self._live_engine()
                life.formed()
                life.check_deadline("before the mutation")
                out = apply(eng)
                life.result_ready()
                telem.observe("serve/upsert_visible_ms",
                              (time.perf_counter() - life.t_enq) * 1e3)
                life.check_deadline("at completion")
                life.finish()
                self.emit_access(life)
                return out
        except _REQUEST_ERRORS as e:
            self.emit_access(life, kind_of(e))
            raise
        finally:
            self._release()

    def upsert(self, ids, rows, *, deadline_ms: Optional[float] = None,
               t_enq: Optional[float] = None,
               request_id: Optional[str] = None) -> dict:
        """Insert or update rows through the live engine's delta segment
        (``{"upserted", "inserted", "generation", "segment_rows"}``)."""
        return self._mutate(
            "upsert", lambda eng: eng.upsert(ids, rows),
            deadline_ms=deadline_ms, t_enq=t_enq, request_id=request_id)

    def delete(self, ids, *, deadline_ms: Optional[float] = None,
               t_enq: Optional[float] = None,
               request_id: Optional[str] = None) -> dict:
        """Tombstone rows (``{"deleted", "generation"}``)."""
        return self._mutate(
            "delete", lambda eng: eng.delete(ids),
            deadline_ms=deadline_ms, t_enq=t_enq, request_id=request_id)

    # --- introspection --------------------------------------------------------

    def _update_gauges(self) -> None:
        """Refresh the ratio gauges from the cumulative counters."""
        reg = telem.default_registry()
        slots = reg.get("serve/slots")
        if slots:
            telem.set_gauge("serve/padded_waste_ratio",
                            round(reg.get("serve/padded_waste") / slots, 4))
        lookups = reg.get("serve/cache_hit") + reg.get("serve/cache_miss")
        if lookups:
            telem.set_gauge("serve/cache_hit_rate",
                            round(reg.get("serve/cache_hit") / lookups, 4))

    def stats(self) -> dict:
        """The serve counters (process-cumulative), ratio gauges, cache
        occupancy and the engine's identity — JAX's keys, with
        ``kernel_builds`` (``kernels/builds``: flat once prewarmed) in
        place of ``recompiles``, and beside it ``kernel_loads``
        (``kernels/loads``) and ``cold_dispatches``
        (``serve/cold_dispatches``), both flat once prewarmed too."""
        reg = telem.default_registry()
        gauges = reg.snapshot()
        mode = self._mode()
        return {
            "tenant": self.tenant,
            "latency_e2e_ms": gauges.get("hist/serve/e2e_ms"),
            "kernel_builds": reg.get("kernels/builds"),
            "kernel_loads": reg.get("kernels/loads"),
            "cold_dispatches": reg.get("serve/cold_dispatches"),
            "prewarmed": reg.get("serve/prewarmed"),
            "requests": reg.get("serve/requests"),
            "cache_hit": reg.get("serve/cache_hit"),
            "cache_miss": reg.get("serve/cache_miss"),
            "cache_hit_rate": gauges.get("serve/cache_hit_rate", 0.0),
            "padded_waste": reg.get("serve/padded_waste"),
            "padded_waste_ratio": gauges.get("serve/padded_waste_ratio", 0.0),
            "slots": reg.get("serve/slots"),
            "cache_entries": len(self.cache),
            "buckets": list(self.buckets),
            "fingerprint": self.engine.fingerprint,
            "precision": self.engine.precision,
            "scan_strategy": self.engine.scan_strategy,
            "scan_mode": self.engine.scan_mode,
            "nprobe": self.engine.nprobe,
            # live engines only (serve/delta.py); None on a frozen one
            "generation": getattr(self.engine, "generation", None),
            "segment_rows": getattr(self.engine, "segment_rows", None),
            "queue_max": (self._admission.queue_max
                          if self._admission else 0),
            "shed": reg.get("serve/shed"),
            "deadline_exceeded": reg.get("serve/deadline_exceeded"),
            "errors": reg.get("serve/errors"),
            "degrade_level": self.degrade_level,
            "degrade_mode": "full" if mode is None else str(mode),
            "window": (self.window.report()
                       if self.window is not None else None),
        }
