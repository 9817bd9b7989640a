"""Host-level trace spans (counterpart of
``hyperspace_tpu/telemetry/trace.py``): ``with span("query"): ...``.

- Disabled (the default), the module-level :func:`span` returns a shared
  ``nullcontext`` without allocating, so call sites stay instrumented;
- enabled, spans aggregate per name (``Tracer.flush_fields()`` →
  ``{"span/<name>_s": seconds}``) and, with ``keep_events``, every
  event is kept for a Chrome/Perfetto ``trace_events`` dump
  (:meth:`Tracer.dump_chrome_trace`, ``trace_out=`` on the serve CLI).

Spans nest per thread: the asyncio front door uses :mod:`~.spans`
instead.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Optional

# one reusable, stateless disabled-path context manager: entering it is
# a couple of attribute lookups and no allocation
_NULL = contextlib.nullcontext()

# retention cap for the Chrome dump event list — a runaway span loop
# must not eat the host; ~1e6 events ≈ 100 MB JSON, far beyond any
# useful trace.  A ring (deque maxlen): the OLDEST events are evicted,
# because the dump's crash-diagnosis job needs the timeline's TAIL —
# what happened just before the failure (drop count kept for honesty).
_MAX_EVENTS = 1_000_000


class _Span:
    """The enabled-path context manager (one fresh object per span —
    spans nest and cross threads, so no singleton here).

    ``args`` is an optional metadata dict carried into the Chrome-trace
    event (batch size, bucket, cache hits, step)
    so Perfetto can correlate spans with load.  The dict is held by
    REFERENCE and read at ``__exit__``: a call site may create it with
    what it knows up front and fill in the rest (e.g. cache hits) before
    the span closes."""

    __slots__ = ("_tracer", "_name", "_t0", "_args")

    def __init__(self, tracer: "Tracer", name: str, args=None):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer._record(self._name, self._t0, time.perf_counter(),
                             self._args)
        return False


class Tracer:
    """Wall-clock span recorder: per-name aggregates (always, when
    enabled) + the full event list (only when ``keep_events``)."""

    def __init__(self, *, enabled: bool = False, keep_events: bool = False):
        self.enabled = enabled
        self.keep_events = keep_events
        self._lock = threading.Lock()
        self._agg: dict[str, float] = {}        # since last flush
        self._agg_n: dict[str, int] = {}
        self._total: dict[str, float] = {}      # run-cumulative
        self._total_n: dict[str, int] = {}
        # (name, t0, t1, tid, args) ring — full, oldest events evict first
        self._events: collections.deque = collections.deque(
            maxlen=_MAX_EVENTS)
        self._dropped = 0

    # --- recording ------------------------------------------------------------

    def span(self, name: str, args: Optional[dict] = None):
        """Context manager timing one ``name`` span; nests freely.
        ``args`` (optional metadata dict) rides into the Chrome dump."""
        if not self.enabled:
            return _NULL
        return _Span(self, name, args)

    def record_span(self, name: str, t0: float, t1: float,
                    args: Optional[dict] = None) -> None:
        """Record one completed span from explicit timestamps — for call
        sites that only know after the fact whether the work really
        happened (e.g. an interval-gated checkpoint save)."""
        self._record(name, t0, t1, args)

    def _record(self, name: str, t0: float, t1: float,
                args: Optional[dict] = None) -> None:
        dur = t1 - t0
        with self._lock:
            self._agg[name] = self._agg.get(name, 0.0) + dur
            self._agg_n[name] = self._agg_n.get(name, 0) + 1
            self._total[name] = self._total.get(name, 0.0) + dur
            self._total_n[name] = self._total_n.get(name, 0) + 1
            if self.keep_events:
                if len(self._events) == self._events.maxlen:
                    self._dropped += 1  # deque evicts the oldest
                self._events.append(
                    (name, t0, t1, threading.get_ident(), args))

    def reset(self) -> None:
        """Drop all aggregates/events (tests; a new run in-process).
        Like the registry, a tracer is otherwise process-cumulative."""
        with self._lock:
            self._agg.clear()
            self._agg_n.clear()
            self._total.clear()
            self._total_n.clear()
            self._events.clear()
            self._dropped = 0

    # --- reading --------------------------------------------------------------

    def flush_fields(self, prefix: str = "span/") -> dict:
        """``{prefix<name>_s: seconds_since_last_flush}`` and reset the
        boundary aggregates (cumulative totals are untouched) — the
        fields a JSONL log record carries for its interval."""
        with self._lock:
            out = {f"{prefix}{k}_s": round(v, 6)
                   for k, v in self._agg.items()}
            self._agg.clear()
            self._agg_n.clear()
        return out

    def total_fields(self, prefix: str = "span/") -> dict:
        """Run-cumulative ``{prefix<name>_s, prefix<name>_n}`` — the
        telemetry_summary payload."""
        with self._lock:
            out = {}
            for k, v in self._total.items():
                out[f"{prefix}{k}_s"] = round(v, 6)
                out[f"{prefix}{k}_n"] = self._total_n[k]
        return out

    # --- Chrome/Perfetto dump -------------------------------------------------

    def dump_chrome_trace(self, path: str) -> int:
        """Write retained events as Chrome ``trace_events`` JSON
        (Perfetto-loadable); returns the number of events written.

        Complete "X" events on one pid, one tid per host thread —
        nesting is by time containment, exactly how the spans nested.
        DRAINS the retained events: a later dump (a second run in the
        same process) starts from a clean timeline and the memory is
        released rather than held to the retention cap for the process
        lifetime.
        """
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
            self._events.clear()
            self._dropped = 0
        pid = os.getpid()
        tids: dict[int, int] = {}
        trace = []
        for name, t0, t1, ident, args in events:
            tid = tids.setdefault(ident, len(tids))
            ev = {
                "name": name, "ph": "X", "pid": pid, "tid": tid,
                "ts": round(t0 * 1e6, 3),
                "dur": round((t1 - t0) * 1e6, 3),
            }
            if args:
                # the optional metadata payload (batch size, bucket,
                # step, cache hits) — Perfetto shows it on click, so a
                # slow span is attributable to its load
                ev["args"] = args
            trace.append(ev)
        doc = {"traceEvents": trace, "displayTimeUnit": "ms",
               "otherData": {"source": "hyperspace_torch.telemetry",
                             "dropped_events": dropped}}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(trace)


_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def default_tracer() -> Tracer:
    """The process-wide tracer every module-level :func:`span` feeds
    (disabled until :func:`enable` — zero-cost by default)."""
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = Tracer()
    return _tracer


def tracing() -> bool:
    """True when the default tracer is recording — the guard hot call
    sites use to skip building a span-``args`` dict entirely on the
    disabled path (``span()`` itself is allocation-free when disabled,
    but a caller-built metadata dict would not be)."""
    t = _tracer
    return t is not None and t.enabled


def span(name: str, args: Optional[dict] = None):
    """``with span("prep"): ...`` on the default tracer.

    Call sites keep this unconditionally: disabled (the default) it
    returns the shared nullcontext without allocating.  ``args`` is the
    optional metadata dict for the Chrome dump — held by reference, so
    a call site may fill it in before the span exits.
    """
    t = _tracer
    if t is None or not t.enabled:
        return _NULL
    return _Span(t, name, args)


def enable(*, keep_events: bool = False) -> Tracer:
    """Turn the default tracer on (``keep_events`` retains the full
    event list for a Chrome dump) and return it.  ``keep_events`` is
    SET, not or-ed: a later run without ``trace_out`` must be able to
    turn retention back off (the CLI derives the flag
    from the same run config, so duplicate enables within one run
    always agree)."""
    t = default_tracer()
    t.enabled = True
    t.keep_events = keep_events
    return t


def disable() -> None:
    t = default_tracer()
    t.enabled = False
