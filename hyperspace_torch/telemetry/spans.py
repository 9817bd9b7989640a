"""Hierarchical request spans (counterpart of
``hyperspace_tpu/telemetry/spans.py``): contextvar-propagated,
async-safe, on the monotonic ``perf_counter`` clock.

The serving front door interleaves many request coroutines on one event
loop, so the per-thread nesting of :mod:`~.trace` cannot describe a
request.  Here:

- spans are explicit objects with parent/child links, keyed by the
  request id;
- the current span is a contextvar (:func:`current`, :func:`use`,
  :func:`request`): each asyncio task sees its own, and :func:`use`
  carries a span across the collator's ``run_in_executor`` hop into the
  dispatch thread;
- a collated flush is one device dispatch shared by N requests: the
  collator builds one ``flush`` span and ``adopt``-s it into every
  member's tree (child appends are lock-guarded);
- :func:`stage` observes its duration into a registry histogram on
  exit, so every stage is also a ``/metrics`` series.

Off by default at the cost of one module-global check: :func:`stage`
returns a shared no-op context manager and :func:`root` returns None.
The serve CLI's ``trace=`` turns it on.  :meth:`Span.to_dict` gives the
tree with offsets from its root and durations in ms.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Optional

from hyperspace_torch.telemetry import registry as telem

_current: contextvars.ContextVar = contextvars.ContextVar(
    "hyperspace_span", default=None)
_enabled = False


def enable() -> None:
    """Turn span recording on (process-global, like the tracer)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def current() -> Optional["Span"]:
    """The calling task's/thread's current span (None = no scope)."""
    return _current.get()


def active() -> bool:
    """Recording AND inside a span scope — the engine's cheap gate for
    measurement-mode work (e.g. blocking on device results so the
    ``device_compute`` stage times execution, not enqueue)."""
    return _enabled and _current.get() is not None


class Span:
    """One timed node: name, request id, perf_counter stamps, children.

    Spans are cheap plain objects — the contextvar machinery lives in
    the module functions, so a span can also be built, stamped, and
    attached entirely by hand (the lifecycle's boundary-diff stages).
    ``children`` appends are lock-guarded: the dispatch executor
    attaches stages to a flush span while member coroutines may be
    serializing their trees.
    """

    __slots__ = ("name", "request_id", "t0", "t1", "meta", "children",
                 "_lock")

    def __init__(self, name: str, request_id: Optional[str] = None,
                 meta: Optional[dict] = None):
        self.name = name
        self.request_id = request_id
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.meta = meta
        self.children: list[Span] = []
        self._lock = threading.Lock()

    def close(self) -> None:
        """Stamp the end (idempotent — first close wins)."""
        if self.t1 is None:
            self.t1 = time.perf_counter()

    @property
    def dur_ms(self) -> Optional[float]:
        return None if self.t1 is None else (self.t1 - self.t0) * 1e3

    def adopt(self, child: "Span") -> "Span":
        """Attach an existing span as a child (the flush-sharing path —
        the child may appear in several parents' trees by design)."""
        with self._lock:
            self.children.append(child)
        return child

    def add(self, name: str, t0: float, t1: float,
            meta: Optional[dict] = None) -> "Span":
        """Attach a pre-timed child (boundary-stamp stages: the caller
        already holds both perf_counter readings)."""
        c = Span(name, self.request_id, meta)
        c.t0, c.t1 = t0, t1
        return self.adopt(c)

    def to_dict(self, origin: Optional[float] = None) -> dict:
        """JSON-able tree: offsets in ms relative to ``origin`` (the
        tree root's t0 by default), durations in ms (None = the span
        never closed — itself evidence in an incident dump)."""
        if origin is None:
            origin = self.t0
        with self._lock:
            kids = list(self.children)
        d: dict = {"name": self.name,
                   "t_off_ms": round((self.t0 - origin) * 1e3, 3),
                   "dur_ms": (None if self.t1 is None
                              else round((self.t1 - self.t0) * 1e3, 3))}
        if self.request_id is not None:
            d["request_id"] = self.request_id
        if self.meta:
            d["meta"] = dict(self.meta)
        if kids:
            d["children"] = [c.to_dict(origin) for c in kids]
        return d


def root(name: str, request_id: Optional[str] = None,
         meta: Optional[dict] = None) -> Optional[Span]:
    """A new lifecycle-owned span, or None when recording is off.

    If the caller is already inside a span scope (the HTTP front
    door's request envelope), the new span is adopted as its child —
    the tree keeps the whole request story without the lifecycle
    having to know who called it."""
    if not _enabled:
        return None
    s = Span(name, request_id, meta)
    cur = _current.get()
    if cur is not None:
        cur.adopt(s)
    return s


@contextlib.contextmanager
def use(span: Optional[Span]):
    """Scope ``span`` as the current span for this task/thread — the
    executor-adoption idiom: the collator builds a flush span on the
    event loop, the dispatch thread ``use``-s it, and every
    :func:`stage` inside the engine lands in the right tree.  A None
    span scopes nothing (the disabled path composes)."""
    if span is None:
        yield None
        return
    tok = _current.set(span)
    try:
        yield span
    finally:
        _current.reset(tok)


@contextlib.contextmanager
def request(name: str, request_id: Optional[str] = None):
    """Root request envelope + contextvar scope (the front door wraps
    each serve op in one, keyed by its X-Request-Id) — closed on exit;
    yields None when recording is off."""
    if not _enabled:
        yield None
        return
    s = Span(name, request_id)
    tok = _current.set(s)
    try:
        yield s
    finally:
        s.close()
        _current.reset(tok)


class _Stage:
    """Context manager for one child stage under the current span."""

    __slots__ = ("parent", "name", "metric", "meta", "span", "_tok")

    def __init__(self, parent: Span, name: str, metric: Optional[str],
                 meta: Optional[dict]):
        self.parent = parent
        self.name = name
        self.metric = metric
        self.meta = meta

    def __enter__(self) -> Span:
        self.span = Span(self.name, self.parent.request_id, self.meta)
        self.parent.adopt(self.span)
        self._tok = _current.set(self.span)
        return self.span

    def __exit__(self, *exc) -> None:
        self.span.close()
        _current.reset(self._tok)
        if self.metric is not None:
            # the metric name is the call site's literal (the catalog
            # rows live there); this observe is the shared plumbing
            telem.observe(self.metric, self.span.dur_ms)


_NULL = contextlib.nullcontext()


def stage(name: str, metric: Optional[str] = None,
          meta: Optional[dict] = None):
    """A timed child of the current span; observes ``metric`` (a
    registry histogram name, ms) on exit.  Off — or outside any span
    scope (prewarm, direct engine tests) — it returns a shared no-op
    context manager: zero allocation, no stray histogram samples."""
    if not _enabled:
        return _NULL
    parent = _current.get()
    if parent is None:
        return _NULL
    return _Stage(parent, name, metric, meta)
