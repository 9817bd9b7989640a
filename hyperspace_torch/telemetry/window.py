"""Windowed SLOs (counterpart of ``hyperspace_tpu/telemetry/window.py``):
rolling p50/p95/p99 and rates from snapshot ring deltas.

The registry's histograms are process-cumulative; :class:`SloWindow`
answers "what is latency now".  It keeps a bounded ring of ``(t,
histogram snapshots, counters)`` captures, at most one per ``window_s /
slots`` seconds (``tick()`` is a clock compare until the slot turns
over), and :meth:`report` subtracts the oldest in-window capture from a
fresh one, so the reported quantiles and the shed/deadline/error rates
are the window's own.  :meth:`latency_pressure` is the degradation
ladder's optional latency signal (``slo_ms=`` on the serve CLI).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional, Sequence

from hyperspace_torch.telemetry.registry import Registry, default_registry

DEFAULT_WINDOW_S = 60.0
DEFAULT_SLOTS = 12

# the serve counters whose window-deltas become rates in report();
# callers may extend, but these are the SLO trio + the volume base
DEFAULT_COUNTERS = ("serve/requests", "serve/shed",
                    "serve/deadline_exceeded", "serve/errors")
DEFAULT_HISTS = ("serve/e2e_ms",)


class SloWindow:
    """Rolling-window view over registry histograms + counters."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S, *,
                 slots: int = DEFAULT_SLOTS,
                 registry: Optional[Registry] = None,
                 hist_names: Sequence[str] = DEFAULT_HISTS,
                 counter_names: Sequence[str] = DEFAULT_COUNTERS,
                 now: Optional[float] = None):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0; got {window_s}")
        if slots < 2:
            raise ValueError(f"slots must be >= 2; got {slots}")
        self.window_s = float(window_s)
        self.slot_s = self.window_s / int(slots)
        self._registry = registry
        self.hist_names = tuple(hist_names)
        self.counter_names = tuple(counter_names)
        self._lock = threading.Lock()
        # ring of (t, {hist: snapshot}, {counter: value}); bounded at
        # slots+1 so one capture always predates the window's left edge
        self._ring: collections.deque = collections.deque(
            maxlen=int(slots) + 1)
        self._next_slot = 0.0
        # latency_pressure caches one report per slot: the admission
        # path reads it per request, and a full delta per admit would
        # put a histogram subtraction on the hot path
        self._pressure_cache: tuple = (-float("inf"), 0.0)  # (until, p99)
        # prime the ring at construction so traffic in the FIRST slot
        # is already a delta against a baseline — without this, the
        # first capture (taken after the first request) would exclude
        # everything before it.  ``now`` pins the clock for tests.
        now = time.monotonic() if now is None else now
        self._next_slot = now + self.slot_s
        self._ring.append(self._capture(now))

    @classmethod
    def for_tenant(cls, tenant: str, window_s: float = DEFAULT_WINDOW_S,
                   **kw) -> "SloWindow":
        """A window over one tenant's series: the default histogram and
        counter names with the tenant suffix the batcher double-writes
        (``exposition.tenant_metric``), so each tenant of a multi-tenant
        process gets its own SLO view, not the shared aggregates."""
        from hyperspace_torch.telemetry.exposition import tenant_metric

        return cls(
            window_s,
            hist_names=tuple(tenant_metric(n, tenant)
                             for n in DEFAULT_HISTS),
            counter_names=tuple(tenant_metric(n, tenant)
                                for n in DEFAULT_COUNTERS),
            **kw)

    def _reg(self) -> Registry:
        return self._registry or default_registry()

    def _capture(self, now: float) -> tuple:
        reg = self._reg()
        counters, _gauges, hists = reg.export(hist_names=self.hist_names)
        return (now, hists,
                {n: counters.get(n, 0) for n in self.counter_names})

    def tick(self, now: Optional[float] = None) -> None:
        """Advance the ring (at most one capture per slot).  Call per
        request completion and per report — one clock read + one float
        compare until the slot turns over."""
        now = time.monotonic() if now is None else now
        if now < self._next_slot:
            return
        with self._lock:
            if now < self._next_slot:  # raced: the other caller captured
                return
            self._next_slot = now + self.slot_s
            self._ring.append(self._capture(now))

    def report(self, now: Optional[float] = None) -> dict:
        """The window's SLO view, computed from ring deltas:

        ``{"window_s": elapsed, "e2e_ms": {count, p50, p95, p99} |
        None, "rate_qps": r, "shed_rate": r, "deadline_rate": r,
        "error_rate": r}`` — rates are per-second over the window's
        actual elapsed span.  Before any traffic (empty ring / zero
        elapsed) the distribution is None and rates 0."""
        now = time.monotonic() if now is None else now
        self.tick(now)
        with self._lock:
            ring = list(self._ring)
        head = self._capture(now)
        # baseline = the oldest capture still inside (or bounding) the
        # window; the +slot slack keeps the span from collapsing right
        # after a slot turnover
        base = None
        for entry in ring:
            if now - entry[0] <= self.window_s + self.slot_s:
                base = entry
                break
        if base is None or now <= base[0]:
            return {"window_s": 0.0, "e2e_ms": None, "rate_qps": 0.0,
                    "shed_rate": 0.0, "deadline_rate": 0.0,
                    "error_rate": 0.0}
        elapsed = now - base[0]
        out: dict = {"window_s": round(elapsed, 3)}
        e2e = None
        for name in self.hist_names:
            cur = head[1].get(name)
            if cur is None:
                continue
            prior = base[1].get(name)
            delta = cur.since(prior) if prior is not None else cur
            if delta.count <= 0:
                continue
            e2e = {"count": delta.count}
            for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                v = delta.quantile(q)
                e2e[key] = None if v is None else round(v, 6)
            break  # the summary block reports the first (primary) hist
        out["e2e_ms"] = e2e

        def rate(counter: str) -> float:
            # resolve by BASE name: a per-tenant window is configured
            # with tenant-suffixed counter names (``serve/requests@
            # tenant=en`` — telemetry/exposition.py's label scheme), and
            # its rates must read those, not the all-tenant aggregates
            name = next((n for n in self.counter_names
                         if n == counter or n.startswith(counter + "@")),
                        counter)
            d = head[2].get(name, 0) - base[2].get(name, 0)
            return round(max(d, 0) / elapsed, 4)

        out["rate_qps"] = rate("serve/requests")
        out["shed_rate"] = rate("serve/shed")
        out["deadline_rate"] = rate("serve/deadline_exceeded")
        out["error_rate"] = rate("serve/errors")
        return out

    def latency_pressure(self, slo_ms: float,
                         now: Optional[float] = None) -> float:
        """1.0 while the windowed ``e2e_ms`` p99 exceeds ``slo_ms``,
        else 0.0 — the ladder's optional latency signal.  Cached per
        slot (module docstring); an empty window reads 0 (no evidence
        is never pressure)."""
        if slo_ms <= 0:
            return 0.0
        now = time.monotonic() if now is None else now
        valid_until, p99 = self._pressure_cache
        if now >= valid_until:
            rep = self.report(now)
            p99 = (rep["e2e_ms"] or {}).get("p99") or 0.0
            self._pressure_cache = (now + self.slot_s, p99)
        return 1.0 if p99 > slo_ms else 0.0
