"""Process-wide counter/gauge/histogram registry (counterpart of
``hyperspace_tpu/telemetry/registry.py``): the one home of run counters.

Counters are monotonic sums (floats allowed: seconds accumulate); gauges
are last-write-wins levels; histograms (:mod:`~.histogram`,
``observe(name, value)``) are streaming latency distributions surfaced
as ``hist/<name>`` snapshot entries with count/sum/min/max and
p50/p90/p95/p99.  Every op is lock-guarded: the serving front door's
dispatch thread increments while the event loop reads.

:meth:`Registry.mark` and ``snapshot(baseline=)`` give per-run deltas
of this process-cumulative state: counters as differences, gauges only
when written since the mark, histograms as the delta distribution.

JAX's ``install_jax_monitoring_hook`` (``jax/recompiles``) has no
counterpart: the port's recompiles are kernel builds, counted as
``kernels/builds`` by ``kernels/_support.py`` (one per ``nvcc`` run),
beside ``kernels/loads`` (one per library a process loads) and the
batcher's ``serve/cold_dispatches`` (one per first launch at a shape).
"""

from __future__ import annotations

import threading
from typing import Optional


class Registry:
    """Named monotonic counters + last-write gauges, thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        # gauge -> (value, write seq): the seq lets a per-run snapshot
        # exclude stale gauges a PRIOR in-process run set (see mark())
        self._gauges: dict[str, tuple] = {}
        self._hists: dict = {}  # name -> histogram.Histogram
        self._seq = 0

    def inc(self, name: str, value: float = 1) -> None:
        """Add ``value`` to counter ``name`` (creating it at 0)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._seq += 1
            self._gauges[name] = (value, self._seq)

    def observe(self, name: str, value: float) -> None:
        """Record ``value`` into streaming histogram ``name`` (created
        on first observe).  The registry lock only guards the name
        lookup; the histogram's own lock guards the counts — an
        ``observe`` never blocks behind a ``snapshot`` of OTHER names.
        The price: an observe racing :meth:`reset` may land in the
        cleared epoch and be dropped with it (unlike ``inc``, which is
        reset-atomic) — fine for reset's tests/new-run use."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                from hyperspace_torch.telemetry.histogram import Histogram

                h = self._hists[name] = Histogram()
        h.observe(value)

    def get(self, name: str) -> float:
        """Current counter value (0 if never incremented); gauges via
        :meth:`snapshot`."""
        with self._lock:
            return self._counters.get(name, 0)

    def mark(self) -> dict:
        """Opaque per-run baseline for :meth:`snapshot`: counter values
        plus the gauge write sequence at capture time.  A consumer
        reporting per-run numbers from this process-cumulative registry
        (run_loop in library use) captures one at run start."""
        with self._lock:
            counters = dict(self._counters)
            seq = self._seq
            hists = dict(self._hists)
        # histogram snapshots are taken OUTSIDE the registry lock (each
        # histogram has its own) — same reason observe() releases it
        return {"counters": counters, "seq": seq,
                "hists": {k: h.snapshot() for k, h in hists.items()}}

    def snapshot(self, prefix: str = "", baseline: Optional[dict] = None
                 ) -> dict:
        """One consistent {prefix+name: value} view of every counter and
        gauge — the dict the loop merges into JSONL records.  With a
        ``baseline`` (a prior :meth:`mark`) counters are reported as
        deltas since the capture, and gauges are included only if
        WRITTEN since it — a stale level from a previous in-process run
        never masquerades as this run's.

        Histograms ride along as ``hist/<name>`` entries (count/sum/
        min/max/p50..p99 dicts — :meth:`HistogramSnapshot.fields`).
        They keep the fixed ``hist/`` namespace rather than taking
        ``prefix`` (the loop's ``ctr/`` prefix means "counter"; these
        are not), so JSONL records and bench artifacts carry e.g.
        ``hist/serve/e2e_ms`` verbatim.  With a baseline, each
        histogram is the DELTA distribution since the mark, and
        histograms with no observations since it are omitted — the
        same stale-exclusion contract as gauges."""
        with self._lock:
            if baseline is None:
                out = {prefix + k: v for k, v in self._counters.items()}
                out.update(
                    (prefix + k, v) for k, (v, _s) in self._gauges.items())
            else:
                base_c, base_s = baseline["counters"], baseline["seq"]
                out = {prefix + k: v - base_c.get(k, 0)
                       for k, v in self._counters.items()}
                out.update((prefix + k, v)
                           for k, (v, s) in self._gauges.items()
                           if s > base_s)
            hists = dict(self._hists)
        base_h = (baseline or {}).get("hists", {})
        for name, h in hists.items():
            snap = h.snapshot()
            if baseline is not None:
                prior = base_h.get(name)
                if prior is not None:
                    snap = snap.since(prior)
                if snap.count <= 0:
                    continue
            out["hist/" + name] = snap.fields()
        return out

    def export(self, hist_names=None) -> tuple[dict, dict, dict]:
        """``(counters, gauges, hist_snapshots)`` — the raw state the
        Prometheus exposition (:mod:`~.exposition`) and the SLO window
        (:mod:`~.window`) render from.
        Unlike :meth:`snapshot`, histograms come back as
        :class:`~.histogram.HistogramSnapshot`
        objects (bucket counts included — cumulative ``le`` buckets and
        ring-delta subtraction both need the vector, not the summary
        fields) and gauges lose their write-seq bookkeeping.
        ``hist_names`` (a container) limits which histograms are
        snapshotted — the SLO window captures one histogram per 5 s
        slot and per stats read, and snapshotting every ~285-bucket
        vector only to discard them would tax the admission path."""
        with self._lock:
            counters = dict(self._counters)
            gauges = {k: v for k, (v, _s) in self._gauges.items()}
            hists = dict(self._hists)
        if hist_names is not None:
            hists = {k: h for k, h in hists.items() if k in hist_names}
        # snapshots OUTSIDE the registry lock (each histogram has its
        # own) — the same ordering rule as mark()
        return counters, gauges, {k: h.snapshot() for k, h in hists.items()}

    def reset(self) -> None:
        """Drop every counter/gauge/histogram (tests; a new run
        in-process)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._seq = 0


_default: Optional[Registry] = None
_default_lock = threading.Lock()


def default_registry() -> Registry:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = Registry()
    return _default


def inc(name: str, value: float = 1) -> None:
    """Bump a counter on the default registry (the call sites' one-liner)."""
    default_registry().inc(name, value)


def set_gauge(name: str, value: float) -> None:
    default_registry().set_gauge(name, value)


def observe(name: str, value: float) -> None:
    """Record one value into histogram ``name`` on the default registry
    (latencies in ms by call-site convention — telemetry/histogram.py)."""
    default_registry().observe(name, value)


def snapshot(prefix: str = "") -> dict:
    return default_registry().snapshot(prefix)
