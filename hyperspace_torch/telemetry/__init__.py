"""Run telemetry of the port (counterpart of ``hyperspace_tpu.telemetry``).

- :mod:`registry` — process-wide named counters, gauges and histograms
  (``serve/*``, ``fault/*``, ``kernels/*``) with per-run deltas;
- :mod:`histogram` — streaming log-bucket latency histograms, mergeable
  and subtractable, p50/p90/p95/p99;
- :mod:`window` — the rolling SLO window over registry deltas;
- :mod:`exposition` — Prometheus text of the registry (``/metrics``);
- :mod:`spans` — async-safe per-request span trees;
- :mod:`trace` — per-thread host spans and the Chrome ``trace_events``
  dump;
- :mod:`health` — the hyperbolic numerical-health monitor.
"""

import contextlib

from hyperspace_torch.telemetry.exposition import (  # noqa: F401
    MetricsFileWriter,
    render_prometheus,
    sanitize_name,
)
from hyperspace_torch.telemetry.histogram import (  # noqa: F401
    Histogram,
    HistogramSnapshot,
)
from hyperspace_torch.telemetry.registry import (  # noqa: F401
    Registry,
    default_registry,
    observe,
)
from hyperspace_torch.telemetry.trace import (  # noqa: F401
    Tracer,
    default_tracer,
    span,
)
from hyperspace_torch.telemetry.window import SloWindow  # noqa: F401


@contextlib.contextmanager
def cli_session(telemetry: bool, trace_out, *, stream=None):
    """The serve CLI's telemetry bracket: enables the host tracer up
    front (keeping its events when ``trace_out`` is set), and in a
    ``finally`` dumps the Chrome trace — a crashed run still leaves its
    trace, and an ``OSError`` from the dump never masks the exception
    being unwound — then disables it.  ``stream`` is where the dump
    notice prints (serve's stdout is its response stream)."""
    from hyperspace_torch.telemetry import trace as _trace

    if telemetry or trace_out:
        _trace.enable(keep_events=bool(trace_out))
    try:
        yield
    finally:
        if trace_out:
            try:
                n = _trace.default_tracer().dump_chrome_trace(trace_out)
                print(f"[telemetry] {n} trace events -> {trace_out}",
                      file=stream, flush=True)
            except OSError as e:
                print(f"[telemetry] trace dump failed: {e!r}",
                      file=stream, flush=True)
        if telemetry or trace_out:
            _trace.disable()
