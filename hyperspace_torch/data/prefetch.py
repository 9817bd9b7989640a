"""Host-side prefetch: the overlap half of the chunked training loop
(counterpart of ``hyperspace_tpu/data/prefetch.py``).

A chunked run alternates device work (one chunk's dispatch) and host
work (numpy planning, sampling, gathers from a host table).  A
background thread assembles chunk *i+1* while the device trains on chunk
*i*, handing finished items over a bounded queue.  The worker does host
work only: every CUDA call stays on the consumer's thread.

Semantics:

- **Ordering**: ``next()`` yields ``fn(start)``, ``fn(start+1)``, … in
  order, exactly once each.
- **Bounded look-ahead**: at most ``depth`` finished items are ever
  queued (the worker's put blocks when full), bounding host memory.
- **Failure**: an exception in ``fn`` is re-raised from ``next()`` with
  the worker's exception as its cause (a worker that died silently
  would leave ``next()`` blocked for ever).
- **Shutdown**: ``close()`` (or the context manager) stops the worker,
  drains the queue to unblock a put, and joins the thread.
- **Faults**: ``next()`` is the ``data.next_batch`` fault site
  (``resilience/faults.py``), on the consumer side, where the training
  loop's failure handling sees an injected error or latency.

Telemetry: ``prefetch/produced`` and ``prefetch/consumed`` count items;
a ``next()`` that finds the queue empty (the device out-ran the host)
counts ``prefetch/stalls``, adds the blocked seconds to
``prefetch/stall_s`` and records a ``prefetch_wait`` span; the queue
depth after a get is the ``prefetch/queue_depth`` gauge.

JAX's ``ShardedHostPrefetcher`` (each process keeps its row range of a
global batch) belongs to the multi-process plane, which is not ported.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable

from hyperspace_torch.telemetry import registry as _telem
from hyperspace_torch.telemetry.trace import span as _span


class HostPrefetcher:
    """Run ``fn(index)`` for index = start, start+1, … in a background
    thread, ``depth`` items ahead of the consumer."""

    def __init__(self, fn: Callable[[int], Any], *, depth: int = 2,
                 start: int = 0):
        self._fn = fn
        self._q: Any = queue.Queue(maxsize=int(depth))
        self._stop = threading.Event()
        self._start = int(start)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        index = self._start
        while not self._stop.is_set():
            try:
                item = self._fn(index)
            except BaseException as e:  # noqa: BLE001 — re-raised in next()
                item = e
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    _telem.inc("prefetch/produced")
                    break
                except queue.Full:
                    continue
            if isinstance(item, BaseException):
                return  # the consumer re-raises; items after a failure
            index += 1  # would hide it

    def next(self) -> Any:
        """Block until the next item is ready (re-raising worker errors)."""
        from hyperspace_torch.resilience import faults

        if faults.active():
            faults.hit("data.next_batch")
        if self._q.empty():
            # the device out-ran the host: the wait is a stall
            _telem.inc("prefetch/stalls")
            t0 = time.perf_counter()
            with _span("prefetch_wait"):
                item = self._q.get()
            _telem.inc("prefetch/stall_s", time.perf_counter() - t0)
        else:
            item = self._q.get()
        _telem.inc("prefetch/consumed")
        _telem.set_gauge("prefetch/queue_depth", self._q.qsize())
        if isinstance(item, BaseException):
            raise RuntimeError(
                f"{type(self).__name__} worker failed") from item
        return item

    def close(self):
        self._stop.set()
        while not self._q.empty():  # unblock a worker stuck on put
            try:
                self._q.get_nowait()
            except queue.Empty:  # raced the worker's last put: done
                break
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
