"""Access log and flight recorder (counterpart of
``hyperspace_tpu/serve/access.py``): per-request records that survive.

- :func:`new_request_id` — accept-or-generate request ids (the HTTP
  front door reads ``X-Request-Id``; the stdin loop a ``request_id``
  field), threaded through the lifecycle into span args, the response
  and the access record.
- :class:`AccessLog` — one JSONL line per request (``access_log=`` on
  the serve CLI): request id, route, tenant (the registry tenant's name,
  None on a single-tenant door), buckets, collator flush id,
  queue-wait/dispatch/e2e ms, cache hits and misses, degrade level,
  taxonomy outcome and the per-stage decomposition.  Thread-safe,
  line-buffered appends.
- :class:`FlightRecorder` — a bounded ring of recent access records,
  dumped with a counter snapshot to ``incident_<stamp>_<reason>.jsonl``
  under ``incident_dir=`` on a typed-error burst, a degrade transition
  or a drain; one dump per cooldown per reason class.

Both are off by default: the batcher then holds no sink and builds no
record.  ``serve/incidents`` counts dumps.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import uuid
from typing import Optional

from hyperspace_torch.telemetry import registry as telem

DEFAULT_RING = 512
DEFAULT_BURST_N = 10
DEFAULT_BURST_S = 5.0
DEFAULT_COOLDOWN_S = 30.0


def new_request_id() -> str:
    """A fresh 16-hex request id (uuid4-derived — unique enough to join
    a response, an access-log line, and a flush id across hosts)."""
    return uuid.uuid4().hex[:16]


class AccessLog:
    """Append-only JSONL access log, thread-safe.

    ``emit(record)`` stamps ``ts`` (wall clock — log lines are joined
    with external systems, unlike the perf_counter lifecycle stamps),
    writes one line, and feeds the optional :class:`FlightRecorder`.
    Non-serializable values degrade per-record to ``repr`` — an odd
    field must never cost the request or the line."""

    def __init__(self, path: Optional[str] = None, *,
                 recorder: Optional["FlightRecorder"] = None):
        self._f = None
        self.path = path
        self.recorder = recorder
        self._lock = threading.Lock()
        self.lines = 0
        if path:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            self._f = open(path, "a", buffering=1, encoding="utf-8")

    def emit(self, record: dict) -> None:
        record = dict(record)
        record.setdefault("ts", time.time())
        try:
            line = json.dumps(record)
        except (TypeError, ValueError):
            line = json.dumps({k: v if _jsonable(v) else repr(v)
                               for k, v in record.items()})
        if self._f is not None:
            with self._lock:
                # re-checked INSIDE the lock: a concurrent close() may
                # have nulled the handle between the fast-path check
                # and acquiring the lock — a shutdown race must drop
                # the line, never raise into a live request
                if self._f is not None:
                    self._f.write(line + "\n")
                    self.lines += 1
        if self.recorder is not None:
            self.recorder.record(record)

    def close(self) -> None:
        if self._f is not None:
            with self._lock:
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


class FlightRecorder:
    """Bounded ring of recent access records + incident dumps.

    Triggers (module docstring): :meth:`record` feeds the ring and the
    error-burst detector (any record whose ``outcome`` is not ``ok``);
    :meth:`note_degrade` fires on ladder transitions;
    callers invoke :meth:`dump` directly for drain/SIGTERM.  A dump
    writes ``incident_<utc-stamp>_<reason>.jsonl``: one header line
    (``event: incident``, the reason, and a full counter/gauge
    snapshot — the counter marks) followed by the ring's records,
    oldest first."""

    def __init__(self, incident_dir: str, *, capacity: int = DEFAULT_RING,
                 burst_n: int = DEFAULT_BURST_N,
                 burst_s: float = DEFAULT_BURST_S,
                 cooldown_s: float = DEFAULT_COOLDOWN_S):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        if burst_n < 1 or burst_s <= 0:
            raise ValueError(
                f"bad burst spec n={burst_n} within {burst_s}s")
        self.incident_dir = incident_dir
        os.makedirs(incident_dir, exist_ok=True)
        self.burst_n = int(burst_n)
        self.burst_s = float(burst_s)
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=int(capacity))
        self._error_ts: collections.deque = collections.deque(
            maxlen=int(burst_n))
        self._last_dump: dict[str, float] = {}  # reason class -> t
        self._writers: list[threading.Thread] = []
        self.dumps: list[str] = []

    def record(self, record: dict) -> None:
        outcome = record.get("outcome", "ok")
        now = time.monotonic()
        with self._lock:
            self._ring.append(dict(record))
            if outcome == "ok":
                return
            self._error_ts.append(now)
            burst = (len(self._error_ts) == self.burst_n
                     and now - self._error_ts[0] <= self.burst_s)
        if burst:
            # the triggering record rides the header: with spans on it
            # carries its full span tree, so the incident names WHICH
            # stage blew the budget, not just the flush id
            self.dump(f"error_burst_{outcome}", _cls="error_burst",
                      trigger=record)

    def note_degrade(self, old: int, new: int) -> None:
        """Ladder transition hook (both directions — a recovery's ring
        shows what the degraded interval looked like)."""
        self.dump(f"degrade_{old}_to_{new}", _cls="degrade")

    def dump(self, reason: str, _cls: Optional[str] = None,
             wait: bool = False,
             trigger: Optional[dict] = None) -> Optional[str]:
        """Snapshot the ring and hand the file write to a background
        thread; returns the incident path (None when the reason class
        is inside its cooldown).  The triggers fire on the SERVING
        path — burst detection inside a request coroutine on the
        asyncio event loop, degrade transitions inside ``_admit`` —
        and a synchronous multi-hundred-line write to a contended disk
        there would stall every in-flight request.  Only the
        in-memory snapshot + thread handoff happen in the caller;
        ``wait=True`` (the drain paths — the process is about to exit)
        joins the write.  Write failures drop the file silently —
        evidence loss only, never a serving failure; the path lands in
        :attr:`dumps` (and ``serve/incidents`` ticks) only once the
        write succeeded."""
        cls = _cls or reason
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(cls)
            if last is not None and now - last < self.cooldown_s:
                return None
            self._last_dump[cls] = now
            records = list(self._ring)
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)
        path = os.path.join(self.incident_dir,
                            f"incident_{stamp}_{safe}.jsonl")
        header = {"event": "incident", "reason": reason,
                  "ts": time.time(), "ring_len": len(records),
                  "counters": telem.default_registry().snapshot("ctr/")}
        if trigger is not None:
            # attribution: the request that tripped the trigger, and —
            # when the span layer is on — its full span tree (the
            # batcher attaches "span" to every non-ok record)
            header["trigger_request_id"] = trigger.get("request_id")
            if "span" in trigger:
                header["trigger_span"] = trigger["span"]
        t = threading.Thread(target=self._write_dump,
                             args=(path, header, records),
                             name="flightrec-dump", daemon=True)
        with self._lock:
            self._writers = [w for w in self._writers if w.is_alive()]
            self._writers.append(t)
        t.start()
        if wait:
            t.join()
        return path

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for outstanding incident writes (tests; shutdown)."""
        with self._lock:
            writers = list(self._writers)
        for t in writers:
            t.join(timeout)

    def _write_dump(self, path: str, header: dict,
                    records: list) -> None:
        try:
            with open(path, "a", encoding="utf-8") as f:
                f.write(json.dumps(header) + "\n")
                for rec in records:
                    try:
                        f.write(json.dumps(rec) + "\n")
                    except (TypeError, ValueError):
                        f.write(json.dumps(
                            {k: v if _jsonable(v) else repr(v)
                             for k, v in rec.items()}) + "\n")
        except OSError:
            return  # evidence loss only, never a serving failure
        telem.inc("serve/incidents")
        self.dumps.append(path)
