"""JSONL metrics and event logging with an optional TensorBoard sink
(counterpart of ``hyperspace_tpu/train/logging.py``).

One JSON object a line: ``{"step", "ts", "host", **metrics}``; the file
is line-buffered, so a run that crashes keeps every record up to its
last step.  The process index is 0 (the port trains on one process).
``tensorboard_dir=`` writes the float fields through
``torch.utils.tensorboard``; where that import fails the logger warns
and writes JSONL only, as the JAX module does.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str], *, stdout: bool = False,
                 tensorboard_dir: Optional[str] = None):
        """``path`` None → stdout only when ``stdout``, else nothing."""
        self._stdout = stdout
        self._f = None
        self._tb = None
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)
        if tensorboard_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception as e:  # the JSONL stays the record
                import warnings

                warnings.warn(f"TensorBoard writer unavailable ({e!r}); "
                              "logging JSONL only")
        self._host = os.environ.get("HOSTNAME", "")

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": int(step), "ts": time.time(), "host": self._host}
        for k, v in metrics.items():
            if isinstance(v, bool):   # flags (health/ok) stay JSON bools
                rec[k] = v
                continue
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        line = json.dumps(rec)
        if self._f is not None:
            self._f.write(line + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "ts", "host") and isinstance(v, float):
                    self._tb.add_scalar(k, v, int(step))
        if self._stdout:
            print(line, flush=True)

    def event(self, name: str, **fields: Any) -> None:
        """One non-step record ``{"event": name, "ts", "host", ...}``; a
        field that JSON cannot hold is written as its ``repr``, the
        others as they are.  JSONL and stdout only."""
        rec = {"event": name, "ts": time.time(), "host": self._host,
               **fields}
        try:
            line = json.dumps(rec)
        except (TypeError, ValueError):
            safe = {}
            for k, v in rec.items():
                try:
                    json.dumps(v)
                    safe[k] = v
                except (TypeError, ValueError):
                    safe[k] = repr(v)
            line = json.dumps(safe)
        if self._f is not None:
            self._f.write(line + "\n")
        if self._stdout:
            print(line, flush=True)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path: str) -> list[dict]:
    """The records of a JSONL log.  A truncated last line (a run killed
    mid-write) is dropped; a malformed line with records after it
    raises."""
    out = []
    pending_error = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if pending_error is not None:
                raise pending_error
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                pending_error = e
    return out
