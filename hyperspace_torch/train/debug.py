"""Debug and correctness modes (counterpart of
``hyperspace_tpu/train/debug.py``).

- :func:`nan_checks` — a block under
  ``torch.autograd.detect_anomaly(check_nan=True)``: a backward function
  that returns a NaN gradient raises, naming the forward operation that
  made it.  It catches the backward's NaNs only: a NaN that a forward
  operation produces and nothing differentiates passes unseen, where
  JAX's ``jax_debug_nans`` raises at every operation that produces one.
- :func:`assert_replicas_match` — one process holds one replica, so it
  returns; across a process group of more than one rank it raises "not
  ported" (the multi-process plane is not ported).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def nan_checks(enabled: bool = True):
    """Anomaly detection with NaN checks inside the block (module
    docstring); ``enabled=False`` leaves autograd as it is."""
    with torch.autograd.detect_anomaly(check_nan=True) if enabled \
            else torch.autograd.set_detect_anomaly(False, check_nan=True):
        yield


def assert_replicas_match(x, message: str = "replica values diverged"):
    """Raise if ``x`` differs across processes: nothing to compare in one
    process; a group of more than one rank raises ``NotImplementedError``."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "assert_replicas_match across processes: not ported (the "
            "multi-process plane)")
