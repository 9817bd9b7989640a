"""Profiling and timing harness (counterpart of
``hyperspace_tpu/train/profiling.py``).

- :func:`benchmark_step`: wall-clock a step with warm-up, waiting for
  the card after each call where JAX calls ``block_until_ready``;
- :func:`trace`: a ``torch.profiler`` session over a block, its Chrome
  trace written into ``log_dir``;
- :func:`compiled_cost`: the floating-point operations of one call,
  counted by ``torch.utils.flop_counter.FlopCounterMode``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import torch

from hyperspace_torch.train.telemetry import wait_for


def benchmark_step(fn: Callable[[], Any], *, warmup: int = 3,
                   iters: int = 20) -> dict:
    """Time ``fn()`` (returning tensors); seconds statistics.

    ``warmup=0`` is allowed (a cold first call, its builds in
    ``max_s``): the wait after the warm-up runs only when a warm-up call
    returned something to wait on."""
    out = None
    for _ in range(warmup):
        out = fn()
    if out is not None:
        wait_for(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        wait_for(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    n = len(times)
    return {"mean_s": sum(times) / n, "p50_s": times[n // 2],
            "min_s": times[0], "max_s": times[-1], "iters": n}


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` session (CPU and, where there is one, the
    card) over the block; its Chrome trace is written to
    ``log_dir/trace.json`` (open it in Perfetto or ``chrome://tracing``)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def cost_analysis_dict(fn: Callable, *args, **kwargs) -> dict:
    """``{"flops": total}`` of one call of ``fn(*args, **kwargs)``, as
    ``FlopCounterMode`` counts them (matrix products, convolutions and
    attention; elementwise work and the port's hand kernels count
    nothing), or ``{}`` where the count fails.  JAX's XLA analysis also
    gives ``bytes accessed``; PyTorch has no such analysis, so the key is
    left out, as JAX leaves every key out on a backend without one."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        counter = FlopCounterMode(display=False)
        with counter:
            fn(*args, **kwargs)
    except Exception:  # noqa: BLE001 — a call the counter cannot follow
        return {}
    return {"flops": float(counter.get_total_flops())}


def compiled_cost(fn: Callable, *args, **kwargs) -> dict:
    """The operation count of ``fn(*args)`` (:func:`cost_analysis_dict`):
    ``flops`` only, ``bytes accessed`` not being counted."""
    cost = cost_analysis_dict(fn, *args, **kwargs)
    return {k: cost[k] for k in ("flops", "bytes accessed") if k in cost}
