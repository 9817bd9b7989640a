"""Train-plane step-phase telemetry: where a chunk's time goes
(counterpart of ``hyperspace_tpu/train/telemetry.py``).

A chunk decomposes into the :data:`PHASES`:

- ``data_wait`` — waiting on the host prefetcher for the next chunk's
  plans;
- ``host_gather`` — the host-to-device transfer of the chunk's cold rows
  (the host-resident table);
- ``device_step`` — the chunk's dispatch.  A launch is asynchronous;
  with ``profile=True`` the phase waits for the card to finish the work
  it enqueued before it closes (a ``torch.cuda.Event`` recorded after the
  body and synchronised), so the window times execution.  Off (the
  default) it times the enqueue only;
- ``write_back`` — fetching the touched cache rows back into the host
  table.

The host-resident trainer (``train/host_embed.py``) times all four a
chunk; the train loop's ``profile_steps`` times ``device_step``.  Each
phase observes a ``train/phase/<name>_ms`` histogram in the telemetry
registry.  ``annotate=True`` wraps each phase in
``torch.profiler.record_function``, so the phases appear as named ranges
in a ``torch.profiler`` trace.

JAX's :func:`install_hooks` arms ``jax/recompiles`` and ``jax/compile_s``.
The port's counterpart of a compile is a kernel build, and
``kernels/_support.py`` already counts ``kernels/builds`` (one per
``nvcc`` run) and ``kernels/loads`` (one per library a process loads)
whenever it builds or loads: :func:`install_hooks` has nothing to arm and
no counter is added here.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch
import torch.utils._pytree as pytree

from hyperspace_torch.telemetry import registry as telem

# a chunk's phases in order: they never overlap, so their bounds are
# monotone in this order
PHASES = ("data_wait", "host_gather", "device_step", "write_back")


def install_hooks() -> None:
    """Idempotent, and a no-op: kernel builds and loads are counted
    where they happen (module docstring)."""


def wait_for(out) -> None:
    """Wait until the card has run the work enqueued before ``out`` (a
    tensor or a tree of them) was made — a ``torch.cuda.Event`` recorded
    on the current stream and synchronised; no value is read.  Nothing
    for tensors on the CPU."""
    for t in pytree.tree_leaves(out):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            ev.synchronize()
            return


class StepPhases:
    """Per-chunk phase timers (module docstring).

    ``profile=True`` makes a phase given ``block`` wait for its output on
    the card before it closes; ``annotate=True`` adds profiler ranges.
    The last chunk's readings stay on :attr:`last` (ms) and
    :attr:`last_bounds` (``perf_counter`` pairs)."""

    def __init__(self, profile: bool = False, annotate: bool = False):
        self.profile = bool(profile)
        self.annotate = bool(annotate)
        self.last: dict[str, float] = {}
        self.last_bounds: dict[str, tuple] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block: Optional[Callable] = None):
        """Time one phase.  ``block`` returns the tensors the phase
        produced; it is called, and waited on, only in ``profile`` mode,
        after the body: ``with phases.phase("device_step", lambda:
        out):``."""
        ann = torch.profiler.record_function(name) if self.annotate \
            else None
        t0 = time.perf_counter()
        try:
            if ann is not None:
                with ann:
                    yield
            else:
                yield
            if self.profile and block is not None:
                wait_for(block())
        finally:
            t1 = time.perf_counter()
            self.last[name] = (t1 - t0) * 1e3
            self.last_bounds[name] = (t0, t1)
            telem.observe(f"train/phase/{name}_ms", (t1 - t0) * 1e3)
