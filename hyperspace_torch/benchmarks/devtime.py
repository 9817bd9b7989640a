"""Device time by item under ``torch.profiler``, put on the card's own
clock by CUDA events, and kernel register use from ``ptxas``: the
measuring pieces that ``chip_smoke.py``, :mod:`flash_probe` and
:mod:`topk_probe` share.

Nothing here runs at import; both need a CUDA device (and ``nvcc`` for
:func:`ptxas_usage`).
"""

from __future__ import annotations

import re
import subprocess

# A window's calibration spins (``torch.cuda._sleep``: SM clock cycles,
# about 0.5 ms at 1,980 MHz), one before the calls and one after, each
# behind a lead spin four times as long that keeps the card busy while
# the host records the spin's first event and launches it, so that the
# events time the spin alone.  The first event and launches of a
# profiling session can take the host longer than a lead spin, so the
# session opens with a spin pair whose events are not read.
SPIN_CYCLES, LEAD_CYCLES = 1_000_000, 4_000_000
SPIN = "spin_kernel"
# how far the two calibration spins of one window may disagree
CLOCKS_AGREE = 0.03


def _spin(torch, marks) -> None:
    torch.cuda._sleep(LEAD_CYCLES)
    marks[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    marks[1].record()


def _window(torch, fn, reps: int) -> tuple[dict, list, dict]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _spin(torch, [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)])
        _spin(torch, marks[:2])
        for _ in range(reps):
            fn()
        _spin(torch, marks[2:])
        torch.cuda.synchronize()
    events = prof.key_averages()
    # an item's time per call is its mean time per recorded launch times
    # its launches per call (its count over reps, rounded up), so that a
    # launch the profiler dropped does not read as a faster call
    raw = {e.key: e.self_device_time_total / 1e3 / e.count
           * -(-e.count // reps)
           for e in events
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0 and SPIN not in e.key}
    ops = sorted({e.key for e in events if e.device_type == DeviceType.CPU})
    dev = sorted((e.time_range.start, SPIN in e.name,
                  e.time_range.elapsed_us() / 1e3)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    ev = [marks[0].elapsed_time(marks[1]), marks[2].elapsed_time(marks[3])]
    ratios = spin_ratios([(is_spin, ms) for _, is_spin, ms in dev], ev)
    scale = window_scale(ratios)
    items = raw if scale is None else {k: v / scale for k, v in raw.items()}
    return items, ops, {"reps": reps, "busy_ms": sum(items.values()),
                        "raw_busy_ms": sum(raw.values()),
                        "profiler_over_events": ratios,
                        "sm_mhz": [SPIN_CYCLES / e / 1e3 for e in ev],
                        "accepted": bool(raw) and scale is not None}


def spin_ratios(dev: list, events: list) -> list:
    """``[start, end]``: the profiler's duration of each calibration spin
    over the CUDA events' time of the same spin, None where the profiler
    dropped it.  ``dev`` lists the window's device events in time order
    as ``(is_spin, ms)``; ``events`` the events' times of the two
    calibration spins."""
    calls = [i for i, (is_spin, _) in enumerate(dev) if not is_spin]
    if not calls:
        return [None, None]
    out = []
    for group, e in ((dev[:calls[0]], events[0]),
                     (dev[calls[-1] + 1:], events[1])):
        # a lead spin runs four times a calibration spin's cycles; the
        # last calibration spin of a group is the one the events timed
        # (or, where the profiler dropped it, the session's opening one,
        # of the same cycles)
        cal = [ms for _, ms in group if ms < 2.0 * e]
        out.append(cal[-1] / e if cal else None)
    return out


def window_scale(ratios: list):
    """The factor by which the profiler's clock ran against the card's
    over one window: the end spin's ratio (the start spin's where the
    end one was dropped), or None where the profiler kept neither or
    the two disagree by more than ``CLOCKS_AGREE``."""
    kept = [r for r in ratios if r is not None]
    if not kept or max(kept) - min(kept) > CLOCKS_AGREE * min(kept):
        return None
    return kept[-1]


def profile_window(torch, fn, reps: int,
                   tries: int = 3) -> tuple[dict, list, list]:
    """Device ms per call of each item (kernel, copy, fill) that ``fn``
    runs on the card, over ``reps`` back-to-back calls after one warm-up
    call: only the events that ran on the card, so a host operator and
    the kernels it launched are not counted twice.

    The profiler's device durations of one window run at a scale of
    their own against the card's clock (0.80 to 1.14, median 0.992, over
    1,000 windows of ``topk_probe`` on an H100 80GB HBM3).  So each window is bracketed by two calibration spins of
    a known number of SM cycles, timed by the profiler and by CUDA
    events, and the window's items are divided by the profiler's time
    of a spin over the events' (``profiler_over_events``); the events
    also give the SM clock (``sm_mhz``).

    Returns ``(items, host_ops, windows)``: the items of the first
    window that recorded device events and could be put on the card's
    clock (else of the last window tried, as the profiler read them
    where no spin was kept), the names of the host operators ``fn``
    ran, and a record of each window tried (``accepted`` says which
    passed).  A window that fails is profiled again, up to ``tries``
    windows."""
    fn()
    _spin(torch, [torch.cuda.Event(enable_timing=True) for _ in range(2)])
    torch.cuda.synchronize()
    windows = []
    for _ in range(tries):
        items, ops, win = _window(torch, fn, reps)
        windows.append(win)
        if win["accepted"]:
            break
    return items, ops, windows


def ptxas_usage(nvcc: str, flags: list, source: str, so: str,
                name_of) -> dict:
    """``{name: {"registers": n, "spill_bytes": [stores, loads]}}`` of
    every kernel in ``source``, from ``nvcc -Xptxas -v`` with ``flags``
    into ``so``; ``name_of(mangled)`` names a kernel, or skips it with
    None."""
    r = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-o", so, source],
                       capture_output=True, text=True, check=True)
    regs, name = {}, None
    for line in (r.stdout + r.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = name_of(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if name and m:
            regs.setdefault(name, {})["spill_bytes"] = [int(m.group(1)),
                                                        int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            regs.setdefault(name, {})["registers"] = int(m.group(1))
    return regs
