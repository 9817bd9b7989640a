"""The profiler's clock check in ``hyperspace_torch/benchmarks/devtime.py``:
each profiled window is bracketed by calibration spins timed both by the
profiler and by CUDA events, and the window's device times are put on
the card's clock by their ratio."""

import pytest

from hyperspace_torch.benchmarks.devtime import (CLOCKS_AGREE, spin_ratios,
                                                 window_scale)

EVENTS = [0.5051, 0.5049]       # the two calibration spins by CUDA events
LEAD, CAL, CALL = 2.02, 0.505, 0.449


def window(scale, drop=()):
    """A window's device events as ``(is_spin, ms)``, every duration
    scaled by ``scale``; ``drop`` names positions the profiler lost."""
    dev = ([(True, LEAD), (True, CAL)] * 2 + [(False, CALL)] * 3
           + [(True, LEAD), (True, CAL)])
    return [(s, ms * scale) for i, (s, ms) in enumerate(dev)
            if i not in drop]


@pytest.mark.parametrize("dev, ratios", [
    (window(1.0), [CAL / EVENTS[0], CAL / EVENTS[1]]),
    (window(0.757), [0.757 * CAL / EVENTS[0], 0.757 * CAL / EVENTS[1]]),
    # a lead or a calibration spin dropped at either end (the opening
    # pair's spin runs the same cycles as the timed one)
    (window(1.0, drop=(2,)), [CAL / EVENTS[0], CAL / EVENTS[1]]),
    (window(1.0, drop=(3,)), [CAL / EVENTS[0], CAL / EVENTS[1]]),
    (window(1.0, drop=(1, 3)), [None, CAL / EVENTS[1]]),
    (window(1.0, drop=(7, 8)), [CAL / EVENTS[0], None]),
    (window(1.0, drop=(8,)), [CAL / EVENTS[0], None]),
    # no call recorded: nothing to place the spins by
    ([(True, LEAD), (True, CAL)], [None, None]),
])
def test_spin_ratios(dev, ratios):
    got = spin_ratios(dev, EVENTS)
    assert [g is None for g in got] == [r is None for r in ratios]
    assert [g for g in got if g is not None] == pytest.approx(
        [r for r in ratios if r is not None])


@pytest.mark.parametrize("ratios, scale", [
    ([0.9998, 0.9990], 0.9990),
    ([0.757, 0.756], 0.756),
    ([None, 1.04], 1.04),
    ([0.95, None], 0.95),
    ([None, None], None),
    # the two ends disagree: the window cannot be put on one clock
    ([0.94, 0.99], None),
    ([1.0, 1.0 + CLOCKS_AGREE * 1.1], None),
])
def test_window_scale(ratios, scale):
    got = window_scale(ratios)
    assert got == (None if scale is None else pytest.approx(scale))
