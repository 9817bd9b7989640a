"""Hysteresis-guarded degradation ladder (counterpart of
``hyperspace_tpu/resilience/degrade.py``).

Under overload a server can make callers wait (the bounded admission
queue), refuse (shed with ``overloaded``), or answer cheaper.  The ladder
is the third: a state machine over quality levels ordered best-first
(for the k-NN engine: full ``nprobe``, then ``nprobe`` halved toward 1,
then cache-only — ``serve/batcher.py`` owns that mapping; this module
owns only the level dynamics).

A step DOWN fires after ``down_after`` consecutive observations at or
above ``high`` pressure (default 1: overload reacts at once), a step UP
only after ``up_after`` consecutive observations at or below ``low``
(default 8: recovery waits for proof).  Readings between the watermarks
reset both streaks.  Thread-safe; ``observe`` is a few comparisons under
one lock.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional


class HysteresisLadder:
    """Pressure-driven level index in ``[0, levels-1]`` (0 = full
    quality).  ``on_change(old, new)`` fires outside no lock-ordering
    hazards (called while holding the ladder's own lock only)."""

    def __init__(self, levels: int, *, high: float = 0.75,
                 low: float = 0.25, down_after: int = 1,
                 up_after: int = 8,
                 on_change: Optional[Callable[[int, int], None]] = None):
        if levels < 1:
            raise ValueError(f"levels must be >= 1; got {levels}")
        if not 0.0 <= low < high <= 1.0:
            raise ValueError(
                f"want 0 <= low < high <= 1; got low={low} high={high}")
        if down_after < 1 or up_after < 1:
            raise ValueError("down_after/up_after must be >= 1")
        self.levels = int(levels)
        self.high, self.low = float(high), float(low)
        self.down_after, self.up_after = int(down_after), int(up_after)
        self.on_change = on_change
        self._lock = threading.Lock()
        self._level = 0
        self._hi_streak = 0
        self._lo_streak = 0

    @property
    def level(self) -> int:
        return self._level

    def observe(self, pressure: float) -> int:
        """Feed one pressure reading; returns the (possibly new) level."""
        with self._lock:
            old = self._level
            if pressure >= self.high:
                self._hi_streak += 1
                self._lo_streak = 0
                if (self._hi_streak >= self.down_after
                        and self._level < self.levels - 1):
                    self._level += 1
                    self._hi_streak = 0
            elif pressure <= self.low:
                self._lo_streak += 1
                self._hi_streak = 0
                if self._lo_streak >= self.up_after and self._level > 0:
                    self._level -= 1
                    self._lo_streak = 0
            else:
                # between the watermarks: evidence for neither direction
                self._hi_streak = self._lo_streak = 0
            new = self._level
            if new != old and self.on_change is not None:
                self.on_change(old, new)
            return new
