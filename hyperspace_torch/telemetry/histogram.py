"""Streaming latency histograms (counterpart of
``hyperspace_tpu/telemetry/histogram.py``): the third metric kind beside
counters and gauges.

- **Fixed log-spaced buckets**: upper bounds grow by ``GROWTH`` (1.1)
  from ``LO`` to ``HI`` (1e-3..1e5 — 1 µs to 100 s in the call sites'
  milliseconds).  A quantile estimate is its bucket's geometric
  midpoint, so the relative error is at most ``sqrt(GROWTH) - 1`` ≈ 4.9 %.
- **Thread-safe observe** with no numpy and no device work: one lock,
  one ``math.log``, one list increment — safe on the serving path.
- **Mergeable snapshots**: :class:`HistogramSnapshot` merges by
  element-wise addition and ``since`` subtracts a baseline — how the
  registry reports per-interval deltas (``Registry.mark``/``snapshot``).

The bucket scheme, the quantile rule and the ``fields()`` rounding are
the JAX package's, so the same observations give the same buckets,
counts and quantiles in either package.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Sequence

# default bucket scheme: ~5% relative error over 8 decades.  With the
# call-site convention of milliseconds this spans 1 µs .. 100 s; values
# outside land in the underflow/overflow buckets and their quantile
# estimates clamp to the exact observed min/max.
DEFAULT_LO = 1e-3
DEFAULT_HI = 1e5
DEFAULT_GROWTH = 1.1

DEFAULT_QUANTILES = (0.5, 0.9, 0.95, 0.99)

_scheme_cache: dict = {}


def _num_buckets(lo: float, hi: float, growth: float) -> int:
    """Bucket count for the finite range (cached per scheme)."""
    key = (lo, hi, growth)
    n = _scheme_cache.get(key)
    if n is None:
        if not (0 < lo < hi) or growth <= 1.0:
            raise ValueError(
                f"bad histogram scheme lo={lo} hi={hi} growth={growth}")
        n = _scheme_cache[key] = int(
            math.ceil(math.log(hi / lo) / math.log(growth)))
    return n


class HistogramSnapshot:
    """Frozen view of a histogram: bucket counts + count/sum/min/max.

    ``counts`` has ``len == num_buckets + 2``: index 0 is the underflow
    bucket (values < lo, incl. non-positive), the last is overflow
    (values >= hi).  Snapshots with the same (lo, hi, growth) scheme
    merge associatively and subtract (``since``) — the registry's
    baseline-delta mechanics reuse the same arithmetic sharded
    histogram combination would.
    """

    __slots__ = ("counts", "count", "sum", "vmin", "vmax",
                 "lo", "hi", "growth")

    def __init__(self, counts: Sequence[int], count: int, total: float,
                 vmin: Optional[float], vmax: Optional[float],
                 lo: float, hi: float, growth: float):
        self.counts = tuple(counts)
        self.count = int(count)
        self.sum = float(total)
        self.vmin = vmin
        self.vmax = vmax
        self.lo = lo
        self.hi = hi
        self.growth = growth

    def _check_scheme(self, other: "HistogramSnapshot") -> None:
        if (self.lo, self.hi, self.growth) != (other.lo, other.hi,
                                               other.growth):
            raise ValueError(
                "histogram scheme mismatch: "
                f"{(self.lo, self.hi, self.growth)} vs "
                f"{(other.lo, other.hi, other.growth)}")

    def merge(self, other: "HistogramSnapshot") -> "HistogramSnapshot":
        """Element-wise combine (associative, commutative)."""
        self._check_scheme(other)
        mins = [m for m in (self.vmin, other.vmin) if m is not None]
        maxs = [m for m in (self.vmax, other.vmax) if m is not None]
        return HistogramSnapshot(
            [a + b for a, b in zip(self.counts, other.counts)],
            self.count + other.count, self.sum + other.sum,
            min(mins) if mins else None, max(maxs) if maxs else None,
            self.lo, self.hi, self.growth)

    def since(self, baseline: "HistogramSnapshot") -> "HistogramSnapshot":
        """The delta histogram ``self - baseline`` (baseline must be an
        earlier snapshot of the same histogram).  The exact window
        extremes are not recoverable from bucket counts, so min/max
        tighten to the delta's bucket envelope: the lower/upper edge of
        the lowest/highest nonzero delta bucket, intersected with the
        lifetime extremes — a pre-mark spike can no longer surface as
        every later interval's max (the stale-exclusion contract the
        registry's baseline gauges follow).  Under/overflow buckets
        have no finite edge and fall back to the lifetime extreme."""
        self._check_scheme(baseline)
        counts = [max(a - b, 0)
                  for a, b in zip(self.counts, baseline.counts)]
        count = max(self.count - baseline.count, 0)
        # same clamping as the bucket counts: a stale baseline (e.g.
        # taken before a reset) must degrade to zeros, never to a
        # negative sum beside a positive count (durations are >= 0)
        total = max(self.sum - baseline.sum, 0.0) if count else 0.0
        vmin: Optional[float] = None
        vmax: Optional[float] = None
        if count > 0:
            n = len(counts) - 2
            first = next(i for i, c in enumerate(counts) if c)
            last = next(i for i in reversed(range(len(counts)))
                        if counts[i])
            # bucket i spans [lo*g^(i-1), lo*g^i), except values >= hi
            # always overflow — so every finite edge caps at hi
            lo_edge = (None if first == 0
                       else min(self.lo * self.growth ** (first - 1),
                                self.hi))
            hi_edge = (None if last == n + 1
                       else min(self.lo * self.growth ** last, self.hi))
            vmin = (self.vmin if lo_edge is None
                    else lo_edge if self.vmin is None
                    else max(lo_edge, self.vmin))
            vmax = (self.vmax if hi_edge is None
                    else hi_edge if self.vmax is None
                    else min(hi_edge, self.vmax))
        return HistogramSnapshot(counts, count, total,
                                 vmin, vmax, self.lo, self.hi,
                                 self.growth)

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (None when empty); ≤ ~5% relative error
        for in-range values (geometric bucket midpoint), exact at the
        observed min/max (the estimate clamps to them)."""
        if self.count <= 0:
            return None
        q = min(max(float(q), 0.0), 1.0)
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        idx = len(self.counts) - 1
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                idx = i
                break
        n = len(self.counts) - 2
        if idx == 0:
            est = self.vmin if self.vmin is not None else self.lo
        elif idx == n + 1:
            est = self.vmax if self.vmax is not None else self.hi
        else:
            # bucket idx spans [lo*g^(idx-1), lo*g^idx): geometric mid
            est = self.lo * self.growth ** (idx - 0.5)
        if self.vmin is not None:
            est = max(est, self.vmin)
        if self.vmax is not None:
            est = min(est, self.vmax)
        return est

    def fields(self, quantiles: Sequence[float] = DEFAULT_QUANTILES
               ) -> dict:
        """The compact JSON-safe dict the registry surfaces as a
        ``hist/<name>`` entry: count/sum/min/max plus the standard
        quantiles (``p50``..).  Empty histogram → count 0, None stats —
        the tested empty-snapshot shape."""
        out = {
            "count": self.count,
            "sum": round(self.sum, 6),
            "min": None if self.vmin is None else round(self.vmin, 6),
            "max": None if self.vmax is None else round(self.vmax, 6),
        }
        for q in quantiles:
            v = self.quantile(q)
            key = f"p{q * 100:g}".replace(".", "_")
            out[key] = None if v is None else round(v, 6)
        return out


class Histogram:
    """Thread-safe streaming histogram over fixed log-spaced buckets."""

    __slots__ = ("_lock", "_counts", "_count", "_sum", "_min", "_max",
                 "lo", "hi", "growth", "_n", "_log_lo", "_inv_log_g")

    def __init__(self, lo: float = DEFAULT_LO, hi: float = DEFAULT_HI,
                 growth: float = DEFAULT_GROWTH):
        self._n = _num_buckets(lo, hi, growth)
        self.lo = lo
        self.hi = hi
        self.growth = growth
        self._log_lo = math.log(lo)
        self._inv_log_g = 1.0 / math.log(growth)
        self._lock = threading.Lock()
        self._counts = [0] * (self._n + 2)
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, value: float) -> None:
        """Record one value (a latency in the call sites' convention)."""
        v = float(value)
        if v != v:  # NaN never lands in a bucket — drop, don't poison
            return
        if v < self.lo:
            idx = 0
        elif v >= self.hi:
            idx = self._n + 1
        else:
            # floor(log(v/lo)/log(g)); float fudge at an exact boundary
            # moves the value one bucket over — within the error bound
            idx = 1 + int((math.log(v) - self._log_lo) * self._inv_log_g)
            idx = min(max(idx, 1), self._n)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    def snapshot(self) -> HistogramSnapshot:
        """Consistent point-in-time snapshot (mergeable, subtractable)."""
        with self._lock:
            return HistogramSnapshot(
                list(self._counts), self._count, self._sum,
                self._min, self._max, self.lo, self.hi, self.growth)

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (self._n + 2)
            self._count = 0
            self._sum = 0.0
            self._min = None
            self._max = None


def observe(name: str, value: float) -> None:
    """Record ``value`` into the default registry's histogram ``name``
    — the module-level one-liner beside ``registry.inc`` /
    ``registry.set_gauge`` (also re-exported there)."""
    from hyperspace_torch.telemetry import registry as _registry

    _registry.default_registry().observe(name, value)
