"""Serving telemetry: the engine's clock and its latency histograms.

The part of ``repro/serving/telemetry.py`` the port's engine uses, copied
unchanged: :class:`Clock`, the engine's single timestamp source, and the
fixed-memory log-bucketed :class:`Histogram` behind ``Engine.stats()``.  The
metrics registry (counters, gauges, Prometheus text) and the flight recorder
come with a later slice.

This module is pure stdlib (no numpy/torch).
"""
from __future__ import annotations

import math
import time
from typing import Dict

__all__ = ["Clock", "Histogram", "EMPTY_PERCENTILES"]


# ---------------------------------------------------------------------------
# clock


class Clock:
    """Monotonic timestamp source (seconds).  The engine takes all its
    timestamps from one instance so its latency histograms share a
    timeline."""

    def now(self) -> float:
        return time.perf_counter()


# ---------------------------------------------------------------------------
# log-bucketed histogram

# The uniform empty-series percentile shape: every latency series renders
# the same four keys whether it holds zero, one, or a million samples.
EMPTY_PERCENTILES: Dict[str, float] = {
    "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0,
}

_LO = 1e-3            # smallest resolvable value (1 µs when unit is ms)
_DECADES = 8          # 1e-3 .. 1e5 (ms): covers µs ticks to ~100 s stalls
_PER_DECADE = 12      # ~21% geometric bucket width -> ~10% midpoint error
_NBUCKETS = _DECADES * _PER_DECADE
_LOG_LO = math.log10(_LO)


def _bucket_index(v: float) -> int:
    if v <= _LO:
        return 0
    i = int((math.log10(v) - _LOG_LO) * _PER_DECADE)
    return i if i < _NBUCKETS else _NBUCKETS - 1


def _bucket_mid(i: int) -> float:
    # geometric midpoint of bucket i's [lo, hi) edges
    return 10.0 ** (_LOG_LO + (i + 0.5) / _PER_DECADE)


def _render_percentiles(count: int, total: float, vmin: float, vmax: float,
                        buckets, zeros: int = 0) -> Dict[str, float]:
    if count == 0:
        return dict(EMPTY_PERCENTILES)
    mean = total / count
    if count == 1:
        v = vmin
        return {"mean": mean, "p50": v, "p95": v, "p99": v}
    out = {"mean": mean}
    for key, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
        rank = q * (count - 1)           # same convention as np.percentile
        target = int(rank) + 1           # 1-based sample index to reach
        # exact-zero observations sit below every bucket; a rank landing
        # inside them renders 0.0 exactly (overlapped dispatch gaps are
        # zero by construction and must not inflate to the bucket floor)
        if target <= zeros:
            out[key] = 0.0
            continue
        cum = zeros
        val = vmax
        for i, c in enumerate(buckets):
            cum += c
            if cum >= target:
                val = _bucket_mid(i)
                break
        # clamp the bucket-midpoint estimate to the observed range so
        # degenerate series (all-equal samples) come out exact
        out[key] = min(max(val, vmin), vmax)
    return out


class Histogram:
    """Fixed-memory log-bucketed histogram (unit-agnostic; the serving
    metrics use milliseconds).

    96 geometric buckets spanning 1e-3..1e5 with ~21% width give ~10%
    worst-case quantile error — plenty for p50/p95/p99 latency lines —
    at O(1) memory and O(1) ``observe``.  ``mean``, ``min`` and ``max``
    are exact, and exact-zero observations are counted outside the
    buckets so a majority-zero series renders its percentiles as 0.0
    rather than the bucket floor."""

    __slots__ = ("count", "total", "vmin", "vmax", "buckets", "zeros")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.buckets = [0] * _NBUCKETS
        self.zeros = 0              # exact-zero observations, kept exact

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v <= 0.0:
            self.zeros += 1
        else:
            self.buckets[_bucket_index(v)] += 1

    def __len__(self) -> int:
        return self.count

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentiles(self) -> Dict[str, float]:
        """The canonical ``{"mean","p50","p95","p99"}`` rendering used by
        :meth:`Engine.stats`; empty series render all-zero uniformly."""
        return _render_percentiles(self.count, self.total, self.vmin,
                                   self.vmax, self.buckets, self.zeros)
