"""Serving telemetry: clock, metrics registry, and the flight recorder.

Three always-on-cheap building blocks shared by the engine, the
supervisor, and the front-end:

* :class:`Clock` / :class:`FakeClock` — the single timestamp source for
  the engine (every former ``time.perf_counter()`` call site routes
  through ``engine.clock.now()``), so the tracer sees the same timeline
  the latency metrics do and fault-injection tests can substitute a
  deterministic clock.
* :class:`MetricsRegistry` with :class:`Counter`, :class:`Gauge`, and
  fixed-memory log-bucketed :class:`Histogram` — replaces the unbounded
  per-latency Python lists behind ``Engine.stats()``.  A histogram is
  O(1) memory per metric (96 buckets + count/sum/min/max) and O(1) per
  ``observe``; snapshots are cheap enough to take mid-run.  The registry
  renders both a JSON snapshot (the ``{"type": "stats"}`` frontend
  message) and Prometheus text exposition.
* :class:`FlightRecorder` — a bounded ring buffer of recent
  step/fault/scheduler events.  :class:`~repro_torch.serving.supervisor.\
ServingSupervisor` dumps it on every recovery action (step retry,
  retry exhaustion, quarantine, hung-step detection, engine restart) so
  each recovery path leaves a post-mortem artifact.

Metric names map one-to-one onto :class:`~repro_torch.serving.api.EngineStats`
fields — see the catalog in README "Observability" and the field
docstrings in ``api.py``.

This module is pure stdlib (no numpy/torch): it sits inside the lint's
hot-path host-sync reachability cone and must stay sync-free.

Port of ``repro/serving/telemetry.py``, copied with the package renamed.
"""
from __future__ import annotations

import json
import logging
import math
import os
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "Clock", "FakeClock", "Counter", "Gauge", "Histogram",
    "HistogramSnapshot", "MetricsRegistry", "FlightRecorder",
    "EMPTY_PERCENTILES",
]


# ---------------------------------------------------------------------------
# clock


class Clock:
    """Monotonic timestamp source (seconds).  The engine takes all its
    timestamps from one instance so spans, latency histograms, and the
    flight recorder share a timeline."""

    def now(self) -> float:
        return time.perf_counter()


class FakeClock(Clock):
    """Deterministic clock for tests: time moves only via :meth:`advance`.
    Substituting it on a freshly built engine makes queue-wait / TTFT /
    step-gap math exact under injected ``slow``/``hang`` faults."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("FakeClock cannot run backwards")
        self._t += dt
        return self._t


# ---------------------------------------------------------------------------
# scalar metrics


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """A value that can go up and down."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


# ---------------------------------------------------------------------------
# log-bucketed histogram

# The uniform empty-series percentile shape: every latency series renders
# the same four keys whether it holds zero, one, or a million samples
# (satellite fix for the ad-hoc per-field guards in Engine.stats()).
EMPTY_PERCENTILES: Dict[str, float] = {
    "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0,
}

_LO = 1e-3            # smallest resolvable value (1 µs when unit is ms)
_DECADES = 8          # 1e-3 .. 1e5 (ms): covers µs ticks to ~100 s stalls
_PER_DECADE = 12      # ~21% geometric bucket width -> ~10% midpoint error
_NBUCKETS = _DECADES * _PER_DECADE
_LOG_LO = math.log10(_LO)


class HistogramSnapshot:
    """An immutable copy of a histogram's state, cheap to take mid-run.

    Supports the same :meth:`percentiles` rendering as the live
    histogram, so benchmark code can diff two snapshots
    (``Histogram.since``) instead of index-slicing raw sample lists."""

    __slots__ = ("count", "total", "vmin", "vmax", "buckets", "zeros")

    def __init__(self, count: int, total: float, vmin: float, vmax: float,
                 buckets: Tuple[int, ...], zeros: int = 0):
        self.count = count
        self.total = total
        self.vmin = vmin
        self.vmax = vmax
        self.buckets = buckets
        self.zeros = zeros

    def __len__(self) -> int:
        return self.count

    def percentiles(self) -> Dict[str, float]:
        return _render_percentiles(self.count, self.total, self.vmin,
                                   self.vmax, self.buckets, self.zeros)


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
    at O(1) memory and O(1) ``observe``, replacing the unbounded
    ``List[float]`` + ``np.percentile`` pattern.  ``mean``, ``min`` and
    ``max`` are exact, and exact-zero observations are counted outside
    the buckets so a majority-zero series (overlapped dispatch gaps)
    renders its percentiles as 0.0 rather than the bucket floor."""

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

    def snapshot(self) -> HistogramSnapshot:
        return HistogramSnapshot(self.count, self.total, self.vmin,
                                 self.vmax, tuple(self.buckets), self.zeros)

    def since(self, snap: HistogramSnapshot) -> HistogramSnapshot:
        """The delta accumulated after ``snap`` was taken — what the
        async-overlap benchmark used to get by slicing the raw list.
        min/max of a delta are bucket-edge approximations (the exact
        extrema of the suffix are not recoverable from two snapshots)."""
        dcount = self.count - snap.count
        if dcount <= 0:
            return HistogramSnapshot(0, 0.0, math.inf, -math.inf,
                                     (0,) * _NBUCKETS, 0)
        dzeros = self.zeros - snap.zeros
        dbuckets = tuple(a - b for a, b in zip(self.buckets, snap.buckets))
        lo_edge, hi_edge = self.vmin, self.vmax
        if dzeros > 0:
            lo_edge = max(self.vmin, 0.0)
        else:
            for i, c in enumerate(dbuckets):
                if c > 0:
                    lo_edge = max(self.vmin,
                                  10.0 ** (_LOG_LO + i / _PER_DECADE)
                                  if i else 0.0)
                    break
        for i in range(_NBUCKETS - 1, -1, -1):
            if dbuckets[i] > 0:
                hi_edge = min(self.vmax,
                              10.0 ** (_LOG_LO + (i + 1) / _PER_DECADE))
                break
        else:
            if dzeros > 0:
                hi_edge = max(self.vmin, 0.0)
        return HistogramSnapshot(dcount, self.total - snap.total,
                                 lo_edge, hi_edge, dbuckets, dzeros)


# ---------------------------------------------------------------------------
# registry


class MetricsRegistry:
    """Named metrics with Prometheus-text and JSON snapshot rendering.

    Two registration styles:

    * owned objects (:meth:`histogram`, :meth:`counter`, :meth:`gauge`,
      or :meth:`register` for a pre-built instance) — mutated directly
      by the instrumented code;
    * :meth:`register_callback` — a zero-arg callable sampled at render
      time.  The engine uses callbacks for its existing step/robustness
      counters so the hot path keeps plain integer increments.

    Rendering never touches the device: both exporters read host-side
    Python state only."""

    def __init__(self):
        # name -> (kind, help, source); source is a metric object or callable
        self._metrics: Dict[str, Tuple[str, str, object]] = {}

    # -- registration -------------------------------------------------------

    def _add(self, name: str, kind: str, help_: str, source) -> None:
        if name in self._metrics:
            raise ValueError(f"metric {name!r} already registered")
        self._metrics[name] = (kind, help_, source)

    def counter(self, name: str, help_: str = "") -> Counter:
        c = Counter()
        self._add(name, "counter", help_, c)
        return c

    def gauge(self, name: str, help_: str = "") -> Gauge:
        g = Gauge()
        self._add(name, "gauge", help_, g)
        return g

    def histogram(self, name: str, help_: str = "") -> Histogram:
        h = Histogram()
        self._add(name, "histogram", help_, h)
        return h

    def register(self, name: str, metric, help_: str = "") -> None:
        """Adopt an existing Counter/Gauge/Histogram under ``name`` (used
        when supervisor restarts carry histogram objects to a fresh
        engine's registry)."""
        if isinstance(metric, Histogram):
            kind = "histogram"
        elif isinstance(metric, Counter):
            kind = "counter"
        elif isinstance(metric, Gauge):
            kind = "gauge"
        else:
            raise TypeError(f"cannot register {type(metric).__name__}")
        self._add(name, kind, help_, metric)

    def register_callback(self, name: str, kind: str,
                          fn: Callable[[], float], help_: str = "") -> None:
        if kind not in ("counter", "gauge"):
            raise ValueError("callback metrics must be counter or gauge")
        self._add(name, kind, help_, fn)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    # -- rendering ----------------------------------------------------------

    @staticmethod
    def _sample(source):
        if isinstance(source, (Counter, Gauge)):
            return source.value
        if isinstance(source, Histogram):
            return source
        return source()          # callback

    def snapshot(self) -> Dict[str, object]:
        """JSON-serializable snapshot: scalars for counters/gauges, a
        ``{count,sum,min,max,mean,p50,p95,p99}`` dict for histograms."""
        out: Dict[str, object] = {}
        for name in sorted(self._metrics):
            kind, _, source = self._metrics[name]
            v = self._sample(source)
            if kind == "histogram":
                p = v.percentiles()
                out[name] = {
                    "count": v.count,
                    "sum": v.total,
                    "min": v.vmin if v.count else 0.0,
                    "max": v.vmax if v.count else 0.0,
                    **p,
                }
            else:
                out[name] = v
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition.  Histograms render as summaries
        (quantile series + ``_sum``/``_count``) — bucket-accurate export
        is not worth 96 series per latency metric here."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            kind, help_, source = self._metrics[name]
            v = self._sample(source)
            if help_:
                lines.append(f"# HELP {name} {help_}")
            if kind == "histogram":
                lines.append(f"# TYPE {name} summary")
                p = v.percentiles()
                for q, key in (("0.5", "p50"), ("0.95", "p95"),
                               ("0.99", "p99")):
                    lines.append(f'{name}{{quantile="{q}"}} {p[key]:.6g}')
                lines.append(f"{name}_sum {v.total:.6g}")
                lines.append(f"{name}_count {v.count}")
            else:
                lines.append(f"# TYPE {name} {kind}")
                lines.append(f"{name} {v:.6g}" if isinstance(v, float)
                             else f"{name} {v}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# flight recorder


class FlightRecorder:
    """Bounded ring buffer of recent step/fault/scheduler events.

    ``record()`` is O(1) and allocation-light (one small dict per event,
    ring-bounded); ``dump()`` snapshots the ring with a reason tag,
    keeps it in :attr:`dumps`, and — when ``dump_dir`` is set — writes
    ``flight-<seq>-<reason>.json`` to disk.  The supervisor calls
    ``dump()`` on every recovery action so each retry / quarantine /
    hung-step / restart leaves a post-mortem artifact; dumping does NOT
    clear the ring, so consecutive dumps share context.

    ``dump_dir`` is created (parents included) at construction — a typo'd
    or unwritable path fails loudly at startup, not in the middle of the
    first crash being debugged.  Disk failures *during* ``dump()`` are
    logged and swallowed (``io_errors`` counts them): the recorder is a
    post-mortem aid and must never turn a recovery action into a new
    crash — the in-memory dump is always kept regardless.
    """

    def __init__(self, capacity: int = 256,
                 dump_dir: Optional[str] = None,
                 clock: Optional[Clock] = None):
        if capacity <= 0:
            raise ValueError("FlightRecorder capacity must be positive")
        self.capacity = capacity
        self.dump_dir = dump_dir
        if dump_dir:
            os.makedirs(dump_dir, exist_ok=True)
        self.clock = clock or Clock()
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0
        self._dump_seq = 0
        self.dumps: List[dict] = []
        self.io_errors = 0

    def record(self, kind: str, **fields) -> None:
        self._seq += 1
        ev = {"seq": self._seq, "t": self.clock.now(), "kind": kind}
        if fields:
            ev.update(fields)
        self._ring.append(ev)

    def __len__(self) -> int:
        return len(self._ring)

    def events(self) -> List[dict]:
        return list(self._ring)

    def dump(self, reason: str, **context) -> dict:
        self._dump_seq += 1
        d = {
            "reason": reason,
            "dump_seq": self._dump_seq,
            "t": self.clock.now(),
            "events_seen": self._seq,
            "events": list(self._ring),
        }
        if context:
            d["context"] = context
        self.dumps.append(d)
        if self.dump_dir:
            fname = f"flight-{self._dump_seq:04d}-{reason}.json"
            path = os.path.join(self.dump_dir, fname)
            try:
                os.makedirs(self.dump_dir, exist_ok=True)
                with open(path, "w") as f:
                    json.dump(d, f, indent=1)
                d["path"] = path
            except OSError as e:
                # log-and-continue: a full/yanked disk must not escalate a
                # recovery action into a process crash; the in-memory dump
                # above is already kept
                self.io_errors += 1
                d["io_error"] = f"{type(e).__name__}: {e}"
                logging.getLogger(__name__).warning(
                    "flight dump %s not written: %s", path, e)
        return d

    def dump_reasons(self) -> List[str]:
        return [d["reason"] for d in self.dumps]
