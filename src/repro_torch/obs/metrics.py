"""Process-global metrics registry: named counters + fixed-bucket histograms.

Mirrors ``repro/obs/metrics.py`` (the port keeps its own copy: it imports
nothing of the reference).  One half of the observability plane; the other
is ``trace.py``.  Every layer of the port's data plane increments NAMED
counters (``obs/names.py`` is the catalog, ``docs/torch_observability.md``
the contract), so a cross-layer question ("how many batches did the scans
of this process stream?") is one ``snapshot()`` away.

  * Stdlib only: nothing here touches torch or the card.
  * Cheap when idle: a counter is one lock and one add; no background
    thread, no export loop.
  * Fixed buckets: a histogram never allocates per sample; a percentile
    interpolates inside its landing bucket, clamped to the observed
    min / max (log-spaced default bounds, four a decade).

One ``threading.Lock`` per instrument: the scan's reader thread and the
caller's thread record into the same registry.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left

__all__ = ["Counter", "Histogram", "MetricsRegistry", "METRICS",
           "DEFAULT_LATENCY_BOUNDS_S"]

#: default bucket upper bounds of a LATENCY histogram: log-spaced, four
#: buckets a decade, 10 microseconds .. 100 seconds (plus the implicit
#: overflow bucket)
DEFAULT_LATENCY_BOUNDS_S = tuple(
    round(10.0 ** (e / 4.0), 12) for e in range(-20, 9))


class Counter:
    """A named monotonic counter (reset through the registry)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int | float = 1) -> None:
        with self._lock:
            self._value += n

    def set(self, value: int | float) -> None:
        """Overwrite the value (a gauge such as ``serve.queue_depth`` set
        from outside); prefer ``inc`` / ``reset``."""
        with self._lock:
            self._value = value

    @property
    def value(self) -> int | float:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"Counter({self.name}={self._value})"


class Histogram:
    """A fixed-bucket histogram: bounded memory, no per-sample allocation.

    ``bounds`` are the bucket UPPER bounds (sorted); one implicit overflow
    bucket takes everything past the last.  ``percentile`` walks the
    cumulative counts and interpolates linearly inside the landing bucket,
    clamped to the observed ``min`` / ``max``."""

    __slots__ = ("name", "bounds", "counts", "count", "sum",
                 "min", "max", "_lock")

    def __init__(self, name: str, bounds: tuple[float, ...] | None = None):
        self.name = name
        bounds = tuple(sorted(bounds if bounds is not None
                              else DEFAULT_LATENCY_BOUNDS_S))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        v = float(value)
        idx = bisect_left(self.bounds, v)
        with self._lock:
            self.counts[idx] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def percentile(self, q: float) -> float:
        """The ``q``-th percentile (0..100) by in-bucket linear
        interpolation; NaN on an empty histogram."""
        if self.count == 0:
            return math.nan
        target = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else self.min
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return lo
                frac = (target - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def reset(self) -> None:
        with self._lock:
            self.counts = [0] * (len(self.bounds) + 1)
            self.count = 0
            self.sum = 0.0
            self.min = math.inf
            self.max = -math.inf

    def summary(self) -> dict[str, float]:
        """Snapshot row: count / sum / min / max / mean / p50 / p99."""
        if self.count == 0:
            return {"count": 0, "sum": 0.0}
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max, "mean": self.mean,
                "p50": self.percentile(50), "p99": self.percentile(99)}


class MetricsRegistry:
    """Named instruments, get-or-create, with snapshot / reset.

    Process-global as ``METRICS``; a subsystem that needs its own
    accounting holds its own instance (the class has no global state)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def histogram(self, name: str,
                  bounds: tuple[float, ...] | None = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name,
                                                Histogram(name, bounds))
        return h

    def counter_values(self) -> dict[str, int | float]:
        """Flat {name: value} of every counter (``TraceSummary.counters``
        are deltas of these)."""
        return {n: c.value for n, c in self._counters.items()}

    def snapshot(self) -> dict[str, object]:
        """Every instrument: counters as scalars, histograms as their
        ``summary()`` rows."""
        out: dict[str, object] = dict(self.counter_values())
        for n, h in self._histograms.items():
            out[n] = h.summary()
        return out

    def reset(self) -> None:
        """Zero every instrument; the instrument objects stay registered,
        so references held by hot paths stay valid."""
        for c in self._counters.values():
            c.reset()
        for h in self._histograms.values():
            h.reset()


#: the process-global registry every layer of the port reports to
METRICS = MetricsRegistry()
