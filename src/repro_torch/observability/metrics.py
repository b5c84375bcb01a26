"""Process-wide metrics registry (counters, gauges, histograms — no deps).

The port's own copy of ``repro.observability.metrics`` (the port imports
nothing from ``repro``), cut to what the port uses: the three instruments
and the registry, so the scheduler's ``serving.*`` metrics keep their
names. Incrementing a counter is one attribute add.
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Iterable

#: default latency buckets (seconds)
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)


class Counter:
    """Monotonically increasing integer."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """A value that can go up and down (slots in use, queue depth …)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram: counts per upper bound + a +Inf overflow
    bucket, plus running sum/count."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, buckets: Iterable[float] = DEFAULT_BUCKETS):
        self.bounds = tuple(sorted(buckets))
        self.counts = [0] * (len(self.bounds) + 1)  # last = overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_right(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def to_dict(self) -> dict:
        return {"buckets": list(self.bounds), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}


class MetricsRegistry:
    """Create-or-get named instruments + snapshotting."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    # -- instruments --------------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def histogram(self, name: str,
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(buckets))
        return h

    # -- snapshotting -------------------------------------------------------
    def snapshot(self) -> dict:
        """A JSON-able view of every instrument."""
        return {
            "counters": {name: c.value
                         for name, c in sorted(self._counters.items())},
            "gauges": {name: g.value
                       for name, g in sorted(self._gauges.items())},
            "histograms": {name: h.to_dict()
                           for name, h in sorted(self._histograms.items())},
        }


# ---------------------------------------------------------------------------
# The process-wide registry
# ---------------------------------------------------------------------------

_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def reset_registry() -> MetricsRegistry:
    """Swap in a fresh registry (test/benchmark isolation)."""
    global _REGISTRY
    _REGISTRY = MetricsRegistry()
    return _REGISTRY
