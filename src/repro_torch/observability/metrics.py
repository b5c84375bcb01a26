"""Process-wide metrics registry (counters, gauges, histograms — no deps).

The port's own copy of ``repro.observability.metrics`` (the port imports
nothing from ``repro``), so the scheduler's ``serving.*``, the engine's
``engine.*`` and the store's ``store.*`` metrics keep their names:

* :class:`Counter` / :class:`Gauge` / :class:`Histogram` are the three
  primitive instruments; histograms use fixed bucket boundaries so a
  snapshot is a plain JSON document that merges across OS processes by
  summation.
* :class:`StatsDict` is a real ``dict`` subclass (``stats["commits"] += 1``
  keeps working in the hot paths) that registers itself with the registry
  so its live values appear in ``snapshot()`` under a prefix
  (``store.commits``, …).
* :func:`merge_snapshots` combines snapshots from many producers into one.

Incrementing a counter is one attribute add — cheap enough for hot paths
without any enable/disable gate.
"""

from __future__ import annotations

import threading
import weakref
from bisect import bisect_right
from typing import Any, Iterable, Mapping

#: default latency buckets (seconds) — spans sub-ms store commits up to
#: multi-second scheduler waits
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

    def inc(self, n: float = 1) -> None:
        self.value += n

    def dec(self, n: float = 1) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket histogram: counts per upper bound + a +Inf overflow
    bucket, plus running sum/count for mean latency."""

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

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_dict(self) -> dict:
        return {"buckets": list(self.bounds), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}


class StatsDict(dict):
    """A plain dict of integer counters that is *also* visible to the
    metrics registry under ``<prefix>.<key>``. Existing call sites keep
    their ``stats["x"] += 1`` idiom (and ``isinstance(stats, dict)``
    checks) unchanged; the registry reads the live values at snapshot
    time, summing across instances that share a prefix (e.g. several
    open stores in one process)."""

    # identity hash: dict subclasses are unhashable by default, but the
    # registry's WeakSet needs to hold (weak) references to instances
    __hash__ = object.__hash__

    def __init__(self, prefix: str, initial: Mapping[str, int] | None = None,
                 registry: "MetricsRegistry | None" = None):
        super().__init__(initial or {})
        self.prefix = prefix
        (registry or get_registry())._register_stats(self)


class MetricsRegistry:
    """Create-or-get named instruments + snapshotting."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        # weak: a StatsDict dies with its owning store/scheduler/transport
        self._stats_producers: "weakref.WeakSet[StatsDict]" = weakref.WeakSet()

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

    def _register_stats(self, stats: StatsDict) -> None:
        self._stats_producers.add(stats)

    # -- snapshotting -------------------------------------------------------
    def snapshot(self) -> dict:
        """A JSON-able view of every instrument, with StatsDict producers
        folded in as ``<prefix>.<key>`` counters (summed per name)."""
        counters: dict[str, int] = {
            name: c.value for name, c in sorted(self._counters.items())}
        for stats in list(self._stats_producers):
            for key, val in stats.items():
                name = f"{stats.prefix}.{key}"
                counters[name] = counters.get(name, 0) + int(val)
        return {
            "counters": dict(sorted(counters.items())),
            "gauges": {name: g.value
                       for name, g in sorted(self._gauges.items())},
            "histograms": {name: h.to_dict()
                           for name, h in sorted(self._histograms.items())},
        }


def merge_snapshots(snapshots: Iterable[Mapping[str, Any]]) -> dict:
    """Merge many ``snapshot()`` documents (e.g. one per daemon worker):
    counters and histogram counts sum; gauges keep the last value seen."""
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in snapshots:
        if not isinstance(snap, Mapping):
            continue
        for name, v in (snap.get("counters") or {}).items():
            out["counters"][name] = out["counters"].get(name, 0) + v
        for name, v in (snap.get("gauges") or {}).items():
            out["gauges"][name] = v
        for name, h in (snap.get("histograms") or {}).items():
            acc = out["histograms"].get(name)
            if acc is None or acc.get("buckets") != h.get("buckets"):
                out["histograms"][name] = {
                    "buckets": list(h.get("buckets", [])),
                    "counts": list(h.get("counts", [])),
                    "sum": h.get("sum", 0.0), "count": h.get("count", 0)}
            else:
                acc["counts"] = [a + b for a, b in
                                 zip(acc["counts"], h.get("counts", []))]
                acc["sum"] += h.get("sum", 0.0)
                acc["count"] += h.get("count", 0)
    out["counters"] = dict(sorted(out["counters"].items()))
    return out


# ---------------------------------------------------------------------------
# The process-wide registry
# ---------------------------------------------------------------------------

_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def reset_registry() -> MetricsRegistry:
    """Swap in a fresh registry (test/benchmark isolation). StatsDict
    producers created against the old registry keep working as plain
    dicts; new ones register here."""
    global _REGISTRY
    _REGISTRY = MetricsRegistry()
    return _REGISTRY
