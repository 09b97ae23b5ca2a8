"""Process-wide metrics registry: counters, gauges, latency histograms.

The port's own copy of ``repro.obs.metrics`` (stdlib only, the same
classes and behaviour).

The consistency contract (pinned by the serving tests' concurrency
battery): every metric belonging to one registry mutates under the
registry's single re-entrant lock, and ``snapshot()`` reads them all
under that same lock — so a snapshot taken mid-flight is internally
consistent (e.g. ``hits + misses + in_flight == submitted`` holds in
EVERY snapshot, never just at quiescence).  Multi-metric updates that
must be atomic as a group run inside ``with registry.locked():``.

Histograms keep raw observations (bounded ring of the most recent
``max_samples``) so percentiles are exact over the retained window —
right for serving latencies at campaign granularity, not for per-element
hot loops.
"""
from __future__ import annotations

import math
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
]


class Counter:
    """Monotonically increasing count."""

    def __init__(self, lock):
        self._lock = lock
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def snapshot(self):
        return self._value  # caller holds the registry lock


class Gauge:
    """Point-in-time level (queue depth, in-flight campaigns)."""

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self):
        return self._value


class Histogram:
    """Latency histogram with exact percentiles over a bounded window."""

    def __init__(self, lock, max_samples: int = 4096):
        self._lock = lock
        self._max = max_samples
        self._samples = []
        self._next = 0  # ring-buffer write head once the window is full
        self._count = 0
        self._sum = 0.0

    def observe(self, v: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += v
            if len(self._samples) < self._max:
                self._samples.append(v)
            else:
                self._samples[self._next] = v
                self._next = (self._next + 1) % self._max

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile (p in [0, 100]) over the window; 0.0
        when empty."""
        with self._lock:
            return self._percentile_locked(p)

    def _percentile_locked(self, p: float) -> float:
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        rank = max(1, math.ceil(p / 100.0 * len(s)))  # nearest-rank
        return s[min(rank, len(s)) - 1]

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self):
        return {
            "count": self._count,
            "sum": self._sum,
            "mean": (self._sum / self._count) if self._count else 0.0,
            "p50": self._percentile_locked(50),
            "p90": self._percentile_locked(90),
            "p99": self._percentile_locked(99),
            "max": max(self._samples) if self._samples else 0.0,
        }


class MetricsRegistry:
    """Named metrics sharing ONE lock; ``snapshot()`` is consistent."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics = {}

    def _get(self, name, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(self._lock, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is {type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, max_samples: int = 4096) -> Histogram:
        return self._get(name, Histogram, max_samples=max_samples)

    def locked(self):
        """Context manager: hold the registry lock across a multi-metric
        update so no snapshot can observe it half-applied."""
        return self._lock

    def snapshot(self) -> dict:
        """One consistent view of every registered metric."""
        with self._lock:
            return {name: m.snapshot() for name, m in self._metrics.items()}


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry (components may also own private ones —
    ``SimilarityService`` does, so tests and services never share state)."""
    return _DEFAULT
