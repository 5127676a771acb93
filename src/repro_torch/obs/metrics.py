"""Thread-safe engine metrics: counters, gauges, histograms, epoch snapshots.

Port of ``repro.obs.metrics``, whole: the same names and the same
``snapshot()`` shape, so the port's counters reconcile against the JAX
package's in the tests. Host-only. The result cache counts its serves,
misses and evictions here (``cache.*``), the recovery loop its injected
faults, retries and demotions (``faults.*``, ``retry.*``), the circuit
breaker its trips and probes (``breaker.*``) and the engine its requests
and bytes (``engine.*``).

- One coarse lock per registry. Updates are a dict lookup and a float add;
  at engine rates (a few hundred updates a query) contention is nil, and
  the coarse lock keeps ``snapshot()`` consistent.
- ``epoch()`` returns counter *deltas* since the previous epoch plus the
  current gauges and histogram summaries, then advances the epoch: the
  poll-style API a load balancer wants, without writers resetting
  anything.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "Metrics",
           "get_metrics", "set_metrics"]


class Counter:
    """Monotonically increasing total (thread-safe via the registry lock)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.value = 0.0
        self._lock = lock

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value (e.g. queue depth, free cores)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Log2-bucketed distribution with exact count/sum/min/max.

    Buckets are powers of two: bucket ``i`` holds values in
    ``[2**(i-1), 2**i)`` (bucket 0 holds values < 1). Good enough
    resolution for latencies and byte sizes without per-observation
    allocation."""

    __slots__ = ("name", "count", "total", "vmin", "vmax", "buckets", "_lock")

    N_BUCKETS = 64

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.buckets = [0] * self.N_BUCKETS
        self._lock = lock

    def observe(self, v: float) -> None:
        v = float(v)
        b = 0 if v < 1.0 else min(self.N_BUCKETS - 1, int(v).bit_length())
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v
            self.buckets[b] += 1

    def summary(self) -> Dict:
        # caller holds the registry lock (or accepts a racy read)
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": None, "max": None,
                    "mean": None}
        return {"count": self.count, "sum": self.total, "min": self.vmin,
                "max": self.vmax, "mean": self.total / self.count}


class Metrics:
    """Registry of named counters/gauges/histograms with epoch snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._epoch_base: Dict[str, float] = {}
        self._epoch_n = 0

    # --------------------------------------------------------- factories
    def counter(self, name: str) -> Counter:
        with self._lock:
            m = self._counters.get(name)
            if m is None:
                m = self._counters[name] = Counter(name, self._lock)
        return m

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            m = self._gauges.get(name)
            if m is None:
                m = self._gauges[name] = Gauge(name, self._lock)
        return m

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            m = self._histograms.get(name)
            if m is None:
                m = self._histograms[name] = Histogram(name, self._lock)
        return m

    # ----------------------------------------------------------- reads
    def snapshot(self) -> Dict:
        """Consistent point-in-time view of every metric (absolute values)."""
        with self._lock:
            return {
                "counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {n: g.value for n, g in self._gauges.items()},
                "histograms": {n: h.summary()
                               for n, h in self._histograms.items()},
            }

    def epoch(self) -> Dict:
        """Counter deltas since the last ``epoch()`` call + current gauges
        and histogram summaries; advances the epoch marker."""
        with self._lock:
            self._epoch_n += 1
            deltas = {}
            for n, c in self._counters.items():
                deltas[n] = c.value - self._epoch_base.get(n, 0.0)
                self._epoch_base[n] = c.value
            return {
                "epoch": self._epoch_n,
                "counters": deltas,
                "gauges": {n: g.value for n, g in self._gauges.items()},
                "histograms": {n: h.summary()
                               for n, h in self._histograms.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._epoch_base.clear()
            self._epoch_n = 0

    def names(self) -> List[str]:
        with self._lock:
            return sorted([*self._counters, *self._gauges, *self._histograms])


_metrics = Metrics()


def get_metrics() -> Metrics:
    """The process-wide default registry."""
    return _metrics


def set_metrics(metrics: Optional[Metrics]) -> Metrics:
    """Install a registry (None -> fresh one); returns the previous one."""
    global _metrics
    prev = _metrics
    _metrics = metrics if metrics is not None else Metrics()
    return prev
