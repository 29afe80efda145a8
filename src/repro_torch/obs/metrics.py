"""Process-wide metrics registry: counters, gauges, log-bucketed histograms.

The schedstat analogue for this repo: every execution layer (DES oracle,
tick simulator, serving engine, train loop) publishes through one registry
so policy comparisons are backed by exportable numbers instead of ad-hoc
printouts.

Cost model:
  * Instruments (``Counter``/``Gauge``/``Histogram``) always record — they
    are plain objects owned by whoever created them (e.g. a ``SchedStats``).
  * The *module-level* helpers (``counter()``/``gauge()``/``histogram()``)
    are the hot-path API: when telemetry is disabled they hand back a shared
    null instrument, so an instrumented call site costs one branch.

Histograms are log-bucketed (geometric bucket edges): a fixed per-bucket
relative width buys O(1) record cost and quantiles within ~half a bucket of
numpy's over any dynamic range — the same trick as hdrhistogram / Prometheus
native histograms.

Copy of ``repro.obs.metrics``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, Optional

_ENABLED = False


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def to_dict(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_dict(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Log-bucketed histogram with interpolated quantiles.

    Bucket ``i`` covers ``[lo * growth**i, lo * growth**(i+1))``; the default
    growth of 2**(1/8) (8 buckets per doubling) bounds quantile relative
    error at ~4.4 % (half a bucket, geometric midpoint read-out).  Values
    ``<= 0`` land in a dedicated zero bucket; values below ``lo`` clamp to
    bucket 0.  Counts are floats so aggregate paths (e.g. the simulator's
    per-tick voluntary-switch rates) can record fractional weights.
    """

    __slots__ = ("name", "lo", "growth", "_log_growth", "buckets", "zero",
                 "count", "sum", "min", "max")

    def __init__(self, name: str = "", lo: float = 1e-9,
                 growth: float = 2.0 ** 0.125):
        self.name = name
        self.lo = lo
        self.growth = growth
        self._log_growth = math.log(growth)
        self.buckets: Dict[int, float] = {}
        self.zero = 0.0
        self.count = 0.0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _index(self, x: float) -> int:
        return max(0, int(math.log(x / self.lo) / self._log_growth))

    def record(self, x: float, weight: float = 1.0) -> None:
        x = float(x)
        self.count += weight
        self.sum += x * weight
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if x <= 0.0:
            self.zero += weight
            return
        i = self._index(x)
        self.buckets[i] = self.buckets.get(i, 0.0) + weight

    def record_many(self, xs: Iterable[float]) -> None:
        """Vectorised record for numpy arrays (used by the tick simulator)."""
        import numpy as np

        xs = np.asarray(xs, dtype=float).ravel()
        if xs.size == 0:
            return
        self.count += xs.size
        self.sum += float(xs.sum())
        self.min = min(self.min, float(xs.min()))
        self.max = max(self.max, float(xs.max()))
        pos = xs[xs > 0.0]
        self.zero += float(xs.size - pos.size)
        if pos.size:
            idx = np.maximum(
                0, (np.log(pos / self.lo) / self._log_growth).astype(np.int64)
            )
            uniq, cnt = np.unique(idx, return_counts=True)
            for i, c in zip(uniq.tolist(), cnt.tolist()):
                self.buckets[i] = self.buckets.get(i, 0.0) + c

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def pct(self, q: float) -> float:
        """Percentile in [0, 100] (numpy convention), geometric-midpoint
        read-out clamped to the observed [min, max]."""
        if self.count <= 0:
            return float("nan")
        rank = self.count * q / 100.0
        if rank <= self.zero:
            return max(0.0, self.min) if self.min < math.inf else 0.0
        cum = self.zero
        for i in sorted(self.buckets):
            cum += self.buckets[i]
            if cum >= rank - 1e-12:
                edge_lo = self.lo * self.growth ** i
                edge_hi = edge_lo * self.growth
                mid = math.sqrt(edge_lo * edge_hi)
                return min(max(mid, self.min), self.max)
        return self.max

    @property
    def p50(self) -> float:
        return self.pct(50)

    @property
    def p95(self) -> float:
        return self.pct(95)

    @property
    def p99(self) -> float:
        return self.pct(99)

    def merge(self, other: "Histogram") -> "Histogram":
        assert abs(other.growth - self.growth) < 1e-12 and other.lo == self.lo
        for i, c in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0.0) + c
        self.zero += other.zero
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def to_dict(self) -> dict:
        return {
            "type": "histogram",
            "lo": self.lo,
            "growth": self.growth,
            "zero": self.zero,
            "count": self.count,
            "sum": self.sum,
            "min": None if self.min == math.inf else self.min,
            "max": None if self.max == -math.inf else self.max,
            "buckets": {str(i): c for i, c in self.buckets.items()},
            "p50": self.pct(50),
            "p95": self.pct(95),
            "p99": self.pct(99),
        }

    @classmethod
    def from_dict(cls, d: dict, name: str = "") -> "Histogram":
        h = cls(name, lo=d["lo"], growth=d["growth"])
        h.zero = d["zero"]
        h.count = d["count"]
        h.sum = d["sum"]
        h.min = math.inf if d["min"] is None else d["min"]
        h.max = -math.inf if d["max"] is None else d["max"]
        h.buckets = {int(i): c for i, c in d["buckets"].items()}
        return h


class _NullInstrument:
    """Shared no-op stand-in returned by the module helpers when disabled."""

    __slots__ = ()
    name = ""
    value = 0.0
    count = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def record(self, x: float, weight: float = 1.0) -> None:
        pass

    def record_many(self, xs) -> None:
        pass


NULL = _NullInstrument()


class Registry:
    """Name -> instrument map; one process-wide instance (``registry()``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        with self._lock:
            return {name: m.to_dict() for name, m in self._metrics.items()}

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name) if _ENABLED else NULL  # type: ignore


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name) if _ENABLED else NULL  # type: ignore


def histogram(name: str) -> Histogram:
    return _REGISTRY.histogram(name) if _ENABLED else NULL  # type: ignore
