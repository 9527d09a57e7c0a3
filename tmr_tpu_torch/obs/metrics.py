"""Named counters, gauges and histograms (counterpart of ``tmr_tpu/obs/metrics.py``).

The serving engine keeps every count here: each ``ServeEngine`` has a registry of its
own (``MetricsRegistry()``), and :func:`get_registry` is the process-wide one that
cross-cutting facts record into (the ``nvcc`` builds of ``obs/compile.py``). Instruments
are thread-safe and cheap: a counter is a number behind a lock, a histogram fixed
exponential buckets plus count, sum, min and max. Dotted names are the namespace
(``serve.submitted``, ``serve.request_latency_s``, ``serve.cache.result.hits``), letter
for letter the JAX package's. ``snapshot()`` is one ``metrics_report/v1`` document
(``tmr_tpu_torch/diagnostics.validate_metrics_report``).
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Optional, Sequence, Tuple

from tmr_tpu_torch.diagnostics import METRICS_REPORT_SCHEMA

#: default histogram bounds: exponential from 0.1 ms to ~210 s — wide
#: enough for span/request/shard latencies at both CPU-smoke and
#: production geometry without per-site tuning. Observations beyond the
#: last bound land in the overflow bucket (counts has len(bounds)+1).
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(1e-4 * 2.0 ** i for i in range(21))


class Counter:
    """Monotone counter. ``inc`` accepts any non-negative number
    (float-valued totals, e.g. accumulated seconds, are legal)."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max.

    Buckets are upper bounds (``le``); an observation lands in the first
    bucket whose bound is >= the value, or the overflow bucket past the
    last bound. Quantiles interpolate linearly inside the winning bucket:
    coarse by construction, the trade for O(1) memory under unbounded
    traffic (the spans of ``obs/tracing.py`` keep exact samples).
    """

    __slots__ = ("_lock", "bounds", "_counts", "count", "sum", "min", "max")

    def __init__(self, buckets: Optional[Sequence[float]] = None) -> None:
        bounds = tuple(float(b) for b in (buckets or DEFAULT_BUCKETS))
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError("histogram buckets must be strictly ascending")
        self._lock = threading.Lock()
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (0..1) by linear interpolation within
        the winning bucket, clamped to the observed min/max."""
        with self._lock:
            if self.count == 0:
                return 0.0
            target = q * self.count
            seen = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                if seen + c >= target:
                    lo = self.bounds[i - 1] if i > 0 else (self.min or 0.0)
                    hi = (
                        self.bounds[i] if i < len(self.bounds)
                        else (self.max if self.max is not None else lo)
                    )
                    lo = max(lo, self.min or lo)
                    hi = min(hi, self.max if self.max is not None else hi)
                    frac = (target - seen) / c
                    return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                seen += c
            return self.max or 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "buckets_le": list(self.bounds),
                "counts": list(self._counts),
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
            }


class MetricsRegistry:
    """Named instrument store. ``counter``/``gauge``/``histogram`` create
    on first use and return the existing instrument after; a name can hold
    exactly one instrument kind (a typo'd re-registration raises instead
    of silently forking the data)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = factory()
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} is {type(inst).__name__}, "
                    f"not {cls.__name__}"
                )
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(name, Histogram, lambda: Histogram(buckets))

    def snapshot(self) -> dict:
        """The ``metrics_report/v1`` document: every counter, gauge, and
        histogram (with coarse p50/p95/p99) at this instant."""
        with self._lock:
            items = sorted(self._instruments.items())
        counters: Dict[str, object] = {}
        gauges: Dict[str, float] = {}
        histograms: Dict[str, dict] = {}
        for name, inst in items:
            if isinstance(inst, Counter):
                counters[name] = inst.value
            elif isinstance(inst, Gauge):
                gauges[name] = inst.value
            elif isinstance(inst, Histogram):
                snap = inst.snapshot()
                snap["p50"] = inst.quantile(0.50)
                snap["p95"] = inst.quantile(0.95)
                snap["p99"] = inst.quantile(0.99)
                histograms[name] = snap
        return {
            "schema": METRICS_REPORT_SCHEMA,
            "counters": counters,
            "gauges": gauges,
            "histograms": histograms,
        }


#: the process-wide registry cross-cutting facts record into (the compile events of
#: ``obs/compile.py``); components that need isolated counts (each ServeEngine)
#: construct their own MetricsRegistry
_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _DEFAULT

