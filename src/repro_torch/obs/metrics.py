"""Metrics registry: counters, gauges, log-bucketed histograms (a copy of
`repro.obs.metrics`, which is framework-free).

The live counterpart of the offline ``BENCH_*.json`` artifacts: the same
quantities the paper reports per layer (latency, throughput, traffic) as
continuously-updated process metrics.  Three instrument kinds:

  Counter    monotonically increasing (requests served, autotune misses)
  Gauge      last-write-wins level (queue depth, busy slots)
  Histogram  fixed **log-spaced** buckets — latencies span orders of
             magnitude, so geometric buckets give constant relative error
             for percentile estimates at O(#buckets) memory.

Instruments are get-or-create by ``(name, labels)`` so call sites never
coordinate.  Snapshots are plain JSON-able dicts; `to_prometheus()` emits
the standard text exposition (cumulative ``_bucket{le=...}`` series) for
scrape-based collection.

A process-wide default registry (`REGISTRY`) serves cross-cutting
producers (kernel dispatch, autotune hit/miss); components that need
isolation (one `ServeEngine` per test) build their own instance.
"""

from __future__ import annotations

import bisect
import json
import threading


def log_bucket_bounds(lo: float = 1e-5, hi: float = 100.0,
                      per_decade: int = 5) -> tuple[float, ...]:
    """Geometric bucket upper bounds covering [lo, hi] with `per_decade`
    buckets per decade (an overflow bucket is implicit past the last)."""
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
    bounds, i = [], 0
    while True:
        b = lo * 10.0 ** (i / per_decade)
        bounds.append(b)
        if b >= hi:
            return tuple(bounds)
        i += 1


# seconds-scale latencies: 10 µs … 100 s
DEFAULT_TIME_BUCKETS = log_bucket_bounds(1e-5, 100.0, per_decade=5)
# µs-scale kernel dispatch times: 1 µs … 10 s
US_BUCKETS = log_bucket_bounds(1.0, 1e7, per_decade=4)
# rates (tokens/s etc.): 0.1 … 1e6
RATE_BUCKETS = log_bucket_bounds(0.1, 1e6, per_decade=4)


def _label_suffix(labels: tuple) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


class Counter:
    __slots__ = ("name", "labels", "_v", "_lock")

    def __init__(self, name: str, labels: tuple):
        self.name, self.labels = name, labels
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int | float = 1):
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v


class Gauge:
    __slots__ = ("name", "labels", "_v", "_lock")

    def __init__(self, name: str, labels: tuple):
        self.name, self.labels = name, labels
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self._v = v

    def inc(self, n: float = 1):
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v


class Histogram:
    """Fixed-bound histogram; `bounds` are ascending bucket upper edges,
    with one implicit overflow bucket past the last."""
    __slots__ = ("name", "labels", "bounds", "_counts", "_sum", "_count",
                 "_min", "_max", "_lock")

    def __init__(self, name: str, labels: tuple,
                 bounds: tuple = DEFAULT_TIME_BUCKETS):
        self.name, self.labels = name, labels
        self.bounds = tuple(bounds)
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None
        self._lock = threading.Lock()

    def record(self, v: float):
        idx = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    @property
    def mean(self):
        return self._sum / self._count if self._count else 0.0

    def percentile(self, p: float) -> float:
        """Bucket-resolution quantile (p in [0, 100]): the geometric
        midpoint of the bucket holding the p-th sample, clamped to the
        observed min/max so tails stay honest."""
        with self._lock:
            total = self._count
            if not total:
                return 0.0
            target = max(1, -(-total * p // 100))  # ceil
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= target:
                    if i >= len(self.bounds):       # overflow bucket
                        est = self._max
                    else:
                        hi = self.bounds[i]
                        lo = self.bounds[i - 1] if i else hi / 10.0
                        est = (lo * hi) ** 0.5
                    return min(max(est, self._min), self._max)
            return self._max  # pragma: no cover

    def snapshot(self) -> dict:
        with self._lock:
            return {"count": self._count, "sum": self._sum,
                    "min": self._min, "max": self._max,
                    "mean": self.mean,
                    "buckets": [[b, c] for b, c
                                in zip(self.bounds, self._counts)]
                    + [["+Inf", self._counts[-1]]]} | {
                        f"p{p}": self._percentile_unlocked(p)
                        for p in (50, 90, 99)}

    def _percentile_unlocked(self, p):
        # snapshot() holds the lock; percentile() re-acquires — compute on
        # the already-consistent state instead.
        total = self._count
        if not total:
            return 0.0
        target = max(1, -(-total * p // 100))
        cum = 0
        for i, c in enumerate(self._counts):
            cum += c
            if cum >= target:
                if i >= len(self.bounds):
                    est = self._max
                else:
                    hi = self.bounds[i]
                    lo = self.bounds[i - 1] if i else hi / 10.0
                    est = (lo * hi) ** 0.5
                return min(max(est, self._min), self._max)
        return self._max  # pragma: no cover


class MetricsRegistry:
    """Get-or-create instrument store, snapshot- and Prometheus-exportable."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, labels, **kw):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[1], **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, bounds: tuple = DEFAULT_TIME_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """JSON-able state: {"counters": {...}, "gauges": {...},
        "histograms": {full_name: {count, sum, mean, p50, ...}}}."""
        with self._lock:
            metrics = list(self._metrics.values())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in metrics:
            full = m.name + _label_suffix(m.labels)
            if isinstance(m, Counter):
                out["counters"][full] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][full] = m.value
            else:
                out["histograms"][full] = m.snapshot()
        return out

    def dump_json(self, path: str) -> dict:
        snap = self.snapshot()
        with open(path, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True, default=str)
            f.write("\n")
        return snap

    def to_prometheus(self) -> str:
        """Prometheus text exposition (histograms as cumulative buckets)."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines, typed = [], set()
        for m in sorted(metrics, key=lambda m: m.name):
            kind = {Counter: "counter", Gauge: "gauge"}.get(
                type(m), "histogram")
            if m.name not in typed:
                lines.append(f"# TYPE {m.name} {kind}")
                typed.add(m.name)
            suffix = _label_suffix(m.labels)
            if kind in ("counter", "gauge"):
                lines.append(f"{m.name}{suffix} {m.value}")
                continue
            cum = 0
            base = dict(m.labels)
            for b, c in zip(m.bounds, m._counts):
                cum += c
                lab = _label_suffix(tuple(sorted(
                    {**base, "le": repr(b)}.items())))
                lines.append(f"{m.name}_bucket{lab} {cum}")
            lab = _label_suffix(tuple(sorted(
                {**base, "le": "+Inf"}.items())))
            lines.append(f"{m.name}_bucket{lab} {m.count}")
            lines.append(f"{m.name}_sum{suffix} {m.sum}")
            lines.append(f"{m.name}_count{suffix} {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")


REGISTRY = MetricsRegistry()
