"""Metrics registry: counters, gauges, and fixed-bucket latency
histograms with quantile readout.

A copy of the JAX package's ``obs/metrics.py`` (pure Python): importing it
from there would pull in the rest of ``repro.obs``.

``MetricsRegistry`` is the one observability idiom behind every serving
``stats`` dict — the engines bump named counters (optionally LABELLED,
e.g. ``inc("host.rows", host=h)`` for the per-host breakdown) and expose
a backward-compatible dict VIEW built from the registry, so existing
tests and gates read bit-identical values while new consumers get typed
metrics and latency quantiles.

Histograms are FIXED-BUCKET (geometric edges, default 8 buckets per
decade from 100 ns to 1000 s): observation cost is one bisect + one
increment, memory is constant, and ``quantile(q)`` reads p50/p90/p99 by
linear interpolation inside the covering bucket — the estimate is
guaranteed to land within the true quantile's bucket (≤ ~33 % relative
error at the default resolution; the JAX package's ``tests/test_obs.py``
gates this against a numpy oracle).

THREAD-SAFETY: the registry's write paths (``inc``/``set_gauge``/
``observe``) and its read/maintenance paths take one internal lock —
the engine's per-host drain workers bump counters concurrently, and a
bare ``self.value += v`` is a read-modify-write that drops increments
under interleaving.  The lock is per-OPERATION (a wave bumps a handful
of counters, never one per sample), so the serialized section is a few
dict lookups and an add.  Metric handles returned by ``counter()``/
``gauge()``/``histogram()`` are NOT individually locked — mutate
through the registry when more than one thread writes.
"""
from __future__ import annotations

import threading
from bisect import bisect_right


def default_buckets() -> tuple:
    """Geometric latency-bucket edges: 8 per decade, 1e-7 s … 1e3 s."""
    return tuple(float(10.0 ** (-7 + i / 8)) for i in range(81))


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, v=1):
        self.value += v

    def get(self):
        return self.value


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v):
        self.value = v

    def get(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max and
    interpolated quantiles."""
    __slots__ = ("edges", "counts", "count", "sum", "min", "max")

    def __init__(self, buckets=None):
        edges = tuple(buckets) if buckets is not None else default_buckets()
        if len(edges) < 2 or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError("histogram buckets must be >= 2 strictly "
                             "increasing edges")
        self.edges = edges
        # bucket i holds values in (edges[i-1], edges[i]]; bucket 0 is the
        # underflow (-inf, edges[0]], the last is overflow (edges[-1], inf)
        self.counts = [0] * (len(edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v):
        v = float(v)
        self.counts[bisect_right(self.edges, v)] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def quantile(self, q: float) -> float:
        """Rank-``q`` value estimate: locate the covering bucket, then
        interpolate linearly inside it (clamped to the observed min/max,
        so under- and overflow buckets stay finite)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return float("nan")
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if acc + c >= rank:
                lo = self.edges[i - 1] if 0 < i <= len(self.edges) \
                    else self.min
                hi = self.edges[i] if i < len(self.edges) else self.max
                lo, hi = max(lo, self.min), min(hi, self.max)
                frac = (rank - acc) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            acc += c
        return self.max

    def percentiles(self) -> dict:
        return {"p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}

    def summary(self) -> dict:
        s = {"count": self.count, "sum": self.sum}
        if self.count:
            s.update(min=self.min, max=self.max,
                     mean=self.sum / self.count, **self.percentiles())
        return s


class MetricsRegistry:
    """Named, optionally labelled counters/gauges/histograms.

    ``inc``/``set_gauge``/``observe`` auto-create on first use; ``get``
    reads a raw value (0 / NaN-free default for an absent metric);
    ``drop(prefix)`` removes every metric whose name starts with
    ``prefix``; ``as_dict`` is the flat JSON-able dump."""

    def __init__(self):
        self._metrics: dict[tuple, object] = {}
        # one lock over create + mutate: per-host drain workers write
        # concurrently and counter increments are read-modify-write
        self._lock = threading.Lock()

    @staticmethod
    def _key(name, labels):
        return (name, tuple(sorted(labels.items())))

    def _get_or_make(self, name, labels, cls, *args):
        # callers hold self._lock
        key = self._key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls(*args)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r}{labels or ''} is "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    # -- typed accessors (create on first use) ----------------------------
    def counter(self, name, **labels) -> Counter:
        with self._lock:
            return self._get_or_make(name, labels, Counter)

    def gauge(self, name, **labels) -> Gauge:
        with self._lock:
            return self._get_or_make(name, labels, Gauge)

    def histogram(self, name, buckets=None, **labels) -> Histogram:
        with self._lock:
            return self._get_or_make(name, labels, Histogram, buckets)

    # -- convenience write/read paths -------------------------------------
    def inc(self, name, value=1, **labels):
        with self._lock:
            self._get_or_make(name, labels, Counter).inc(value)

    def set_gauge(self, name, value, **labels):
        with self._lock:
            self._get_or_make(name, labels, Gauge).set(value)

    def observe(self, name, value, **labels):
        with self._lock:
            self._get_or_make(name, labels, Histogram, None).observe(value)

    def get(self, name, default=0, **labels):
        with self._lock:
            m = self._metrics.get(self._key(name, labels))
            return default if m is None else m.get() if not isinstance(
                m, Histogram) else m.summary()

    def drop(self, prefix: str):
        """Remove every metric whose name starts with ``prefix``."""
        with self._lock:
            for key in [k for k in self._metrics
                        if k[0].startswith(prefix)]:
                del self._metrics[key]

    def as_dict(self) -> dict:
        """Flat dump: ``name`` or ``name{k=v,...}`` → value (histograms
        dump their summary incl. p50/p90/p99)."""
        out = {}
        with self._lock:
            items = sorted(self._metrics.items(),
                           key=lambda kv: (kv[0][0], str(kv[0][1])))
        for (name, labels), m in items:
            qual = name if not labels else (
                name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}")
            out[qual] = (m.summary() if isinstance(m, Histogram)
                         else m.get())
        return out
