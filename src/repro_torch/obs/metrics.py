"""Metrics registry of the port: counters, gauges, log-bucket histograms.

PyTorch port's copy of ``repro/obs/metrics.py`` (plain Python and numpy;
it imports nothing of the reference). Three metric kinds, all label-aware
and thread-safe under one registry lock:

  * :class:`Counter` — monotone totals with a *windowed* twin: every
    child keeps its cumulative total **and** the delta since the last
    :meth:`MetricsRegistry.roll_window`, so an operator reads both
    "since process start" and "since the last scrape".
  * :class:`Gauge` — last-write-wins point-in-time values (queue depth,
    launch-signature counts, epoch).
  * :class:`Histogram` — fixed log2 latency buckets (1 µs .. ~67 s,
    :data:`BUCKETS_S`), identical for every histogram in the process so
    percentiles from different stages compare and the Prometheus ``le``
    label set never varies. Row-count histograms (coalesce sizes) pass
    their own pow2 bucket bounds.

:func:`percentiles` and :func:`latency_summary_ms` are the one definition
of p50 / p99 / p999 that the smoke's serve lines and the runtime
snapshots share. :class:`WindowedCounter` is the scalar (label-free)
building block the tiered runtime keeps its cache counters in.
"""
from __future__ import annotations

import bisect
import math
import threading

import numpy as np

# One fixed log2 bucket scheme for every latency histogram: 1 µs doubling
# up to ~67 s, then +inf. 27 buckets keeps a histogram child at ~28 ints.
BUCKET_FLOOR_S = 1e-6
N_BUCKETS = 27
BUCKETS_S: tuple[float, ...] = tuple(
    BUCKET_FLOOR_S * (2.0 ** i) for i in range(N_BUCKETS))


def percentiles(samples, qs=(50.0, 99.0)) -> dict[float, float]:
    """Exact percentiles of raw samples: ``{q: value}``.

    The single definition of "p50/p99" shared by the benchmarks and the
    tests (linear interpolation, numpy's default). Empty input -> 0.0s.
    """
    a = np.asarray(list(samples), np.float64)
    if a.size == 0:
        return {float(q): 0.0 for q in qs}
    vals = np.percentile(a, list(qs))
    return {float(q): float(v) for q, v in zip(qs, vals)}


def latency_summary_ms(samples_s, round_to: int = 3) -> dict[str, float]:
    """p50/p99/p999 of latencies in *seconds* -> the benchmark-artifact
    ``{"p50_ms", "p99_ms", "p999_ms"}`` dict (one source of truth for the
    serve/tiered/churn artifacts' percentile fields)."""
    p = percentiles(samples_s, (50.0, 99.0, 99.9))
    return {"p50_ms": round(p[50.0] * 1e3, round_to),
            "p99_ms": round(p[99.0] * 1e3, round_to),
            "p999_ms": round(p[99.9] * 1e3, round_to)}


class WindowedCounter:
    """Label-free cumulative + windowed counter (no lock; callers that
    share one across threads synchronize externally).

    ``total`` accumulates forever; ``window`` is the delta since the last
    :meth:`mark`. :meth:`carry` adopts another instance's state, so a
    rebuilt tiered runtime keeps its cumulative cache counters.
    """

    __slots__ = ("total", "_mark")

    def __init__(self, total: int = 0, mark: int = 0):
        self.total = total
        self._mark = mark

    def add(self, n: int = 1) -> None:
        self.total += n

    @property
    def window(self) -> int:
        return self.total - self._mark

    def mark(self) -> None:
        self._mark = self.total

    def carry(self, other: "WindowedCounter") -> "WindowedCounter":
        self.total, self._mark = other.total, other._mark
        return self


class _Family:
    """Shared label plumbing: one named metric family -> per-label children.

    Children are keyed by the tuple of label *values* in the family's
    declared label-name order; a label-free family has the single child
    key ``()``.
    """

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 label_names: tuple[str, ...]):
        self._registry = registry
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._children: dict[tuple, object] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.label_names)}")
        return tuple(str(labels[k]) for k in self.label_names)

    def _child(self, labels: dict):
        key = self._key(labels)
        child = self._children.get(key)
        if child is None:
            child = self._new_child()
            self._children[key] = child
        return child

    def _new_child(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def items(self):
        """[(label_values_tuple, child)] snapshot-ordered for export."""
        return sorted(self._children.items())


class _CounterChild:
    __slots__ = ("total", "mark")

    def __init__(self):
        self.total = 0.0
        self.mark = 0.0


class Counter(_Family):
    """Monotone counter family with cumulative + windowed reads."""

    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (n={n})")
        with self._registry._lock:
            self._child(labels).total += n

    def get(self, **labels) -> float:
        with self._registry._lock:
            return self._child(labels).total

    def get_window(self, **labels) -> float:
        """Delta since the registry's last :meth:`~MetricsRegistry.roll_window`."""
        with self._registry._lock:
            c = self._child(labels)
            return c.total - c.mark


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, v: float, **labels) -> None:
        with self._registry._lock:
            self._child(labels).value = float(v)

    def get(self, **labels) -> float:
        with self._registry._lock:
            return self._child(labels).value


class _HistogramChild:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)      # +1 = the +inf bucket
        self.sum = 0.0
        self.count = 0


class Histogram(_Family):
    """Fixed-bucket histogram; default buckets are :data:`BUCKETS_S`."""

    kind = "histogram"

    def __init__(self, registry, name, help, label_names,
                 buckets: tuple[float, ...] = BUCKETS_S):
        super().__init__(registry, name, help, label_names)
        self.buckets = tuple(float(b) for b in buckets)

    def _new_child(self):
        return _HistogramChild(len(self.buckets))

    def observe(self, v: float, **labels) -> None:
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)   # first bound >= v
        with self._registry._lock:
            c = self._child(labels)
            c.counts[i] += 1
            c.sum += v
            c.count += 1

    def get(self, **labels) -> dict:
        with self._registry._lock:
            c = self._child(labels)
            return {"count": c.count, "sum": c.sum,
                    "counts": list(c.counts)}

    def percentile(self, q: float, **labels) -> float:
        """Bucket-resolved percentile estimate (upper bound of the bucket
        holding the q-th sample; exact math for benchmarks lives in
        :func:`percentiles` — this is the runtime-snapshot estimator)."""
        with self._registry._lock:
            c = self._child(labels)
            if c.count == 0:
                return 0.0
            rank = math.ceil(q / 100.0 * c.count)
            acc = 0
            for i, n in enumerate(c.counts):
                acc += n
                if acc >= rank:
                    return self.buckets[i] if i < len(self.buckets) \
                        else math.inf
        return math.inf                          # pragma: no cover


class MetricsRegistry:
    """Named metric families behind one lock; the exporter's data source."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _register(self, cls, name, help, labels, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or \
                        fam.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} re-registered as {cls.kind} with "
                        f"labels {tuple(labels)} (was {fam.kind} "
                        f"{fam.label_names})")
                return fam
            fam = cls(self, name, help, tuple(labels), **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = ()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: tuple[str, ...] = ()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = BUCKETS_S) -> Histogram:
        return self._register(Histogram, name, help, labels,
                              buckets=buckets)

    def roll_window(self) -> None:
        """Start a new window: every counter's windowed read resets to 0
        (cumulative totals are untouched)."""
        with self._lock:
            for fam in self._families.values():
                if isinstance(fam, Counter):
                    for c in fam._children.values():
                        c.mark = c.total

    def families(self) -> list[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]
