"""Flight-recorder metrics core: counters, gauges, log-bucket histograms, spans.

A copy of ``repro.telemetry.registry`` (the port imports nothing of
``repro``); it uses only ``math``, ``threading`` and ``time``. One
:class:`Registry` holds every labeled series a component emits: the serving
engine's ``serve.*`` counters (``SvmServer.stats()`` is a view over them)
and the kernel launch accounting of ``ops.record_launch``. A process-wide
default registry (:func:`default_registry`) backs the module-level
conveniences; components that need isolation (one
:class:`~repro_torch.serve.engine.SvmServer` per test) hold their own.

* **Bounded memory**: :class:`Histogram` is HDR-style log-bucketed, a fixed
  geometric ladder of ``n_buckets`` buckets (growth factor ``growth``).
  Quantiles come back as bucket upper edges: for a value inside the ladder
  the reported ``q̂`` brackets the exact quantile as ``q ≤ q̂ ≤ q·growth``.
* **Thread-safe**: every update takes the registry's lock.
"""
from __future__ import annotations

import math
import threading
import time

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Span",
    "Registry",
    "default_registry",
    "counter",
    "gauge",
    "histogram",
    "span",
    "reset",
]

# Default histogram ladder: 10 µs lowest bucket, ~19% relative resolution
# (2^(1/4) growth), 128 buckets → covers ~10 µs .. ~1 hour in seconds units.
DEFAULT_BASE = 1e-5
DEFAULT_GROWTH = 2.0 ** 0.25
DEFAULT_BUCKETS = 128


class Counter:
    """Monotonically non-decreasing series (queries served, bytes moved)."""

    kind = "counter"

    def __init__(self, name: str, labels: dict, lock: threading.RLock):
        self.name = name
        self.labels = dict(labels)
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> "Counter":
        """Add ``n`` (must be >= 0) to the counter; returns self."""
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        with self._lock:
            self._value += n
        return self

    @property
    def value(self) -> float:
        """Current accumulated total."""
        return self._value


class Gauge:
    """Point-in-time series (last mass retention, jit-cache size)."""

    kind = "gauge"

    def __init__(self, name: str, labels: dict, lock: threading.RLock):
        self.name = name
        self.labels = dict(labels)
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> "Gauge":
        """Overwrite the gauge with ``v``; returns self."""
        with self._lock:
            self._value = float(v)
        return self

    def inc(self, n: float = 1.0) -> "Gauge":
        """Add ``n`` (either sign) to the gauge; returns self."""
        with self._lock:
            self._value += n
        return self

    @property
    def value(self) -> float:
        """Current gauge reading."""
        return self._value


class Histogram:
    """Bounded log-bucketed (HDR-style) histogram.

    Bucket 0 holds ``(-inf, base]``; bucket ``j >= 1`` holds
    ``(base·growth^(j-1), base·growth^j]``; the last bucket is the overflow
    catch-all. Memory is a fixed ``n_buckets`` integer array regardless of
    observation count — the bounded replacement for keeping raw latency
    lists. Exact ``count`` / ``sum`` / ``min`` / ``max`` ride alongside, so
    means are exact and the overflow quantile can return the true max.
    """

    kind = "histogram"

    def __init__(self, name: str, labels: dict, lock: threading.RLock, *,
                 base: float = DEFAULT_BASE, growth: float = DEFAULT_GROWTH,
                 n_buckets: int = DEFAULT_BUCKETS):
        if base <= 0 or growth <= 1.0 or n_buckets < 2:
            raise ValueError(
                f"need base > 0, growth > 1, n_buckets >= 2; got "
                f"({base}, {growth}, {n_buckets})")
        self.name = name
        self.labels = dict(labels)
        self._lock = lock
        self.base = float(base)
        self.growth = float(growth)
        self.n_buckets = int(n_buckets)
        self._log_growth = math.log(self.growth)
        self._counts = [0] * self.n_buckets
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    # -------------------------------------------------------------- buckets

    def bucket_index(self, v: float) -> int:
        """Index of the bucket ``v`` lands in (edges belong to the bucket
        they bound above; everything past the ladder clamps to overflow)."""
        if v <= self.base:
            return 0
        idx = 1 + int(math.floor(
            math.log(v / self.base) / self._log_growth - 1e-12))
        return min(idx, self.n_buckets - 1)

    def upper_edge(self, j: int) -> float:
        """Upper bound of bucket ``j`` (``inf`` for the overflow bucket)."""
        if j >= self.n_buckets - 1:
            return math.inf
        return self.base if j == 0 else self.base * self.growth ** j

    # ------------------------------------------------------------- updates

    def observe(self, v: float) -> "Histogram":
        """Record one observation; returns self."""
        v = float(v)
        with self._lock:
            self._counts[self.bucket_index(v)] += 1
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
        return self

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s observations into this histogram (in place).

        Requires identical bucket ladders. Bucket counts add exactly, so
        merging is associative and commutative on the counts (tests pin
        associativity); ``sum`` adds in float.
        """
        if (other.base, other.growth, other.n_buckets) != (
                self.base, self.growth, self.n_buckets):
            raise ValueError(
                f"cannot merge histograms with different ladders: "
                f"({self.base}, {self.growth}, {self.n_buckets}) vs "
                f"({other.base}, {other.growth}, {other.n_buckets})")
        with self._lock:
            for j, c in enumerate(other._counts):
                self._counts[j] += c
            self._count += other._count
            self._sum += other._sum
            self._min = min(self._min, other._min)
            self._max = max(self._max, other._max)
        return self

    def copy(self) -> "Histogram":
        """Deep copy (fresh lock) — lets tests build pure merge expressions."""
        out = Histogram(self.name, self.labels, threading.RLock(),
                        base=self.base, growth=self.growth,
                        n_buckets=self.n_buckets)
        out._counts = list(self._counts)
        out._count, out._sum = self._count, self._sum
        out._min, out._max = self._min, self._max
        return out

    # -------------------------------------------------------------- reads

    @property
    def count(self) -> int:
        """Total observations recorded."""
        return self._count

    @property
    def sum(self) -> float:
        """Exact sum of all observations."""
        return self._sum

    @property
    def min(self) -> float:
        """Exact minimum observation (``inf`` when empty)."""
        return self._min

    @property
    def max(self) -> float:
        """Exact maximum observation (``-inf`` when empty)."""
        return self._max

    def quantile(self, q: float) -> float:
        """Upper bucket edge covering the ``q``-quantile observation.

        For values within the ladder ``(base, top)`` the result brackets the
        exact quantile within one growth factor; bucket-0 quantiles report
        ``base`` and overflow quantiles report the exact tracked max. NaN
        when empty.
        """
        if self._count == 0:
            return math.nan
        q = min(max(q, 0.0), 1.0)
        target = max(1, math.ceil(q * self._count))
        cum = 0
        for j, c in enumerate(self._counts):
            cum += c
            if cum >= target:
                return self._max if j == self.n_buckets - 1 else self.upper_edge(j)
        return self._max

    @property
    def value(self) -> float:
        """Mean observation (NaN when empty) — the scalar view exports use."""
        return self._sum / self._count if self._count else math.nan

    def to_dict(self) -> dict:
        """JSON-ready snapshot: count/sum/min/max + nonzero ``[le, n]``
        buckets (overflow bucket's ``le`` is ``None``)."""
        with self._lock:
            buckets = [
                [None if j == self.n_buckets - 1 else self.upper_edge(j), c]
                for j, c in enumerate(self._counts) if c
            ]
            return {"count": self._count, "sum": self._sum,
                    "min": None if self._count == 0 else self._min,
                    "max": None if self._count == 0 else self._max,
                    "buckets": buckets}


class Span:
    """Context manager timing one host-side phase into a histogram.

    ``with registry.span("publisher.publish_seconds", step=40): ...``
    observes the wall-clock duration into the histogram named ``name`` (one
    series per name) and, when the registry has a JSONL sink attached, emits
    a ``span`` event carrying ``fields`` (e.g. the step number) and the
    measured seconds.

    Spans close on the exception path too: a raise inside the block still
    observes the histogram and emits the record, with an ``error`` field
    naming the exception (the raise itself propagates unchanged).

    The record's ``start`` is ``time.time()`` at entry, the clock of its
    ``ts`` (stamped at exit) and of the torch profiler's trace, so a span
    lines up with a device trace.
    """

    def __init__(self, registry: "Registry", name: str, fields: dict):
        self.registry = registry
        self.name = name
        self.fields = dict(fields)
        self.seconds: float | None = None
        self._t0: float | None = None
        self._start: float | None = None

    def __enter__(self) -> "Span":
        self._t0, self._start = self.registry.clock(), time.time()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.seconds = self.registry.clock() - self._t0
        if exc_type is not None:
            self.fields.setdefault("error", f"{exc_type.__name__}: {exc}")
        self.registry.histogram(self.name).observe(self.seconds)
        self.registry.emit({"kind": "span", "name": self.name, "labels": {},
                            "seconds": self.seconds, "start": self._start,
                            "fields": self.fields})


class Registry:
    """Process- or subsystem-scoped store of labeled metric series.

    Series are created on first touch (``registry.counter("kernel.launches",
    kernel="fleet_half_step")``) and keyed by ``(name, sorted labels)``; the
    same call always returns the same object. ``clock`` is injectable so
    span tests are deterministic. An optional JSONL sink
    (:meth:`attach_sink`) receives span/event records as they happen —
    metric snapshots are exported separately (``export.dump_jsonl``).
    """

    def __init__(self, clock=time.monotonic):
        self._lock = threading.RLock()
        self._series: dict[tuple, object] = {}
        self._sink = None
        self.clock = clock

    # ------------------------------------------------------------- series

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (name, tuple(sorted((str(k), str(v)) for k, v in labels.items())))
        with self._lock:
            m = self._series.get(key)
            if m is None:
                m = self._series[key] = cls(name, labels, self._lock, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"series {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        """Get-or-create the counter ``name`` with ``labels``."""
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        """Get-or-create the gauge ``name`` with ``labels``."""
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, *, base: float = DEFAULT_BASE,
                  growth: float = DEFAULT_GROWTH,
                  n_buckets: int = DEFAULT_BUCKETS, **labels) -> Histogram:
        """Get-or-create the histogram ``name`` with ``labels`` (ladder
        parameters apply on first touch only)."""
        return self._get(Histogram, name, labels,
                         base=base, growth=growth, n_buckets=n_buckets)

    def span(self, name: str, **fields) -> Span:
        """Span context manager timing into histogram ``name``; ``fields``
        annotate the emitted event (not the series labels)."""
        return Span(self, name, fields)

    # -------------------------------------------------------------- reads

    def series(self) -> list[tuple[str, dict, object]]:
        """Sorted snapshot of ``(name, labels, metric)`` for every series."""
        with self._lock:
            items = sorted(self._series.items(), key=lambda kv: kv[0])
        return [(m.name, dict(m.labels), m) for _, m in items]

    def get(self, name: str, **labels):
        """The existing series object, or None when never touched."""
        key = (name, tuple(sorted((str(k), str(v)) for k, v in labels.items())))
        with self._lock:
            return self._series.get(key)

    def value(self, name: str, **labels) -> float:
        """Scalar value of a counter/gauge series; 0.0 when never touched."""
        m = self.get(name, **labels)
        return 0.0 if m is None else m.value

    def values(self) -> dict[str, float]:
        """Flat ``{"name{k=v,...}": value}`` of every counter/gauge — the
        deterministic slice benchmark JSONs embed as their telemetry
        section (histograms excluded: their values are wall-clock)."""
        out = {}
        for name, labels, m in self.series():
            if m.kind not in ("counter", "gauge"):
                continue
            key = name
            if labels:
                key += "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"
            out[key] = m.value
        return out

    # ---------------------------------------------------------- lifecycle

    def reset(self) -> None:
        """Drop every series (tests / bench sections start clean)."""
        with self._lock:
            self._series.clear()

    def attach_sink(self, sink) -> None:
        """Attach a JSONL event sink (anything with ``emit(dict)``); spans
        and :meth:`emit` calls stream to it as they happen."""
        self._sink = sink

    def detach_sink(self) -> None:
        """Stop streaming events."""
        self._sink = None

    def emit(self, record: dict) -> None:
        """Send one event record to the attached sink (no-op without one);
        a wall-clock ``ts`` is stamped if absent."""
        if self._sink is None:
            return
        record.setdefault("ts", time.time())
        self._sink.emit(record)


_DEFAULT = Registry()


def default_registry() -> Registry:
    """The process-wide registry every unscoped emitter writes to."""
    return _DEFAULT


def counter(name: str, **labels) -> Counter:
    """Counter on the default registry."""
    return _DEFAULT.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    """Gauge on the default registry."""
    return _DEFAULT.gauge(name, **labels)


def histogram(name: str, **kw) -> Histogram:
    """Histogram on the default registry."""
    return _DEFAULT.histogram(name, **kw)


def span(name: str, **fields) -> Span:
    """Span on the default registry."""
    return _DEFAULT.span(name, **fields)


def reset() -> None:
    """Reset the default registry (bench sections / tests start clean)."""
    _DEFAULT.reset()
