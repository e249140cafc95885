"""Process-wide metrics registry — Counter / Gauge / Histogram built
for the ingest hot path.

The reference leans on ClickHouse `system.*` tables and Grafana for
operational telemetry; the in-process equivalent must cost ~nothing on
the path it observes, so the primitives are designed around who owns
which lock *already*:

  * Counters are STRIPED: each instance carries N_STRIPES + 1
    float64 slots. A caller that already owns a stripe (an ingest
    detector shard incrementing under its own shard lock) writes its
    slot with NO additional lock — only that caller ever touches it.
    Callers without an owned stripe go through a per-counter lock into
    slot 0. Reads merge the stripes (`sum()`), so totals are exact as
    soon as every writer's increment has retired.
  * Histograms use POWER-OF-TWO buckets backed by fixed numpy arrays
    (one [stripes, buckets] int64 grid + per-stripe sum/count):
    `observe()` is a frexp + three array adds, no allocation, no
    per-bucket search. Bucket bounds are 2^k seconds, so `le` values
    are exact in both float and decimal text exposition.
  * Gauges are cold-path (lock per set); a gauge child can instead be
    bound to a callback evaluated at collect time, for values that are
    cheaper to read on scrape than to maintain on write.

Metric constructors are idempotent per (name): calling
`counter("x", ...)` twice returns the same object, so instrumented
modules declare their handles at import with no registration dance.

Env knobs:

    THEIA_METRICS_STRIPES    stripe count per counter/histogram
                             (default 16)
    THEIA_METRICS_DISABLED   "1"/"true" → every inc/observe/set is a
                             no-op (the bench's overhead A/B switch);
                             also togglable at runtime via
                             disable()/enable()

This module deliberately imports nothing from the rest of theia_tpu
(stdlib + numpy only, plus analysis.lockdep — itself stdlib-only, so
its own locks are witnessed too): utils.faults instruments its
firings here, and utils is imported by everything.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
from ..analysis.lockdep import named_lock


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


#: owned stripes per counter/histogram (slot 0 is the locked shared
#: slot, so the arrays are N_STRIPES + 1 wide)
N_STRIPES = max(1, _env_int("THEIA_METRICS_STRIPES", 16))

#: histogram bucket bounds: 2^k seconds for k in [EXP_MIN, EXP_MIN +
#: N_BUCKETS) — ~1 µs to ~16 s — plus a +Inf overflow bucket
EXP_MIN = -20
N_BUCKETS = 25

_DISABLED = os.environ.get(
    "THEIA_METRICS_DISABLED", "").strip().lower() in ("1", "true", "yes")


def disable() -> None:
    """Turn every increment/observation into a no-op (collection still
    works — values just stop moving)."""
    global _DISABLED
    _DISABLED = True


def enable() -> None:
    global _DISABLED
    _DISABLED = False


def enabled() -> bool:
    return not _DISABLED


def _label_key(labelnames: Tuple[str, ...],
               labels: Dict[str, object]) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


class _Metric:
    """Shared child-table machinery for the three metric types."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 labelnames: Tuple[str, ...] = ()) -> None:
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = named_lock("metrics.children")
        self._default = self._make_child() if not self.labelnames \
            else None

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **labels):
        key = _label_key(self.labelnames, labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        """(label values, child) pairs, sorted for stable exposition."""
        if self._default is not None:
            return [((), self._default)]
        with self._lock:
            return sorted(self._children.items())

    def zero(self) -> None:
        """Reset every child (tests)."""
        for _, child in self.children():
            child._zero()


class _CounterChild:
    __slots__ = ("_stripes", "_lock")

    def __init__(self) -> None:
        self._stripes = np.zeros(N_STRIPES + 1, np.float64)
        self._lock = named_lock("metrics.counter")

    def inc(self, amount: float = 1.0,
            stripe: Optional[int] = None) -> None:
        """Add `amount`. With `stripe`, the caller asserts it is the
        ONLY concurrent writer of that stripe (it holds the owning
        shard's lock) and skips this counter's lock entirely. A stripe
        outside [0, N_STRIPES) takes the locked path instead — a
        modulo would alias two distinct owners onto one lock-free slot
        and silently lose increments."""
        if _DISABLED:
            return
        if stripe is None or not 0 <= stripe < N_STRIPES:
            with self._lock:
                self._stripes[0] += amount
        else:
            self._stripes[1 + stripe] += amount

    def value(self) -> float:
        return float(self._stripes.sum())

    def _zero(self) -> None:
        with self._lock:
            self._stripes[:] = 0.0


class Counter(_Metric):
    kind = "counter"

    def _make_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, amount: float = 1.0,
            stripe: Optional[int] = None) -> None:
        self._default.inc(amount, stripe=stripe)

    def value(self) -> float:
        return self._default.value()


class _GaugeChild:
    __slots__ = ("_value", "_lock", "_callback")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = named_lock("metrics.gauge")
        self._callback: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        if _DISABLED:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if _DISABLED:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_callback(self, fn: Optional[Callable[[], float]]) -> None:
        """Evaluate `fn` at collect time instead of storing a value —
        for state that is cheaper to read on scrape than to maintain
        on every write."""
        self._callback = fn

    def value(self) -> float:
        if self._callback is not None:
            try:
                return float(self._callback())
            except Exception:
                return float("nan")
        with self._lock:
            return self._value

    def _zero(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge(_Metric):
    kind = "gauge"

    def _make_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default.set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default.dec(amount)

    def set_callback(self, fn: Optional[Callable[[], float]]) -> None:
        self._default.set_callback(fn)

    def value(self) -> float:
        return self._default.value()


def bucket_bounds() -> List[float]:
    """Finite `le` bounds (2^k seconds); +Inf is implicit."""
    return [2.0 ** (EXP_MIN + i) for i in range(N_BUCKETS)]


def bucket_index(value: float) -> int:
    """Index of the first bucket whose bound is >= value (N_BUCKETS =
    the +Inf bucket). A value exactly on a 2^k bound lands IN that
    bucket, matching Prometheus `le` semantics."""
    if value <= 2.0 ** EXP_MIN:
        return 0
    m, e = math.frexp(value)          # value = m * 2^e, m in [0.5, 1)
    k = e - 1 if m == 0.5 else e      # smallest k with value <= 2^k
    idx = k - EXP_MIN
    return idx if idx < N_BUCKETS else N_BUCKETS


class _HistogramChild:
    __slots__ = ("_counts", "_sums", "_ns", "_lock")

    def __init__(self) -> None:
        # rows: stripe slots (0 = locked shared slot); cols: buckets
        # (+Inf last). Fixed allocation — observe() never grows it.
        self._counts = np.zeros((N_STRIPES + 1, N_BUCKETS + 1),
                                np.int64)
        self._sums = np.zeros(N_STRIPES + 1, np.float64)
        self._ns = np.zeros(N_STRIPES + 1, np.int64)
        self._lock = named_lock("metrics.histogram")

    def observe(self, value: float,
                stripe: Optional[int] = None) -> None:
        if _DISABLED:
            return
        b = bucket_index(value)
        if stripe is None or not 0 <= stripe < N_STRIPES:
            # out-of-range stripes take the locked path — aliasing two
            # owners onto one lock-free row would lose observations
            with self._lock:
                self._counts[0, b] += 1
                self._sums[0] += value
                self._ns[0] += 1
        else:
            row = 1 + stripe
            self._counts[row, b] += 1
            self._sums[row] += value
            self._ns[row] += 1

    def snapshot(self) -> Tuple[np.ndarray, float, int]:
        """(cumulative bucket counts incl. +Inf, sum, count) — the
        Prometheus exposition triple."""
        merged = self._counts.sum(axis=0)
        return (np.cumsum(merged),
                float(self._sums.sum()), int(self._ns.sum()))

    def count(self) -> int:
        return int(self._ns.sum())

    def sum(self) -> float:
        return float(self._sums.sum())

    def _zero(self) -> None:
        with self._lock:
            self._counts[:] = 0
            self._sums[:] = 0.0
            self._ns[:] = 0


class Histogram(_Metric):
    kind = "histogram"

    def _make_child(self) -> _HistogramChild:
        return _HistogramChild()

    def observe(self, value: float,
                stripe: Optional[int] = None) -> None:
        self._default.observe(value, stripe=stripe)

    def count(self) -> int:
        return self._default.count()

    def sum(self) -> float:
        return self._default.sum()


class Registry:
    """Name-keyed metric table; constructors are idempotent (same name
    returns the same object; a kind/labels mismatch is a bug and
    raises)."""

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}
        self._lock = named_lock("metrics.registry")

    def _get_or_make(self, cls, name: str, help_text: str,
                     labelnames: Tuple[str, ...]):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help_text,
                                              labelnames)
            elif not isinstance(m, cls) or \
                    m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{m.kind} with labels {m.labelnames}")
            return m

    def counter(self, name: str, help_text: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help_text,
                                 tuple(labelnames))

    def gauge(self, name: str, help_text: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help_text,
                                 tuple(labelnames))

    def histogram(self, name: str, help_text: str = "",
                  labelnames: Iterable[str] = ()) -> Histogram:
        return self._get_or_make(Histogram, name, help_text,
                                 tuple(labelnames))

    def collect(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def zero(self) -> None:
        """Reset every metric's values (registrations survive) — test
        isolation for a process-global registry."""
        for m in self.collect():
            m.zero()


#: the process-wide registry every instrumented module registers into
REGISTRY = Registry()


def counter(name: str, help_text: str = "",
            labelnames: Iterable[str] = ()) -> Counter:
    return REGISTRY.counter(name, help_text, labelnames)


def gauge(name: str, help_text: str = "",
          labelnames: Iterable[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help_text, labelnames)


def histogram(name: str, help_text: str = "",
              labelnames: Iterable[str] = ()) -> Histogram:
    return REGISTRY.histogram(name, help_text, labelnames)
