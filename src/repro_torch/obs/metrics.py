"""The metrics registry: counters, gauges, log-bucketed histograms.

Where :mod:`repro_torch.obs.trace` answers "what happened when", this module
answers "how much, how often, how long" — the always-on aggregate side
of the same instrumentation.  The gateway feeds it per-channel queue
depth, batch occupancy, padding waste, retry and dead-letter counts and
submit→resolve latency; the plan cache feeds it hits, misses and
compile seconds.  Two read-outs: a JSON-safe :meth:`~MetricsRegistry.
snapshot` (what ``Gateway.metrics()`` embeds) and Prometheus text
exposition
(:meth:`~MetricsRegistry.prometheus`).

Histograms are log-bucketed (two buckets per octave, so bucket edges
grow by √2): constant memory for any value range, and the quantile
estimates (p50/p95/p99) are within one bucket edge (≤ √2 relative
error) of the truth — the right trade for latency attribution, where
the question is "milliseconds or seconds", not microsecond precision.

Everything is thread-safe: one registry-wide lock taken per update.
Updates happen per *batch* (launch, harvest, retry), not per cell, so
the lock is nowhere near any hot loop.

The module also hosts the plan-compile ledger: a capped per-key record
of ``compile_s`` that survives ``clear_plan_cache(keep_stats=True)`` —
the per-plan attribution the retired-totals fold used to lose, which
autotune sweeps need to tell a compile storm from a slow kernel.
"""
from __future__ import annotations

import collections
import math
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "get_registry", "CompileLedger", "COMPILE_LEDGER", "record_compile",
    "compile_ledger_snapshot",
]

_QUANTILES = (0.5, 0.95, 0.99)


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "labels", "_lock", "_v")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc must be >= 0")
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    """A value that goes up and down (queue depth, pending units)."""

    __slots__ = ("name", "labels", "_lock", "_v")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._v -= n

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Log-bucketed value distribution with streaming quantiles.

    Bucket ``i`` holds values in ``(√2^(i-1), √2^i]``; non-positive
    values land in a dedicated underflow bucket.  ``count``/``sum``/
    ``min``/``max`` are exact; quantiles are geometric-midpoint
    estimates off the bucket histogram (≤ √2 relative error).
    """

    __slots__ = ("name", "labels", "_lock", "_buckets", "count", "sum",
                 "min", "max")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    @staticmethod
    def _bucket_of(v: float) -> int:
        # two buckets per octave; underflow for v <= 0
        if v <= 0.0:
            return -(10 ** 9)
        return math.ceil(2.0 * math.log2(v))

    @staticmethod
    def _bucket_mid(i: int) -> float:
        # geometric midpoint of (√2^(i-1), √2^i]
        return 2.0 ** ((i - 0.5) / 2.0)

    def observe(self, v: float) -> None:
        v = float(v)
        i = self._bucket_of(v)
        with self._lock:
            self._buckets[i] = self._buckets.get(i, 0) + 1
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            if not self.count:
                return None
            target = q * self.count
            seen = 0
            for i in sorted(self._buckets):
                seen += self._buckets[i]
                if seen >= target:
                    if i == -(10 ** 9):     # underflow bucket
                        return float(self.min if self.min is not None
                                     else 0.0)
                    # clamp the estimate to the observed extremes so a
                    # one-value histogram reports that exact value
                    mid = self._bucket_mid(i)
                    lo = self.min if self.min is not None else mid
                    hi = self.max if self.max is not None else mid
                    return float(min(max(mid, lo), hi))
            return float(self.max) if self.max is not None else None

    def percentiles(self) -> Dict[str, Optional[float]]:
        return {f"p{int(q * 100)}": self.quantile(q) for q in _QUANTILES}

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """One namespace of metrics; services own their own instance and the
    plan cache feeds the process-global :data:`REGISTRY`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, tuple], Any] = {}

    def _get(self, kind: str, cls, name: str, labels: dict):
        key = (kind, name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, key[2])
                    self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", Histogram, name, labels)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- read-outs -----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe dump: ``{counters: {...}, gauges: {...},
        histograms: {...}}``; labelled series key as
        ``name{k=v,...}``."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}}
        for (kind, name, labels), m in sorted(items, key=lambda kv: kv[0]):
            key = name
            if labels:
                key += "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"
            if kind == "counter":
                out["counters"][key] = m.value
            elif kind == "gauge":
                out["gauges"][key] = m.value
            else:
                out["histograms"][key] = {
                    "count": m.count, "sum": m.sum,
                    "min": m.min, "max": m.max, "mean": m.mean,
                    **m.percentiles()}
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition (one TYPE line per family;
        histograms expose ``_count``/``_sum`` plus quantile gauges —
        the summary-style read of the log-bucketed estimate)."""
        with self._lock:
            items = list(self._metrics.items())
        lines: List[str] = []
        typed: set = set()
        for (kind, name, labels), m in sorted(items, key=lambda kv: kv[0]):
            lab = ""
            if labels:
                lab = "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"
            if kind in ("counter", "gauge"):
                if name not in typed:
                    typed.add(name)
                    lines.append(f"# TYPE {name} {kind}")
                lines.append(f"{name}{lab} {m.value:g}")
            else:
                if name not in typed:
                    typed.add(name)
                    lines.append(f"# TYPE {name} summary")
                for q in _QUANTILES:
                    v = m.quantile(q)
                    if v is None:
                        continue
                    qlab = (lab[:-1] + f',quantile="{q}"}}') if lab \
                        else f'{{quantile="{q}"}}'
                    lines.append(f"{name}{qlab} {v:g}")
                lines.append(f"{name}_count{lab} {m.count}")
                lines.append(f"{name}_sum{lab} {m.sum:g}")
        return "\n".join(lines) + ("\n" if lines else "")


# the process-global registry (plan cache, anything without a service)
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY


# -- the plan-compile ledger -------------------------------------------------
class CompileLedger:
    """Capped per-plan-key compile-time attribution.

    ``clear_plan_cache(keep_stats=True)`` folds retired plans into
    aggregate totals; this ledger keeps the *per-key* ``compile_s`` (and
    usage counters) across those clears, bounded at ``cap`` entries with
    oldest-first eviction, so an autotune sweep that clears executables
    between configs can still attribute its compile seconds afterwards.
    """

    def __init__(self, cap: int = 512):
        if cap < 1:
            raise ValueError(f"ledger cap must be >= 1, got {cap}")
        self.cap = cap
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()

    def record(self, key: str, compile_s: float) -> None:
        """One plan compiled (first dispatch): remember its cost."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = {"compile_s": 0.0, "compiles": 0,
                     "calls": 0, "hits": 0}
                self._entries[key] = e
            e["compile_s"] += float(compile_s)
            e["compiles"] += 1
            self._entries.move_to_end(key)
            while len(self._entries) > self.cap:
                self._entries.popitem(last=False)

    def update_usage(self, key: str, calls: int, hits: int) -> None:
        """Fold a retiring plan's dispatch counters into its entry (only
        keys the ledger still holds; usage of evicted keys is lost with
        the entry, by design — the ledger is bounded)."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                e["calls"] += int(calls)
                e["hits"] += int(hits)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._entries.items()}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)


COMPILE_LEDGER = CompileLedger()


def record_compile(key: str, compile_s: float) -> None:
    COMPILE_LEDGER.record(key, compile_s)


def compile_ledger_snapshot() -> Dict[str, dict]:
    return COMPILE_LEDGER.snapshot()
