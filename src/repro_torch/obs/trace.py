"""Span tracing: where the port's host cycles go (copy of
``repro.obs.trace``, with ``torch.profiler`` as a second sink).

DP-HLS's performance story (PE occupancy, fill vs. traceback split, I/O
stalls) is told with stage-level attribution; this module is the
host-runtime equivalent for the batch entry, the plan cache, K1's
wrapper, the serving gateway and the mapper ladder.  A *span* is a named
``[t0, t1)`` interval on one thread.  One ``span(...)`` call feeds two
sinks:

* **the ring** (on after :func:`enable`): spans land, with their args, in
  per-thread ring buffers on the monotonic clock; the exporter in
  :mod:`repro_torch.obs.export` turns them into a Perfetto-loadable
  Chrome trace, one track per thread;
* **the profiler** (on while a ``torch.profiler`` session records): the
  span also opens a ``torch.profiler.record_function(name)`` range, so it
  appears in the profiler's own timeline, on its clock, as a
  ``user_annotation`` event beside the kernels, copies and CUDA runtime
  calls it causes.  That is what names the host cause of a device idle
  gap.

Design constraints, in order:

* **Near-zero overhead when off.**  With both sinks off, ``span(...)`` is
  one branch on the ring's flag and the profiler's, returning a shared
  no-op context manager: no span object is made.
* **Thread-safe without a hot-path lock.**  Spans land in a *per-thread*
  ring buffer (``threading.local``) that only its owner writes; the
  global registry of rings is only locked at ring creation and at
  export.  Concurrent workers can never corrupt each other's spans.
* **Bounded memory.**  Each ring holds ``capacity`` spans and wraps,
  dropping oldest-first (``dropped`` counts what fell off); counter
  samples live in one bounded deque.

Usage::

    from repro_torch.obs import trace
    trace.enable()
    with trace.span("gw.launch", cat="gateway", worker="w0", n=8):
        ...work...
    trace.counter("gw.queue_depth", 17)
    events = trace.snapshot()           # {"spans": [...], "counters": ...}
    trace.disable()

Instants and counters go to the ring only.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

__all__ = [
    "Span", "CounterSample", "enable", "disable", "enabled", "span",
    "instant", "counter", "snapshot", "spans", "counters", "dropped",
    "clear",
]

# -- the global switch -------------------------------------------------------
# read on every span() call; writes only via enable()/disable().  The
# profiler's own flag (``_profiler._is_profiler_enabled``) is the second.
_ENABLED = False

_DEFAULT_CAPACITY = 4096
_CAPACITY = _DEFAULT_CAPACITY
_COUNTER_CAPACITY = 65536

_now = time.monotonic


class Span(NamedTuple):
    """One completed interval: ``dur is None`` marks an instant event."""
    name: str
    cat: str
    t0: float                 # monotonic seconds
    t1: Optional[float]       # None = instant
    tid: str                  # owning thread's name
    args: Optional[dict]


class CounterSample(NamedTuple):
    """One sample of a numeric series (queue depth, pending, ...)."""
    name: str
    t: float
    value: float


class _Ring:
    """Fixed-capacity span buffer owned by exactly one thread.

    Only the owning thread writes (no lock on the push path); readers
    (snapshot/export) see a consistent prefix because list slot stores
    are atomic under the GIL and ``n`` is published after the store.
    """

    __slots__ = ("buf", "cap", "n", "tid", "epoch")

    def __init__(self, cap: int, tid: str, epoch: int):
        self.buf: List[Optional[Span]] = [None] * cap
        self.cap = cap
        self.n = 0            # total ever pushed; write index = n % cap
        self.tid = tid
        self.epoch = epoch

    def push(self, s: Span) -> None:
        self.buf[self.n % self.cap] = s
        self.n += 1

    @property
    def dropped(self) -> int:
        return max(0, self.n - self.cap)

    def items(self) -> List[Span]:
        """Retained spans, oldest first (wraparound drops oldest)."""
        if self.n <= self.cap:
            return [s for s in self.buf[: self.n] if s is not None]
        i = self.n % self.cap
        return [s for s in self.buf[i:] + self.buf[:i] if s is not None]


_LOCAL = threading.local()
_REG_LOCK = threading.Lock()
_RINGS: List[_Ring] = []
_EPOCH = 0     # bumped by clear(): stale thread-local rings are abandoned
_COUNTERS: collections.deque = collections.deque(maxlen=_COUNTER_CAPACITY)
_COUNTER_LOCK = threading.Lock()


def _ring() -> _Ring:
    r = getattr(_LOCAL, "ring", None)
    if r is None or r.epoch != _EPOCH or r.cap != _CAPACITY:
        r = _Ring(_CAPACITY, threading.current_thread().name, _EPOCH)
        _LOCAL.ring = r
        with _REG_LOCK:
            _RINGS.append(r)
    return r


# -- control -----------------------------------------------------------------
def enable(capacity: Optional[int] = None) -> None:
    """Turn span collection on.  ``capacity`` resizes the per-thread
    ring (existing rings are kept; new pushes go to resized rings)."""
    global _ENABLED, _CAPACITY
    if capacity is not None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        _CAPACITY = int(capacity)
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def clear() -> None:
    """Drop every collected span and counter sample (rings are
    abandoned; threads lazily create fresh ones on their next push)."""
    global _EPOCH
    with _REG_LOCK:
        _EPOCH += 1
        _RINGS.clear()
    with _COUNTER_LOCK:
        _COUNTERS.clear()


# -- recording ---------------------------------------------------------------
class _NoopSpan:
    """The disabled path: one shared instance, every method a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        return self

    def drop(self):
        return self


_NOOP = _NoopSpan()


class _SpanCM:
    """Context manager for one span: a profiler range while it is open
    (when a profiler session records) and a ring record on exit (when the
    ring was on at the start, unless dropped)."""

    __slots__ = ("name", "cat", "args", "t0", "_dropped", "_ring", "_rf")

    def __init__(self, name: str, cat: str, args: Optional[dict]):
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0
        self._dropped = False
        self._ring = _ENABLED
        self._rf = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        if self._ring and not self._dropped:
            r = _ring()
            r.push(Span(self.name, self.cat, self.t0, _now(), r.tid,
                        self.args))
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False

    def set(self, **args):
        """Attach args discovered mid-span (e.g. the batch size chosen
        during formation)."""
        if self.args is None:
            self.args = dict(args)
        else:
            self.args.update(args)
        return self

    def drop(self):
        """Suppress this span's ring record (e.g. batch formation found
        nothing); a profiler range already open stays."""
        self._dropped = True
        return self


def span(name: str, cat: str = "gw", **args):
    """A context manager timing one named interval on this thread, in the
    ring (after :func:`enable`) and in a recording ``torch.profiler``
    session.

    With both off it returns a shared no-op: the call is one branch."""
    if not (_ENABLED or _profiler._is_profiler_enabled):
        return _NOOP
    return _SpanCM(name, cat, args or None)


def instant(name: str, cat: str = "gw", **args) -> None:
    """Record a point event (retry, dead letter, worker kill...)."""
    if not _ENABLED:
        return
    r = _ring()
    r.push(Span(name, cat, _now(), None, r.tid, args or None))


def counter(name: str, value, **_ignored) -> None:
    """Sample one numeric series (exported as a Perfetto counter
    track)."""
    if not _ENABLED:
        return
    with _COUNTER_LOCK:
        _COUNTERS.append(CounterSample(name, _now(), float(value)))


# -- read-out ----------------------------------------------------------------
def spans() -> List[Span]:
    """Every retained span across all threads, ordered by start time."""
    with _REG_LOCK:
        rings = list(_RINGS)
    out: List[Span] = []
    for r in rings:
        out.extend(r.items())
    out.sort(key=lambda s: s.t0)
    return out


def counters() -> List[CounterSample]:
    with _COUNTER_LOCK:
        return list(_COUNTERS)


def dropped() -> int:
    """Total spans lost to ring wraparound across all threads."""
    with _REG_LOCK:
        return sum(r.dropped for r in _RINGS)


def snapshot() -> Dict[str, Any]:
    """Everything the exporter needs, as one JSON-friendly dict."""
    return {"spans": spans(), "counters": counters(),
            "dropped": dropped(), "enabled": _ENABLED}
