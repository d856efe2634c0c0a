"""Exporters: collected spans -> Perfetto-loadable Chrome trace JSON.

The Chrome trace-event format (the ``{"traceEvents": [...]}`` JSON that
``chrome://tracing`` and https://ui.perfetto.dev load directly) is the
lingua franca for timeline tooling, so the gateway's spans export to it:
one track (``tid``) per thread — each ``serve()`` dispatcher worker gets
its own named track, the supervising caller another — plus ``"C"``
counter events (queue depth, pending units) that Perfetto renders as a
counter track above the thread lanes.

:func:`validate_chrome_trace` is the schema check a reader runs before
trusting a trace (``chip_smoke.py`` runs it on the card's): every
event carries the required keys, complete events have non-negative
microsecond durations, and track metadata is well-formed.  Validation
failures are returned as strings (not raised) so callers can report all
of them at once.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

from . import trace as trace_mod

__all__ = ["to_chrome_trace", "write_chrome_trace",
           "validate_chrome_trace"]

_PID = 1


def _json_safe(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    return str(v)


def to_chrome_trace(spans: Optional[Iterable] = None,
                    counters: Optional[Iterable] = None) -> Dict[str, Any]:
    """Build the Chrome trace-event object from spans/counters (default:
    everything currently collected by :mod:`repro_torch.obs.trace`).

    Timestamps are microseconds relative to the earliest event, so the
    timeline starts at 0 regardless of the monotonic-clock origin.
    """
    if spans is None:
        spans = trace_mod.spans()
    if counters is None:
        counters = trace_mod.counters()
    spans = list(spans)
    counters = list(counters)

    t_origin = min(
        [s.t0 for s in spans] + [c.t for c in counters], default=0.0)

    def us(t: float) -> float:
        return round((t - t_origin) * 1e6, 3)

    tids: Dict[str, int] = {}

    def tid_of(name: str) -> int:
        if name not in tids:
            tids[name] = len(tids) + 1
        return tids[name]

    events: List[dict] = []
    for s in spans:
        ev: Dict[str, Any] = {
            "name": s.name, "cat": s.cat, "pid": _PID,
            "tid": tid_of(s.tid), "ts": us(s.t0),
        }
        if s.t1 is None:
            ev["ph"] = "i"
            ev["s"] = "t"            # instant scoped to its thread
        else:
            ev["ph"] = "X"
            ev["dur"] = max(0.0, round((s.t1 - s.t0) * 1e6, 3))
        if s.args:
            ev["args"] = _json_safe(s.args)
        events.append(ev)
    for c in counters:
        events.append({
            "name": c.name, "cat": "counter", "ph": "C", "pid": _PID,
            "tid": 0, "ts": us(c.t), "args": {"value": c.value},
        })
    # thread-name metadata makes Perfetto label tracks by worker name
    meta = [{"name": "process_name", "ph": "M", "pid": _PID,
             "args": {"name": "repro-gateway"}}]
    for tname, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append({"name": "thread_name", "ph": "M", "pid": _PID,
                     "tid": tid, "args": {"name": tname}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Optional[Iterable] = None,
                       counters: Optional[Iterable] = None
                       ) -> Dict[str, Any]:
    """Serialize :func:`to_chrome_trace` to ``path``; returns the
    object (so callers can validate what they wrote)."""
    obj = to_chrome_trace(spans, counters)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


_REQUIRED = ("name", "ph", "pid")
_PHASES = {"X", "i", "C", "M", "B", "E"}


def validate_chrome_trace(obj: Any) -> List[str]:
    """Schema violations of a trace-event object (empty list = valid).

    Checks the containment contract Perfetto relies on: a
    ``traceEvents`` list of dicts, required keys per event, known phase
    codes, numeric non-negative timestamps, and non-negative durations
    on complete (``"X"``) events.
    """
    errs: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be a dict with a 'traceEvents' list"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not a dict")
            continue
        missing = [k for k in _REQUIRED if k not in ev]
        if missing:
            errs.append(f"event {i}: missing keys {missing}")
            continue
        ph = ev["ph"]
        if ph not in _PHASES:
            errs.append(f"event {i} ({ev['name']}): unknown phase {ph!r}")
            continue
        if ph == "M":
            continue                       # metadata: no timestamp needed
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"event {i} ({ev['name']}): bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(
                    f"event {i} ({ev['name']}): complete event needs "
                    f"dur >= 0, got {dur!r}")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                errs.append(
                    f"event {i} ({ev['name']}): counter event needs a "
                    f"non-empty args dict")
    return errs
