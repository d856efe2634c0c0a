"""The readers of the program's spans (``bench/spans.py`` and the metrics
``plan_host_ms``, ``k1_host_ms`` and ``entry_wait_ms``) on synthetic
profiler events: children and blocking waits subtracted, waits counted
under the entry, and no reading where the program emits no span or no
device ran."""
from __future__ import annotations

import json

import pytest

from bench import harness, spans, trace

A = "user_annotation"
RT = "cuda_runtime"


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _call(t):
    """One traced call at ``t`` (microseconds) as the program emits it: a
    300 us wait in the codes' copy, 10 us of pageable copy in the plan's
    lengths and a 20 us wait inside the fold (not a real one; it checks
    that a child's wait is not subtracted twice)."""
    return [_event(trace.SUBMIT, A, t, 500),
            _event("batch.align", A, t + 5, 480),
            _event("batch.h2d", A, t + 10, 320),
            _event("cudaStreamSynchronize", RT, t + 15, 300),
            _event("plan.get", A, t + 330, 20),
            _event("plan.tune_lookup", A, t + 335, 5),
            _event("plan.run", A, t + 350, 130),
            _event("plan.lens", A, t + 352, 18),
            _event("cudaMemcpyAsync", RT, t + 355, 10),
            _event("k1.prep", A, t + 370, 40),
            _event("k1.launch", A, t + 410, 30),
            _event("cudaLaunchKernel", RT, t + 430, 5),
            _event("k1.fold", A, t + 440, 35),
            _event("cudaStreamSynchronize", RT, t + 450, 20),
            _event(trace.HARVEST, A, t + 500, 100),
            _event("cudaEventSynchronize", RT, t + 505, 90)]


def _run(events, device=True):
    ev = [_event(trace.WINDOW, A, 0, 2000)] + events
    if device:
        ev.append(_event("void wavefront_kernel<A>()", "kernel", 440, 900))
    return harness.Run({}, {}, setup_s=1.0, trace=trace.from_events(ev))


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_plan_host_ms_subtracts_k1_children_and_waits():
    run = _run(_call(0) + _call(600))
    # plan.get 20 + plan.run 130 less k1.* (40 + 30 + 35) = 25; no wait of
    # BLOCKING lies under plan.run outside its children
    assert _read("plan_host_ms", run) == pytest.approx((20 + 25) / 1e3)


def test_k1_host_ms_subtracts_the_waits_under_its_spans():
    run = _run(_call(0) + _call(600))
    # 40 + 30 + (35 - 20): the wait under k1.fold is not the host's own
    assert _read("k1_host_ms", run) == pytest.approx((40 + 30 + 15) / 1e3)


def test_entry_wait_ms_counts_the_blocking_calls_under_the_entry():
    run = _run(_call(0) + _call(600))
    # 300 in the copy and 20 in the fold; the harvest's 90 is not the
    # entry's, and cudaMemcpyAsync is no blocking call
    assert _read("entry_wait_ms", run) == pytest.approx(320 / 1e3)
    # the harness's reading and the program's add up: the submit span
    # less its own host time is the entry's waits
    submit_ms = _read("host_submit_ms", run)
    assert 500 / 1e3 - submit_ms == pytest.approx(
        _read("entry_wait_ms", run))


def test_no_program_span_or_no_device_reads_nothing():
    harness_only = [e for e in _call(0) if e["cat"] != A
                    or e["name"] in (trace.SUBMIT, trace.HARVEST)]
    run = _run(harness_only)
    assert _read("host_submit_ms", run) is not None
    for name in ("plan_host_ms", "k1_host_ms", "entry_wait_ms"):
        assert _read(name, run) is None
        assert _read(name, _run(_call(0), device=False)) is None
        assert _read(name, harness.Run({}, {}, setup_s=1.0)) is None


def test_a_child_rounded_past_its_parent_stays_under_it():
    """The trace rounds start and duration apart, so a child may end a
    nanosecond after its parent: its midpoint keeps it inside."""
    ev = _call(0)
    for e in ev:
        if e["name"] == "k1.fold":
            e["dur"] += 0.001
    run = _run(ev)
    assert _read("plan_host_ms", run) == pytest.approx(
        (20 + 25 - 0.001) / 1e3)


def test_waits_and_gaps_named_by_their_innermost_span():
    tl = _run(_call(0)).trace
    assert spans.by_span(tl, [(19, 2), (335, 2), (549, 2), (1499, 2)]) == {
        "batch.h2d": [1, 2.0], "plan.tune_lookup": [1, 2.0],
        trace.HARVEST: [1, 2.0], "none": [1, 2.0]}
    assert spans.by_span(tl, spans.waits(tl)) == {
        "batch.h2d": [1, 300.0], "k1.fold": [1, 20.0],
        trace.HARVEST: [1, 90.0]}


def test_where_runs_a_tiny_cell_on_the_cpu():
    """``bench/where.py`` end to end at a tiny size: the set-up's first
    calls under the ring, the traced segment by span (no device here, so
    no per-layer reading of the program's spans), the idle-card times."""
    from bench import where
    from bench.tests.test_bench_harness import tiny_cell
    got = where.where(tiny_cell("short_b262144"), 5, 0.2, 3, device="cpu")
    first = got["first_calls_spans"]
    assert first["batch.align"][0] == first["plan.run"][0] == 2
    assert first["plan.compile"][0] == 1 and first["plan.get"][0] == 2
    assert got["readings"]["plan_host_ms"] is None
    assert got["readings"]["host_submit_ms"] > 0
    seg = got["segment"]
    assert seg["calls"] >= 4 and 0 < seg["align_own_ms"] <= seg["submit_ms"]
    assert sum(seg["self_ms_by_span"].values()) == pytest.approx(
        seg["align_own_ms"])
    assert all(len(g) == 3 for g in seg["long_gaps_unheld"])
    assert set(got["cost"]["idle_card"]) == {"ring_off_ms", "ring_on_ms"}
    assert set(got["cost"]["span_us"]) == {"off", "ring", "profiler",
                                           "both"}
    json.dumps(got)


def test_a_gap_split_over_the_spans_it_crosses():
    """A device idle gap from the codes' copy to K1's launch: whole under
    the entry, split over the spans it crosses."""
    tl = _run(_call(0)).trace
    gap = [(320.0, 100.0)]                     # [320, 420]
    assert spans.by_span(tl, gap, whole=True) == {"batch.align": [1, 100.0]}
    assert spans.split_by_span(tl, gap) == pytest.approx({
        "batch.h2d": 10.0, "plan.get": 15.0,
        "plan.tune_lookup": 5.0, "plan.run": 2.0, "plan.lens": 18.0,
        "k1.prep": 40.0, "k1.launch": 10.0})
