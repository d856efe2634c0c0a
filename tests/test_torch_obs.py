"""The port's observability layer (``repro_torch.obs``) on the CPU: the span
tracer, the metrics registry and the trace export as ``tests/test_obs.py``
holds JAX's, the same snapshots from both packages' registries, the plan
cache's compile ledger and ``totals`` across
``clear_plan_cache(keep_stats=True)``, the ``torch.profiler`` bridge, and
the spans the ported gateway, dispatcher, plan cache and mapper emit."""
from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro_torch.obs import export as obs_export
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace
from repro_torch.runtime import plan as plan_mod
from repro_torch.serve import (AlignRequest, AlignmentService, FaultPlan,
                               InjectedFault)


@pytest.fixture(autouse=True)
def _clean_trace():
    """Every test starts and ends with tracing off, empty, at the default
    ring capacity and with the profiler bridge off."""
    trace.disable()
    trace.disable_profiler_bridge()
    trace.clear()
    trace._CAPACITY = trace._DEFAULT_CAPACITY
    yield
    trace.disable()
    trace.disable_profiler_bridge()
    trace.clear()
    trace._CAPACITY = trace._DEFAULT_CAPACITY


def _req(rid, rng, n=12, kernel="global_affine"):
    return AlignRequest(rid=rid, kernel=kernel,
                        query=rng.integers(0, 4, n).astype(np.uint8),
                        ref=rng.integers(0, 4, n + 2).astype(np.uint8))


def _svc(**kw):
    return AlignmentService(device="cpu", **kw)


# -- trace -------------------------------------------------------------------
def test_disabled_path_emits_nothing():
    assert not trace.enabled()
    with trace.span("x", cat="t", a=1) as sp:
        sp.set(b=2)
    trace.instant("y", cat="t")
    trace.counter("z", 3.0)

    @trace.traced
    def f(v):
        return v + 1

    assert f(1) == 2
    assert trace.spans() == [] and trace.counters() == []
    assert trace.dropped() == 0
    assert trace.span("a") is trace.span("b") is trace._NOOP
    assert trace.annotate("gw.launch/x") is trace._NOOP


def test_enable_disable_round_trip():
    trace.enable()
    with trace.span("on", cat="t"):
        pass
    trace.disable()
    with trace.span("off", cat="t"):
        pass
    assert [s.name for s in trace.spans()] == ["on"]


def test_span_records_interval_and_args():
    trace.enable()
    with trace.span("gw.launch", cat="gateway", worker="w0") as sp:
        sp.set(n=8)
    (s,) = trace.spans()
    assert s.name == "gw.launch" and s.cat == "gateway"
    assert s.t1 is not None and s.t1 >= s.t0
    assert s.tid == threading.current_thread().name
    assert s.args == {"worker": "w0", "n": 8}


def test_span_drop_instant_and_exception():
    trace.enable()
    with trace.span("gw.form", cat="gateway") as sp:
        sp.drop()
    trace.instant("gw.retry", cat="gateway", n=2)
    with pytest.raises(ValueError):
        with trace.span("gw.launch", cat="gateway"):
            raise ValueError("boom")
    got = trace.spans()
    assert [s.name for s in got] == ["gw.retry", "gw.launch"]
    assert got[0].t1 is None and got[0].args == {"n": 2}
    assert trace.dropped() == 0


def test_traced_decorator_bare_and_configured():
    trace.enable()

    @trace.traced
    def plain():
        return 1

    @trace.traced(name="map.extend", cat="mapper")
    def named():
        return 2

    assert plain() == 1 and named() == 2
    names = {(s.name, s.cat) for s in trace.spans()}
    assert ("map.extend", "mapper") in names
    assert any(n.endswith("plain") and c == "fn" for n, c in names)


def test_ring_wraparound_and_clear():
    trace.enable(capacity=8)
    for i in range(20):
        trace.instant(f"ev{i}", cat="t")
    assert [s.name for s in trace.spans()] == [f"ev{i}"
                                               for i in range(12, 20)]
    assert trace.dropped() == 12
    trace.counter("c", 1.0)
    trace.clear()
    assert trace.spans() == [] and trace.counters() == []
    assert trace.dropped() == 0
    trace.instant("fresh", cat="t")
    assert [s.name for s in trace.spans()] == ["fresh"]


def test_concurrent_workers_interleave_without_loss():
    trace.enable(capacity=4096)
    n_threads, n_spans = 4, 300
    start = threading.Barrier(n_threads)

    def work(widx):
        start.wait()
        for i in range(n_spans):
            with trace.span("w.step", cat="t", w=widx, i=i):
                pass

    threads = [threading.Thread(target=work, args=(w,), name=f"tw{w}")
               for w in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = trace.spans()
    assert len(spans) == n_threads * n_spans and trace.dropped() == 0
    by_tid = {}
    for s in spans:
        by_tid.setdefault(s.tid, []).append(s)
    assert set(by_tid) == {f"tw{w}" for w in range(n_threads)}
    for tid, ss in by_tid.items():
        assert all(s.args["w"] == int(tid[2:]) for s in ss)
        assert [s.args["i"] for s in ss] == list(range(n_spans))


def test_profiler_bridge_names_launches_in_a_torch_profile():
    from torch.profiler import ProfilerActivity, profile
    assert trace.annotate("gw.launch/global_affine") is trace._NOOP
    trace.enable_profiler_bridge()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.annotate("gw.launch/global_affine"):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "gw.launch/global_affine" in names


# -- metrics: the port's registry against JAX's ------------------------------
def _feed(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("req_total", channel="a")
    c.inc()
    c.inc(3)
    g = reg.gauge("depth")
    g.set(5)
    g.inc(2)
    g.dec()
    h = reg.histogram("lat")
    for v in [0.001 * i for i in range(1, 1000)] + [0.0, -1.0]:
        h.observe(v)
    reg.counter("gw_dead_letters_total", kind="retries").inc(2)
    return reg


def test_metrics_snapshot_and_prometheus_equal_jax():
    got, want = _feed(obs_metrics), _feed(jmetrics)
    assert got.snapshot() == want.snapshot()
    assert got.prometheus() == want.prometheus()
    json.dumps(got.snapshot())
    c = got.counter("req_total", channel="a")
    assert c.value == 4.0 and got.counter("req_total", channel="a") is c
    with pytest.raises(ValueError):
        c.inc(-1)


def test_histogram_percentiles_within_bucket_error():
    h = obs_metrics.MetricsRegistry().histogram("lat")
    h.observe(0.250)
    assert h.quantile(0.5) == pytest.approx(0.250)
    for v in [0.001 * i for i in range(1, 1000)]:
        h.observe(v)
    p = h.percentiles()
    root2 = 2.0 ** 0.5
    assert 0.5 / root2 <= p["p50"] <= 0.5 * root2
    assert 0.95 / root2 <= p["p95"] <= 0.999
    assert h.count == 1000 and h.min == 0.001 and h.max == 0.999


def test_compile_ledger_caps_oldest_first():
    led = obs_metrics.CompileLedger(cap=2)
    led.record("a", 1.0)
    led.record("b", 2.0)
    led.record("a", 0.5)
    led.record("c", 3.0)
    snap = led.snapshot()
    assert set(snap) == {"a", "c"}
    assert snap["a"] == {"compile_s": 1.5, "compiles": 2,
                         "calls": 0, "hits": 0}
    led.update_usage("a", calls=10, hits=9)
    led.update_usage("b", calls=5, hits=5)
    assert led.snapshot()["a"]["calls"] == 10
    led.clear()
    assert len(led) == 0


# -- the plan cache's compile ledger and totals ------------------------------
def test_compile_ledger_and_totals_survive_keep_stats_clear(rng):
    plan_mod.clear_plan_cache()
    trace.enable()
    svc = _svc(max_len=16, block=2)
    svc.submit(_req(0, rng, n=8))
    svc.submit(_req(1, rng, n=8))
    svc.drain()
    info = plan_mod.plan_cache_info()
    (key,) = [k for k in info["compile_ledger"] if "global_affine" in k]
    assert key == "global_affine/wavefront/16x16/b2/tb/align/p2/maxplus/cpu"
    entry = info["compile_ledger"][key]
    assert entry["compiles"] == 1 and entry["compile_s"] > 0.0
    (plan,) = info["plans"]
    assert plan["compile_s"] == entry["compile_s"]
    totals = info["totals"]
    assert totals["plans"] == 1 and totals["compiled"] == 1
    assert totals["compile_s"] == pytest.approx(entry["compile_s"])
    assert totals["calls"] == 1
    compile_spans = [s for s in trace.spans() if s.name == "plan.compile"]
    assert [s.args["key"] for s in compile_spans] == [key]

    plan_mod.clear_plan_cache(keep_stats=True)
    after = plan_mod.plan_cache_info()
    assert after["size"] == 0 and after["misses"] == info["misses"]
    assert after["compile_ledger"][key]["compile_s"] == entry["compile_s"]
    assert after["compile_ledger"][key]["calls"] == 1
    assert after["totals"] == totals           # retired, not lost
    # a warm restart: the plan compiles once more and adds to the totals
    svc.submit(_req(2, rng, n=8))
    svc.drain()
    again = plan_mod.plan_cache_info()
    assert again["totals"]["plans"] == 2 and again["totals"]["compiled"] == 2
    assert again["compile_ledger"][key]["compiles"] == 2
    assert svc.metrics()["plan_cache"] == again["totals"]
    plan_mod.clear_plan_cache()
    assert plan_mod.plan_cache_info()["totals"]["plans"] == 0
    assert plan_mod.plan_cache_info()["compile_ledger"] == {}


def test_compile_s_is_stamped_once_under_concurrent_first_calls(rng):
    plan_mod.clear_plan_cache()
    from repro_torch.core import kernels_zoo
    spec, params = kernels_zoo.make(2)
    plan = plan_mod.get_plan(spec, "wavefront", (16,), (16,), batch_size=2,
                             device="cpu")
    q = torch.as_tensor(rng.integers(0, 4, (2, 16)).astype(np.uint8))
    start = threading.Barrier(4)

    def call():
        start.wait()
        plan(params, q, q, [16, 16], [16, 16])

    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert plan.calls == 4
    info = plan_mod.plan_cache_info()
    assert info["totals"]["compiled"] == 1
    (entry,) = info["compile_ledger"].values()
    assert entry["compiles"] == 1
    plan_mod.clear_plan_cache()


def test_warm_plan_moves_the_first_dispatch_to_boot(rng):
    from repro_torch.core import kernels_zoo
    from repro_torch.tune import warm_grid, warm_plan
    plan_mod.clear_plan_cache()
    spec, params = kernels_zoo.make(2)
    plan = warm_plan(spec, params, "wavefront", (32,), (32,), batch_size=4,
                     device="cpu")
    assert plan.compile_s is not None and plan.calls == 1
    assert warm_plan(spec, params, "wavefront", (32,), (32,), batch_size=4,
                     device="cpu") is plan
    assert plan.calls == 1                     # already hot: no dispatch
    assert warm_grid(spec, params, "wavefront",
                     [((16, 16), 4), ((32, 32), 4)], device="cpu") == 1
    svc = _svc(max_len=32, block=4, prefilter=0.3,
               warm_start=[("global_affine", (20, 30))])
    keys = {plan_mod.plan_key_str(k) for k in plan_mod.plan_cache_info()
            ["keys"]}
    assert "edit_search/myers/32x32/b4/notb/fill/p1/minplus/cpu" in keys
    before = plan_mod.plan_cache_info()["totals"]["compiled"]
    fut = svc.submit(AlignRequest(0, "global_affine",
                                  np.zeros(20, np.uint8),
                                  np.zeros(30, np.uint8)))
    assert "score" in fut.result()
    assert plan_mod.plan_cache_info()["totals"]["compiled"] == before
    plan_mod.clear_plan_cache()


# -- export ------------------------------------------------------------------
def test_chrome_trace_export_schema_and_tracks():
    trace.enable()
    with trace.span("gw.launch", cat="gateway", worker="w0", n=4):
        trace.instant("gw.retry", cat="gateway")
    trace.counter("gw.queue_depth", 3)
    obj = obs_export.to_chrome_trace()
    assert obs_export.validate_chrome_trace(obj) == []
    assert jexport.validate_chrome_trace(obj) == []
    evs = obj["traceEvents"]
    assert {e["ph"] for e in evs} == {"M", "X", "i", "C"}
    assert min(e["ts"] for e in evs if e["ph"] != "M") == 0.0
    (x,) = [e for e in evs if e["ph"] == "X"]
    assert x["dur"] >= 0 and x["args"]["worker"] == "w0"
    (c,) = [e for e in evs if e["ph"] == "C"]
    assert c["tid"] == 0 and c["args"] == {"value": 3.0}
    json.dumps(obj)


def test_validate_chrome_trace_catches_malformed():
    bad = {"traceEvents": [
        {"ph": "X", "pid": 1},
        {"name": "a", "ph": "Z", "pid": 1, "ts": 0},
        {"name": "b", "ph": "X", "pid": 1, "ts": 0, "dur": -1},
        {"name": "c", "ph": "X", "pid": 1, "ts": -5, "dur": 1},
        {"name": "d", "ph": "C", "pid": 1, "ts": 0, "args": {}},
    ]}
    assert obs_export.validate_chrome_trace([]) == \
        jexport.validate_chrome_trace([])
    assert obs_export.validate_chrome_trace(bad) == \
        jexport.validate_chrome_trace(bad)
    assert len(obs_export.validate_chrome_trace(bad)) == 5


# -- the gateway, dispatcher, plan and mapper spans --------------------------
def test_gateway_and_dispatch_spans_and_metrics_reconcile(tmp_path, rng):
    plan_mod.clear_plan_cache()
    trace.enable()
    svc = _svc(max_len=16, block=2)
    n = 6
    for i in range(n):
        svc.submit(_req(i, rng, n=8))
    svc.drain()
    m = svc.metrics()
    assert m["reconcile"] == {"submitted": n, "resolved": n,
                              "dead_lettered": 0, "ok": True}
    counters = m["metrics"]["counters"]
    assert counters["gw_submitted_total"] == n
    assert counters["gw_completed_total"] == n
    lat = m["metrics"]["histograms"]["gw_latency_s{outcome=completed}"]
    assert lat["count"] == n and lat["p50"] > 0.0
    assert m["plan_cache"]["calls"] == 3
    json.dumps(m)
    names = {s.name for s in trace.spans()}
    assert {"gw.form", "gw.launch", "gw.harvest", "dispatch.launch",
            "dispatch.harvest", "plan.compile"} <= names
    obj = svc.dump_trace(str(tmp_path / "trace.json"))
    assert obs_export.validate_chrome_trace(obj) == []
    assert json.loads((tmp_path / "trace.json").read_text()) == \
        json.loads(json.dumps(obj))
    text = svc.prometheus()
    assert f"gw_submitted_total {n}" in text
    assert "# TYPE gw_latency_s summary" in text


def test_gateway_metrics_reconcile_with_dead_letters(rng):
    svc = _svc(max_len=16, block=2, max_retries=0,
               fault_plan=FaultPlan(seed=1, fail_launch_p=1.0))
    fut = svc.submit(_req(0, rng, n=8))
    with pytest.raises(InjectedFault):
        svc.drain()
    assert fut.result()["failed"]
    m = svc.metrics()
    rec = m["reconcile"]
    assert rec["ok"] and rec["submitted"] == 1 and rec["dead_lettered"] == 1
    assert m["metrics"]["counters"][
        "gw_dead_letters_total{kind=retries}"] == 1
    assert m["dead_letters_by_kind"] == {"retries": 1}
    (d,) = svc.dead_letters
    assert d["worker"] == "w0" and d["attempts"] == 1
    assert isinstance(d["ts"], float)


def test_shed_dead_letter_attributed_to_submit(rng):
    svc = _svc(max_len=16, block=2, max_pending=1, backpressure="shed")
    svc.submit(_req(0, rng, n=8))
    f1 = svc.submit(_req(1, rng, n=8))
    assert f1.result()["error"]["kind"] == "shed"
    (d,) = svc.dead_letters
    assert d["kind"] == "shed" and d["worker"] == "submit"
    assert svc.metrics()["reconcile"]["submitted"] == 2
    svc.drain()
    assert svc.metrics()["reconcile"]["ok"]


def test_mapper_spans():
    from repro_torch.core import alphabets
    from repro_torch.mapping import ReadMapper
    rng = np.random.default_rng(3)
    ref = alphabets.random_dna(rng, 2000)
    reads = [ref[s:s + 60].copy() for s in (100, 700, 1300)]
    reads.append(alphabets.random_dna(rng, 60))
    trace.enable()
    ReadMapper(ref, device="cpu").map_reads(reads)
    spans = {s.name: s for s in trace.spans() if s.cat == "mapper"}
    assert set(spans) == {"map.seed_chain", "map.screen", "map.extend"}
    assert spans["map.seed_chain"].args == {"n": 4}
    assert spans["map.extend"].args["n"] <= spans["map.screen"].args["n"]
