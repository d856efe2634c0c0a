"""The port's serving gateway and alignment service against the JAX
package's, on the CPU.

Two kinds of case.  The gateway's own contract (deterministic FaultPlan
decisions, bounded retries ending in typed dead letters, deadlines,
newest-first shedding, degrade-to-myers answers, heartbeat redispatch,
kill-then-recover with zero double completions, pipelined drains equal to
the synchronous one) is run on the port's ``AlignmentService`` exactly as
``tests/test_gateway.py`` and ``tests/test_ft_serve.py`` run it on JAX's.
Results are then held to JAX's service request for request, on the same
seeded stream: score, end cell, CIGAR and the ``filtered`` / ``degraded``
flags must be equal.  K1 picks the row-major first optimum as JAX's
``reference`` engine does, not XLA ``wavefront``'s first anti-diagonal
(ROADMAP queue 3, "End-cell tie-break"), so exact results are held to JAX's
service built with ``engine_name="reference"``; against the default
``wavefront`` engine the port is held on scores and flags only.
"""
from __future__ import annotations

import time

import numpy as np
import pytest

from repro.serve import AlignRequest as JRequest
from repro.serve import AlignmentService as JService
from repro.serve import FaultPlan as JFaultPlan
from repro_torch.ft import ALIVE, DEAD, STRAGGLER, HeartbeatMonitor
from repro_torch.runtime import plan as plan_mod
from repro_torch.serve import (AlignRequest, AlignmentService, FaultPlan,
                               GenotypeRequest, GenotypingService,
                               InflightBatch, InjectedFault, WorkerKilled)
from repro_torch.serve import alignment_service as svc_mod


def _svc(**kw):
    return AlignmentService(device="cpu", **kw)


def _req(rid, rng, n=12, kernel="global_affine"):
    return AlignRequest(rid=rid, kernel=kernel,
                        query=rng.integers(0, 4, n).astype(np.uint8),
                        ref=rng.integers(0, 4, n + 2).astype(np.uint8))


def _stream(seed, n=24):
    """(rid, kernel, query, ref) of a mixed stream: two kernels, lengths
    over three buckets, a third of the pairs identical (they pass any
    screen), the rest unrelated (a 0.2 screen rejects most)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        m = int(rng.integers(8, 48))
        q = rng.integers(0, 4, m).astype(np.uint8)
        if i % 3 == 0:
            r = q.copy()
        elif i % 3 == 1:
            r = np.concatenate([q[: m // 2], rng.integers(0, 4, 3),
                                q[m // 2:]]).astype(np.uint8)
        else:
            r = rng.integers(0, 4, int(rng.integers(8, 56))).astype(np.uint8)
        out.append((i, "local_affine" if i % 4 == 3 else "global_affine",
                    q, r))
    return out


def _drain(service, request, stream, **kw):
    svc = service(**kw)
    reqs = [request(rid=i, kernel=k, query=q, ref=r)
            for i, k, q, r in stream]
    for r in reqs:
        svc.submit(r)
    svc.drain()
    return [r.result for r in reqs], list(svc.dispatches), svc


def _port_and_jax(stream, **kw):
    got, gd, _ = _drain(AlignmentService, AlignRequest, stream,
                        device="cpu", **kw)
    jkw = dict(kw, engine_name="reference")
    want, wd, _ = _drain(JService, JRequest, stream, **jkw)
    return got, want, gd, wd


# -- results equal JAX's, request for request --------------------------------
CONFIGS = {
    "plain": dict(max_len=64, block=4),
    "no_coalesce": dict(max_len=64, block=4, coalesce=False),
    "sync": dict(max_len=64, block=4, pipeline_depth=1),
    "prefilter": dict(max_len=64, block=4, prefilter=0.2),
    "tb_budget": dict(max_len=64, block=2, tb_budget_bytes=24_000,
                      max_block=16),
    "score_only": dict(max_len=64, block=4, with_traceback=False),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_results_equal_jax_reference_service(name):
    stream = _stream(1)
    got, want, gd, wd = _port_and_jax(stream, **CONFIGS[name])
    for rid, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"request {rid}: port {g} != JAX {w}"
        assert type(g["score"]) is float
        assert all(type(x) is int for x in g["end"])
    if name == "tb_budget":
        # the budget counts K1's ('chunk', 32, pack) store, the layout of
        # JAX's Pallas kernel, not the XLA engines' 'diag' store: the
        # batches differ from JAX's reference service, the results do not
        from repro.core import kernels_zoo as jzoo
        from repro.runtime import plan as jplan
        svc = AlignmentService(device="cpu", **CONFIGS[name])
        for kernel in ("global_affine", "local_affine"):
            jspec, _ = jzoo.make(kernel)
            for bucket in ((16, 16), (32, 64), (64, 64)):
                per = jplan.traceback_bytes(jspec, *bucket,
                                            engine_name="pallas")
                assert svc.block_for(kernel, bucket) == \
                    max(2, min(16, 24_000 // per))
        assert max(d["n"] for d in gd) > 2
    else:
        assert gd == wd                   # the same batches, in order
    if name == "prefilter":
        assert sum(bool(g.get("filtered")) for g in got) >= 4
        assert any("cigar" in g for g in got)


def test_scores_equal_jax_wavefront_service():
    """Against JAX's default XLA wavefront engine: scores and flags (end
    cells may differ on ties, see the module docstring)."""
    stream = _stream(2)
    kw = dict(max_len=64, block=4, prefilter=0.2)
    got, _, _ = _drain(AlignmentService, AlignRequest, stream, device="cpu",
                       **kw)
    want, _, _ = _drain(JService, JRequest, stream, **kw)
    for g, w in zip(got, want):
        assert g["score"] == w["score"]
        assert bool(g.get("filtered")) == bool(w.get("filtered"))


def test_filtered_requests_keep_jax_types(rng):
    q = rng.integers(0, 4, 30).astype(np.uint8)
    r = rng.integers(0, 4, 30).astype(np.uint8)
    svc = _svc(max_len=32, block=2, prefilter=0.1)
    fut = svc.submit(AlignRequest(0, "global_affine", q, r))
    res = fut.result()
    jsvc = JService(max_len=32, block=2, prefilter=0.1)
    want = jsvc.submit(JRequest(0, "global_affine", q, r)).result()
    assert res == want and res["filtered"] is True
    assert type(res["score"]) is float and res["end"] == (0, 0)
    assert all(type(x) is int for x in res["end"])
    assert svc.stats["filtered"] == 1
    assert svc.metrics()["reconcile"]["ok"]


def test_degrade_results_equal_jax(rng):
    stream = _stream(3, n=12)
    kw = dict(max_len=64, block=4, degrade="myers", degrade_watermark=6,
              coalesce=False)
    got, gd, svc = _drain(AlignmentService, AlignRequest, stream,
                          device="cpu", **kw)
    want, wd, _ = _drain(JService, JRequest, stream,
                         engine_name="reference", **kw)
    assert got == want and gd == wd
    degraded = [g for g in got if g.get("degraded")]
    assert degraded and len(degraded) < len(got)
    assert svc.stats["degraded"] == len(degraded)
    # each degraded answer is the exact semiglobal edit distance: plain
    # K2's last-row best with no threshold
    import torch
    from repro_torch.kernels.myers import kernel as K2
    for (_, _, q, r), g in zip(stream, got):
        if not g.get("degraded"):
            continue
        lens = torch.tensor([[len(q), len(r)]], dtype=torch.int32)
        _, best, _ = K2.myers_fill_plain(torch.as_tensor(q)[None],
                                         torch.as_tensor(r)[None], lens,
                                         glob=False, k=-1)
        assert g["edit_distance"] == int(best[0])
        assert g["score"] == -float(g["edit_distance"])


def test_fault_plan_decisions_equal_jax():
    kw = dict(seed=7, fail_launch_p=0.5, fail_harvest_p=0.3,
              latency_s=0.1, latency_p=0.5, kill={"w0": 3, "w1": (1, 4)})
    a, b = FaultPlan(**kw), JFaultPlan(**kw)
    for w in ("w0", "w1", "w2"):
        for s in range(32):
            assert a.kills(w, s) == b.kills(w, s)
            assert a.fails_launch(w, s) == b.fails_launch(w, s)
            assert a.fails_harvest(w, s) == b.fails_harvest(w, s)
            assert a.harvest_latency(w, s) == b.harvest_latency(w, s)


# -- the gateway's contract on the port (tests/test_gateway.py) --------------
def test_fault_plan_is_deterministic():
    a = FaultPlan(seed=7, fail_launch_p=0.5, fail_harvest_p=0.5,
                  latency_s=0.1, latency_p=0.5)
    b = FaultPlan(seed=7, fail_launch_p=0.5, fail_harvest_p=0.5,
                  latency_s=0.1, latency_p=0.5)
    for w in ("w0", "w1"):
        for s in range(32):
            assert a.fails_launch(w, s) == b.fails_launch(w, s)
            assert a.fails_harvest(w, s) == b.fails_harvest(w, s)
            assert a.harvest_latency(w, s) == b.harvest_latency(w, s)
    assert {a.fails_launch("w0", s) for s in range(64)} == {True, False}
    c = FaultPlan(seed=8, fail_launch_p=0.5)
    assert any(a.fails_launch("w0", s) != c.fails_launch("w0", s)
               for s in range(64))


def test_fault_plan_kill_schedule():
    fp = FaultPlan(kill={"w0": 3, "w1": (1, 4)})
    assert fp.kills("w0", 3) and not fp.kills("w0", 2)
    assert fp.kills("w1", 1) and fp.kills("w1", 4) and not fp.kills("w1", 2)
    assert not fp.kills("w9", 0)


def test_bounded_retries_dead_letter_align(rng):
    svc = _svc(max_len=32, block=2, max_retries=1,
               fault_plan=FaultPlan(seed=1, fail_launch_p=1.0))
    fut = svc.submit(_req(0, rng))
    for _ in range(2):
        with pytest.raises(InjectedFault):
            svc.drain()
    res = fut.result()
    assert res["failed"] and res["error"]["kind"] == "retries"
    assert svc._pending == 0
    assert [d["rid"] for d in svc.dead_letters] == [0]
    assert svc.dead_letters[0]["kind"] == "retries"
    assert svc.stats["retries"] == 1
    assert svc.drain() == 0


def test_bounded_retries_dead_letter_genotyping():
    svc = GenotypingService(max_len=32, block=8, max_retries=0,
                            fault_plan=FaultPlan(seed=2, fail_launch_p=1.0),
                            device="cpu")
    fut = svc.submit(GenotypeRequest(
        rid=5, reads=[np.ones(8, np.uint8)] * 2,
        haplotypes=[np.ones(8, np.uint8)] * 2))
    with pytest.raises(InjectedFault):
        svc.drain()
    res = fut.result()
    assert res["failed"] and res["error"]["kind"] == "retries"
    assert len(svc.dead_letters) == 1
    assert svc._pending == 0
    assert svc.drain() == 0


def test_retry_backoff_gates_requeue(rng, monkeypatch):
    svc = _svc(max_len=32, block=2, max_retries=5, retry_backoff_s=10.0)
    t = {"now": 0.0}
    svc._clock = lambda: t["now"]
    req = _req(0, rng)
    svc.submit(req)
    real_get_plan = plan_mod.get_plan
    boom = {"armed": True}

    def failing_get_plan(*a, **kw):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("transient")
        return real_get_plan(*a, **kw)

    monkeypatch.setattr(plan_mod, "get_plan", failing_get_plan)
    with pytest.raises(RuntimeError, match="transient"):
        svc.drain()
    assert req.attempts == 1
    assert req.not_before == pytest.approx(10.0)
    assert svc.drain() == 0
    assert req.result is None
    t["now"] = 11.0
    assert svc.drain() == 1
    assert req.result is not None and "score" in req.result


def test_deadline_dead_letters_on_dispatch(rng):
    svc = _svc(max_len=32, block=2, deadline_s=5.0)
    t = {"now": 0.0}
    svc._clock = lambda: t["now"]
    fut = svc.submit(_req(0, rng))
    assert fut.req.deadline == pytest.approx(5.0)
    t["now"] = 10.0
    assert svc.drain() == 0
    res = fut.result()
    assert res["failed"] and res["error"]["kind"] == "deadline"
    assert svc._pending == 0
    assert svc.dead_letters[0]["kind"] == "deadline"


def test_deadline_sweep_on_idle_queue(rng):
    svc = _svc(max_len=32, block=2, deadline_s=2.0)
    t = {"now": 0.0}
    svc._clock = lambda: t["now"]
    futs = [svc.submit(_req(i, rng)) for i in range(3)]
    assert svc.sweep_deadlines() == 0
    t["now"] = 3.0
    assert svc.sweep_deadlines() == 3
    assert all(f.result()["error"]["kind"] == "deadline" for f in futs)
    assert svc._pending == 0


def test_harvest_timeout_reclaims_batch(rng):
    svc = _svc(max_len=32, block=2, harvest_timeout_s=5.0)
    t = {"now": 0.0}
    svc._clock = lambda: t["now"]
    req = _req(0, rng)
    svc.submit(req)
    svc._launch("w_wedged", svc._next_batch())
    assert svc.redispatch_timed_out() == 0
    t["now"] = 6.0
    assert svc.redispatch_timed_out() == 1
    assert req.gen == 1 and req.attempts == 1
    assert svc.inflight == {}
    assert svc.drain(worker="w_ok") == 1
    assert req.result is not None


def test_backpressure_shed_rejects_newest(rng):
    svc = _svc(max_len=32, block=2, max_pending=2, backpressure="shed")
    f0 = svc.submit(_req(0, rng))
    f1 = svc.submit(_req(1, rng))
    f2 = svc.submit(_req(2, rng))
    assert f2.done() and f2.result()["error"]["kind"] == "shed"
    assert not f0.done() and not f1.done()
    assert svc._pending == 2 and svc.stats["shed"] == 1
    assert svc.drain() == 2
    assert "score" in f0.result() and "score" in f1.result()


def test_degrade_to_myers_past_watermark(rng):
    svc = _svc(max_len=32, block=4, degrade="myers", degrade_watermark=3,
               coalesce=False)
    q = rng.integers(0, 4, 12).astype(np.uint8)
    futs = [svc.submit(AlignRequest(rid=i, kernel="global_affine",
                                    query=q, ref=q))
            for i in range(4)]
    assert svc.drain() == 0
    for f in futs:
        res = f.result()
        assert res["degraded"] is True
        assert res["edit_distance"] == 0 and res["score"] == 0.0
    assert svc._pending == 0 and svc.stats["degraded"] == 4
    assert any(d.get("degraded") for d in svc.dispatches)


def test_degrade_off_below_watermark(rng):
    svc = _svc(max_len=32, block=4, degrade="myers", degrade_watermark=100)
    fut = svc.submit(_req(0, rng))
    svc.drain()
    assert "degraded" not in fut.result() and "score" in fut.result()


def test_worker_kill_leaves_window_for_heartbeat_reclaim(rng):
    svc = _svc(max_len=32, block=2, pipeline_depth=2, coalesce=False,
               redispatch_after=5.0, fault_plan=FaultPlan(kill={"w0": 1}))
    futs = [svc.submit(_req(i, rng)) for i in range(6)]
    with pytest.raises(WorkerKilled):
        svc.drain(worker="w0")
    assert len(svc.inflight["w0"]) == 1
    assert svc.stats["killed"] == [{"worker": "w0", "seq": 1}]
    assert svc.redispatch_dead(now=time.time() + 1000.0) == 2
    assert svc.inflight == {}
    assert svc.drain(worker="w1") == 6
    assert all(f.done() for f in futs)
    assert svc.stats["completed"] == 6 and svc._pending == 0


def test_serve_pool_completes_and_matches_inline_and_jax():
    stream = _stream(4, n=24)
    inline, _, _ = _drain(AlignmentService, AlignRequest, stream,
                          device="cpu", max_len=64, block=4, coalesce=False)
    svc = _svc(max_len=64, block=4, coalesce=False)
    reqs = [AlignRequest(rid=i, kernel=k, query=q, ref=r)
            for i, k, q, r in stream]
    for r in reqs:
        svc.submit(r)
    stats = svc.serve(n_workers=3, timeout_s=120.0)
    assert stats["completed"] == 24
    assert svc._pending == 0 and svc.inflight == {}
    assert [r.result for r in reqs] == inline
    want, _, _ = _drain(JService, JRequest, stream, engine_name="reference",
                        max_len=64, block=4, coalesce=False)
    assert inline == want


def test_serve_elastic_respawns_killed_worker(rng):
    svc = _svc(max_len=64, block=2, coalesce=False, redispatch_after=0.5,
               fault_plan=FaultPlan(kill={"w0": 0}))
    assert svc.warm([("global_affine", (12, 14))]) == 1
    futs = [svc.submit(_req(i, rng)) for i in range(12)]
    stats = svc.serve(n_workers=2, timeout_s=120.0, elastic=True,
                      max_workers=4)
    assert all("score" in f.result() for f in futs)
    assert stats["killed"][0]["worker"] == "w0"
    assert stats["respawned"]
    assert svc._pending == 0 and svc.inflight == {}


def test_chaos_run_is_bit_identical_and_reconciles():
    """A kill plus seeded launch failures under serve(): the results equal
    the clean run's bit for bit, nothing completes twice, and submitted ==
    resolved + dead_lettered."""
    stream = _stream(5, n=32)
    kw = dict(max_len=64, block=4, prefilter=0.2)
    clean, _, _ = _drain(AlignmentService, AlignRequest, stream,
                         device="cpu", **kw)
    svc = _svc(redispatch_after=0.75, max_retries=8,
               fault_plan=FaultPlan(seed=0, kill={"w0": 1},
                                    fail_launch_p=0.1), **kw)
    svc.warm([(k, (bq, br)) for k in ("global_affine", "local_affine")
              for bq in (16, 32, 64) for br in (16, 32, 64)])
    reqs = [AlignRequest(rid=i, kernel=k, query=q, ref=r)
            for i, k, q, r in stream]
    for r in reqs:
        svc.submit(r)
    stats = svc.serve(n_workers=2, timeout_s=120.0)
    assert [r.result for r in reqs] == clean
    assert stats["killed"] == [{"worker": "w0", "seq": 1}]
    assert stats["faults"] > 0
    rec = svc.metrics()["reconcile"]
    assert rec["ok"] and rec["submitted"] == len(reqs)
    assert rec["dead_lettered"] == 0
    assert stats["completed"] + stats["filtered"] == len(reqs)


def test_serve_pool_stress_with_many_workers_and_short_switch_interval():
    """Eight workers on a shortened switch interval: every request
    resolves exactly once (a lost update of the shared queues, pending
    count or stats would break the counts) with the inline results."""
    import sys
    stream = _stream(8, n=20)
    inline, _, _ = _drain(AlignmentService, AlignRequest, stream,
                          device="cpu", max_len=64, block=2, prefilter=0.2)
    svc = _svc(max_len=64, block=2, prefilter=0.2)
    reqs = [AlignRequest(rid=i, kernel=k, query=q, ref=r)
            for i, k, q, r in stream]
    for r in reqs:
        svc.submit(r)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        stats = svc.serve(n_workers=8, timeout_s=120.0)
    finally:
        sys.setswitchinterval(old)
    assert [r.result for r in reqs] == inline
    assert stats["completed"] + stats["filtered"] == len(reqs)
    assert svc._pending == 0 and svc.inflight == {}
    assert svc.metrics()["reconcile"]["ok"]


# -- the service half of tests/test_ft_serve.py ------------------------------
def test_heartbeat_states():
    m = HeartbeatMonitor(dead_after=10.0, straggler_factor=3.0)
    for t in range(5):
        m.beat("w0", now=float(t))
        m.beat("w1", now=float(t))
    m.beat("w0", now=5.0)
    assert m.status("w0", now=5.5) == ALIVE
    assert m.status("w1", now=8.9) == STRAGGLER
    assert m.status("w1", now=15.1) == DEAD
    assert m.status("unknown", now=0.0) == DEAD
    assert m.dead_workers(now=14.9) == ["w1"]
    assert m.alive_workers(now=7.5) == ["w0"]


def test_heartbeat_forget_drops_worker_and_median_skew():
    m = HeartbeatMonitor(dead_after=200.0, straggler_factor=3.0)
    for t in range(5):
        m.beat("w0", now=float(t))
        m.beat("slow", now=float(t) * 100.0)
    assert m.status("w0", now=8.0) == ALIVE
    assert m.forget("slow") is True
    assert m.status("w0", now=8.0) == STRAGGLER
    assert m.status("slow", now=8.0) == DEAD
    assert m.forget("slow") is False


def test_alignment_service_end_to_end(rng):
    from repro_torch.core import kernels_zoo
    from repro_torch.core.api import align
    svc = _svc(max_len=64, block=4)
    qs = [rng.integers(0, 4, rng.integers(10, 40)).astype(np.uint8)
          for _ in range(10)]
    rs = [rng.integers(0, 4, rng.integers(10, 40)).astype(np.uint8)
          for _ in range(10)]
    for i in range(10):
        svc.submit(AlignRequest(rid=i, kernel="global_affine",
                                query=qs[i], ref=rs[i]))
    svc.submit(AlignRequest(rid=10, kernel="local_linear",
                            query=qs[0], ref=rs[0]))
    reqs = [r for q in svc.queues.values() for r in q]
    assert svc.drain() == 11
    spec, params = kernels_zoo.make("global_affine")
    for r in reqs:
        if r.kernel != "global_affine":
            continue
        direct = align(spec, params, r.query, r.ref, with_traceback=False,
                       device="cpu")
        assert r.result["score"] == float(direct.score)


def _fake_inflight(svc, worker, req):
    ib = InflightBatch(worker=worker, kernel=req.kernel, bucket=(16, 16),
                       reqs=[req], gens=[req.gen], out=None)
    svc.inflight.setdefault(worker, []).append(ib)
    return ib


def test_alignment_service_redispatch():
    svc = _svc(max_len=32, block=2, redispatch_after=5.0)
    svc.monitor.beat("w1", now=0.0)
    req = AlignRequest(0, "global_affine", np.zeros(4, np.uint8),
                       np.zeros(4, np.uint8))
    _fake_inflight(svc, "w1", req)
    assert svc.redispatch_dead(now=1.0) == 0
    assert svc.redispatch_dead(now=20.0) == 1
    requeued = [r for (k, _), q in svc.queues.items()
                if k == "global_affine" for r in q]
    assert len(requeued) == 1 and requeued[0].gen == 1


def test_redispatch_discards_late_original_result(rng):
    svc = _svc(max_len=32, block=2, redispatch_after=5.0)
    req = AlignRequest(0, "global_affine",
                       rng.integers(0, 4, 12).astype(np.uint8),
                       rng.integers(0, 4, 12).astype(np.uint8))
    item = ("global_affine", (16, 16), [req], False, svc.block)
    stale = svc._launch("w1", item)
    svc.monitor._last["w1"] = 0.0
    assert svc.redispatch_dead(now=100.0) == 1
    assert req.gen == 1 and req.result is None
    assert svc.drain(worker="w2") == 1
    first = req.result
    assert svc._harvest(item, stale) == 0
    assert req.result is first


def test_drain_requeues_requests_on_dispatch_failure(rng, monkeypatch):
    svc = _svc(max_len=64, block=4)
    reqs = [AlignRequest(rid=i, kernel="global_affine",
                         query=rng.integers(0, 4, 20).astype(np.uint8),
                         ref=rng.integers(0, 4, 20).astype(np.uint8))
            for i in range(6)]
    for r in reqs:
        svc.submit(r)
    real_get_plan = plan_mod.get_plan

    def exploding_get_plan(*a, **kw):
        raise RuntimeError("injected dispatch failure")

    monkeypatch.setattr(plan_mod, "get_plan", exploding_get_plan)
    with pytest.raises(RuntimeError, match="injected"):
        svc.drain()
    assert len([r for q in svc.queues.values() for r in q]) == 6
    assert svc.inflight == {}
    monkeypatch.setattr(plan_mod, "get_plan", real_get_plan)
    assert svc.drain() == 6
    assert all(r.result is not None for r in reqs)


def test_wait_requeues_window_on_harvest_failure(rng, monkeypatch):
    svc = _svc(max_len=64, block=2, pipeline_depth=3)
    reqs = [AlignRequest(rid=i, kernel="global_affine",
                         query=rng.integers(0, 4, 20).astype(np.uint8),
                         ref=rng.integers(0, 4, 20).astype(np.uint8))
            for i in range(6)]
    for r in reqs:
        svc.submit(r)
    boom = {"armed": True}
    real_cigar = svc_mod.moves_to_cigar

    def exploding_cigar(moves, n_moves):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected harvest failure")
        return real_cigar(moves, n_moves)

    monkeypatch.setattr(svc_mod, "moves_to_cigar", exploding_cigar)
    with pytest.raises(RuntimeError, match="injected"):
        svc.drain()
    assert len([r for q in svc.queues.values() for r in q]) == 6
    assert svc.inflight == {}
    assert svc.drain() == 6
    assert all(r.result is not None for r in reqs)


def test_submit_returns_future(rng):
    svc = _svc(max_len=64, block=4)
    fut = svc.submit(_req(0, rng, n=20))
    assert not fut.done()
    res = fut.result()
    assert fut.done() and res is fut.req.result
    assert "score" in res and "cigar" in res
    with pytest.raises(ValueError, match="exceed max_len"):
        svc.submit(AlignRequest(rid=1, kernel="global_affine",
                                query=np.zeros(80, np.uint8),
                                ref=np.zeros(10, np.uint8)))


def test_sync_vs_pipelined_drain_equivalence():
    stream = _stream(6)
    results, dispatches = {}, {}
    for depth in (1, 2, 4):
        results[depth], dispatches[depth], _ = _drain(
            AlignmentService, AlignRequest, stream, device="cpu",
            max_len=64, block=4, pipeline_depth=depth)
    assert any(d["coalesced"] for d in dispatches[1])
    for depth in (2, 4):
        assert results[depth] == results[1]
        assert dispatches[depth] == dispatches[1]


def test_pipelined_drain_after_redispatch_matches_sync():
    stream = _stream(7, n=8)
    sync, _, _ = _drain(AlignmentService, AlignRequest, stream,
                        device="cpu", max_len=64, block=4, pipeline_depth=1)
    svc = _svc(max_len=64, block=4, pipeline_depth=2, redispatch_after=5.0)
    reqs = [AlignRequest(rid=i, kernel=k, query=q, ref=r)
            for i, k, q, r in stream]
    futs = [svc.submit(r) for r in reqs]
    item = svc._next_batch()
    svc._launch("w_dead", item)
    svc.monitor._last["w_dead"] = 0.0
    assert svc.redispatch_dead(now=100.0) == len(item[2])
    assert svc.drain(worker="w_ok") == len(reqs)
    assert all(f.done() for f in futs)
    assert [r.result for r in reqs] == sync


# -- what the port refuses ---------------------------------------------------
def test_mesh_is_refused_by_name():
    with pytest.raises(ValueError, match="item 14"):
        AlignmentService(mesh=object(), device="cpu")


@pytest.mark.skipif(__import__("torch").cuda.is_available(),
                    reason="checks the refusal on a machine without CUDA")
def test_cuda_default_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AlignmentService()
