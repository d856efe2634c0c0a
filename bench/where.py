"""Where one cell's calls spend their time, by the program's spans.

    python3 bench/where.py --workload sw_affine_dna.short_b262144 --seed 7

From the root of a checkout, on the card.  In one process:

1. set-up as ``bench/run.py`` makes it, its first calls (each block of
   the pool once) under the program's ring (``repro_torch.obs.trace``),
   summed by span name: K1's library (``k1.library``), each plan's first
   dispatch (``plan.compile``), the entry's calls (``batch.align``) and
   their parts;
2. calls for ``--seconds`` as the window makes them, then a traced
   segment as a ``--trace 1`` run makes it (``harness._traced``), read
   by every per-layer metric (``bench/spans.py``): each idle gap of the
   device cut at the spans' edges and summed by the innermost span, each
   gap of 0.5 ms or more by the shortest span holding it whole, and each
   blocking CUDA runtime call by the innermost span at its midpoint;
3. what the spans cost: the host's milliseconds a call on an idle card
   (a call submitted with nothing queued, then harvested), with the ring
   off and on in turns, and the microseconds of one span with each sink
   off or on.

Prints one JSON object.  The benchmark's own runs never run this; it
works beside a program that emits no span, and then names nothing.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GAP_US = 500.0               # the idle gaps named one by one


def _setup_spans(obs_trace) -> dict:
    """The ring's spans summed by name: {name: [count, seconds]}."""
    out: dict = {}
    for s in obs_trace.spans():
        if s.t1 is not None:
            row = out.setdefault(s.name, [0, 0.0])
            row[0] += 1
            row[1] += s.t1 - s.t0
    return out


def _idle_host_ms(caller, n_blocks: int, calls: int, sync,
                  obs_trace) -> dict:
    """Median host milliseconds of ``submit`` with nothing queued, with
    the ring off and on in turns."""
    times: dict = {"ring_off_ms": [], "ring_on_ms": []}
    for i in range(2 * calls):
        on = i % 2 == 1
        if on:
            obs_trace.enable()
        sync()
        t = time.perf_counter()
        pending = caller.submit(i // 2 % n_blocks)
        times["ring_on_ms" if on else "ring_off_ms"].append(
            time.perf_counter() - t)
        obs_trace.disable()
        caller.harvest(pending)
    obs_trace.clear()
    return {k: statistics.median(v) * 1e3 for k, v in times.items()}


def _span_us(obs_trace, cuda: bool, n: int = 5000) -> dict:
    """Microseconds of one ``with span(...)`` with both sinks off, the
    ring on, a profiler recording (the card's activity too, as a
    ``--trace 1`` run records it), and both."""
    import torch

    def loop():
        t = time.perf_counter()
        for _ in range(n):
            with obs_trace.span("where.cost", cat="where"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    out = {"off": loop()}
    obs_trace.enable(capacity=n)
    out["ring"] = loop()
    obs_trace.disable()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        out["profiler"] = loop()
        obs_trace.enable(capacity=n)
        out["both"] = loop()
        obs_trace.disable()
    obs_trace.clear()
    return out


def where(cell, seed: int, seconds: float, idle_calls: int,
          device: str = "cuda") -> dict:
    import torch
    from bench import harness, load_module, spans, trace as trace_mod
    from bench import traffic as traffic_mod
    from repro_torch.obs import trace as obs_trace
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    host = harness.apply_host(cell.config)
    if cuda:
        torch.empty(1, device=dev)
    pool = traffic_mod.make_pool(cell.traffic, seed, cell.bench_dir)
    blocks = harness.Blocks(pool, pin=cuda)
    caller = harness.make_caller(cell, blocks, dev)
    obs_trace.clear()
    obs_trace.enable(capacity=1 << 16)
    t = time.perf_counter()
    for k in range(len(pool)):
        caller.harvest(caller.submit(k))
    sync()
    first_calls_s = time.perf_counter() - t
    first = _setup_spans(obs_trace)
    obs_trace.disable()
    obs_trace.clear()
    if host.get("freeze_collector_after_setup"):
        gc.collect()
        gc.freeze()

    window_s, n_calls, _, _, _ = harness._window(
        caller, len(pool), seconds, {}, blocks.cells)
    n = max(4, int(math.ceil(harness.TRACE_SECONDS * n_calls / window_s)))
    tl = harness._traced(caller, len(pool), n_calls, n, blocks)
    run = harness.Run(cell.config, cell.traffic, setup_s=0.0, trace=tl)
    readings = {}
    for m in cell.metrics["per_layer"]:
        readings[m["name"]] = load_module("metrics", m["name"],
                                          cell.bench_dir).read(run)
    traced = spans.calls(tl)
    submits = spans.intervals(tl, "bench.submit")

    def per_call(table):
        """{span: [count a call, ms a call]}, most time first."""
        return {k: [c / traced, us / traced / 1e3]
                for k, (c, us) in sorted(table.items(),
                                         key=lambda kv: -kv[1][1])}

    long_gaps = [g for g in tl.gaps if g[1] >= GAP_US]
    (w0, w), = spans.intervals(tl, trace_mod.WINDOW)
    # the entry's host time by innermost span, less the waits there
    self_us = spans.split_by_span(tl, spans.intervals(tl, spans.ENTRY))
    for k, (_, us) in spans.by_span(tl, spans.waits(tl)).items():
        if k in self_us:
            self_us[k] -= us
    segment = {
        "calls": traced,
        "submit_ms": sum(d for _, d in submits) / traced / 1e3,
        "align_own_ms": spans.own_us(tl, spans.ENTRY) / traced / 1e3,
        "self_ms_by_span": {k: us / traced / 1e3
                            for k, us in sorted(self_us.items())},
        # every idle gap cut at the spans' edges: {span: ms a call}
        "idle_ms_by_span": {
            k: us / traced / 1e3 for k, us in sorted(
                spans.split_by_span(tl, tl.gaps).items(),
                key=lambda kv: -kv[1])},
        # each gap of GAP_US or more by the shortest span holding it whole
        "long_gaps_under": per_call(spans.by_span(tl, long_gaps, True)),
        # those no span holds whole: [ms from the segment's start, ms,
        # ms to its end]
        "long_gaps_unheld": [
            [(s - w0) / 1e3, d / 1e3, (w0 + w - s - d) / 1e3]
            for s, d in long_gaps
            if "none" in spans.by_span(tl, [(s, d)], True)],
        "waits_by_span": per_call(spans.by_span(tl, spans.waits(tl))),
    }
    cost = {"idle_card": _idle_host_ms(caller, len(pool), idle_calls, sync,
                                       obs_trace),
            "span_us": _span_us(obs_trace, cuda)}
    return {"workload": cell.name, "seed": seed,
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "first_calls_s": first_calls_s, "first_calls_spans": first,
            "readings": readings, "segment": segment, "cost": cost}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--idle-calls", type=int, default=40)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import harness
    cell = harness.resolve(harness.load_benchmark(ROOT), args.workload)
    print(json.dumps(where(cell, args.seed, args.seconds, args.idle_calls)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
