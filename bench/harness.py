"""One run of one cell: set-up, the measured window, the traced segment,
the check against the plain reference, and the result line.

The window drives the traffic's entry (``entries/<entry>.py``: for every
cell today ``repro_torch.core.batch.align_batch`` on one padded block a
call, with the block's codes in pinned host memory) and keeps one call in
flight: it submits block N+1 (its results' copies to the host queued
behind it) before it waits for block N's.  The blocks come from a
pool made from the seed during set-up, which the window cycles through.
Every answer the window harvests is compared with the first answer of its
block in the window (``repeat_mismatches``), and a sample of the pool's
pairs drawn from the seed is compared with the plain reference once the
window has closed.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

from bench import BENCH, load_module, traffic as traffic_mod

ROOT = Path(__file__).resolve().parent.parent
# top-level module names no run may hold once its window has closed: JAX
# and the JAX package the port was made from (compared as whole names, so
# ``repro_torch`` is not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 2.0          # the traced segment of a --trace 1 run
REF_CHUNK = 4096             # pairs a reference sweep holds at once


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: dict            # "end_to_end" / "per_layer" -> [metric entry]
    bench_dir: Path = BENCH  # where its configuration's modules are found


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, workload: str, bench_dir: Path = BENCH) -> Cell:
    """The cell named ``workload`` with its configuration and traffic
    files and the metrics it reports, found by the names in
    ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((bench_dir.parent / conf["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    metrics = {k: [m for m in bench[k] if _applies(m, workload)]
               for k in ("end_to_end", "per_layer")}
    return Cell(workload, int(w["chips"]), config, traffic, metrics,
                bench_dir)


def forbidden_modules(modules=None) -> list:
    """Names in ``sys.modules`` whose top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    config: dict
    traffic: dict
    setup_s: float
    window_s: float = 0.0
    calls: int = 0
    pairs: int = 0
    cells: int = 0
    trace: object = None     # bench.trace.Timeline of the traced segment


class Blocks:
    """The pool as the program's inputs: codes in pinned host memory (on
    the card) and lengths as host arrays."""

    def __init__(self, pool, pin: bool):
        import torch
        self.pool = pool
        self.q, self.r = [], []
        for b in pool:
            q, r = torch.from_numpy(b.queries), torch.from_numpy(b.refs)
            self.q.append(q.pin_memory() if pin else q)
            self.r.append(r.pin_memory() if pin else r)
        self.cells = [b.live_cells for b in pool]
        self.bases = [int(b.q_lens.sum()) + int(b.r_lens.sum())
                      for b in pool]


def make_caller(cell: Cell, blocks: Blocks, dev, call=None):
    """The window's entry for ``cell``, named by its traffic: an object
    with ``submit(k)`` and ``harvest(pending)``.  ``call`` replaces the
    program's function where a test plants a fault."""
    return load_module("entries", cell.traffic["entry"],
                       cell.bench_dir).make(cell, blocks, dev, call)


def _differ(a: dict, b: dict) -> np.ndarray:
    """Rows whose answer differs between two harvests of one block."""
    bad = None
    for f in a:
        x, y = a[f], b[f]
        d = x != y
        if d.ndim > 1:
            d = d.reshape(d.shape[0], -1).any(1)
        bad = d if bad is None else bad | d
    return bad


def _window(caller, n_blocks: int, seconds: float, first: dict, cells):
    """Run calls for ``seconds``; returns (window_s, calls, pairs, cells,
    rows whose repeats differed).  ``first`` collects each block's first
    answer of the window."""
    diff_rows = 0
    calls = pairs = n_cells = 0
    k = 0
    t0 = time.perf_counter()
    pending = caller.submit(0)
    while pending is not None:
        nxt = None
        if time.perf_counter() - t0 < seconds:
            k += 1
            nxt = caller.submit(k % n_blocks)
        blk, got = caller.harvest(pending)
        calls += 1
        pairs += next(iter(got.values())).shape[0]
        n_cells += cells[blk]
        if blk in first:
            diff_rows += int(_differ(got, first[blk]).sum())
        else:
            first[blk] = got
        pending = nxt
    return time.perf_counter() - t0, calls, pairs, n_cells, diff_rows


def _traced(caller, n_blocks: int, start: int, n_calls: int, blocks):
    """``n_calls`` calls under torch.profiler; returns the timeline."""
    import torch
    from bench import trace as trace_mod
    acts = [torch.profiler.ProfilerActivity.CPU]
    if caller.cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    rf = torch.profiler.record_function
    ks = [(start + i) % n_blocks for i in range(n_calls)]
    with torch.profiler.profile(activities=acts) as prof:
        with rf(trace_mod.WINDOW):
            with rf(trace_mod.SUBMIT):
                pending = caller.submit(ks[0])
            for i in range(1, n_calls + 1):
                nxt = None
                if i < n_calls:
                    with rf(trace_mod.SUBMIT):
                        nxt = caller.submit(ks[i])
                with rf(trace_mod.HARVEST):
                    caller.harvest(pending)
                pending = nxt
            if caller.cuda:
                torch.cuda.synchronize()
    tl = trace_mod.timeline(prof)
    tl.cells = sum(blocks.cells[k] for k in ks)
    tl.bases = sum(blocks.bases[k] for k in ks)
    tl.pairs = sum(blocks.pool[k].q_lens.shape[0] for k in ks)
    return tl


def _inputs(pool, blk, row):
    """The sampled pairs' codes and lengths, stacked."""
    take = lambda name: np.stack([getattr(pool[b], name)[r]
                                  for b, r in zip(blk, row)])
    return tuple(take(n) for n in ("queries", "refs", "q_lens", "r_lens"))


def reference_answers(ref, config, inputs, device, fn="reference"):
    """The reference's (or the control's) answers, REF_CHUNK pairs at a
    time so that the sweep fits beside nothing else."""
    q, r, ql, rl = inputs
    parts = []
    for s in range(0, q.shape[0], REF_CHUNK):
        sl = slice(s, s + REF_CHUNK)
        # trim the padding past the chunk's longest pair
        qm, rm = int(ql[sl].max()), int(rl[sl].max())
        parts.append(getattr(ref, fn)(config, q[sl, :qm], r[sl, :rm],
                                      ql[sl], rl[sl], device=device))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def check(config, traffic, pool, answers, seed: int, device, ref=None):
    """Compare answers with the reference on the seed's sample of the pool
    (pairs of the blocks ``answers`` holds).  ``answers`` maps a block to
    its harvested answers, or is a function from the sampled inputs to
    answers (the control in the program's place).  Returns (numbers, bad
    pairs, pairs compared)."""
    ref = ref or load_module("reference", config["reference"])
    blk, row = traffic_mod.check_sample(traffic, pool, seed)
    if not callable(answers):
        ran = np.isin(blk, list(answers))
        blk, row = blk[ran], row[ran]
    inputs = _inputs(pool, blk, row)
    if callable(answers):
        got = answers(inputs)
    else:
        fields = list(next(iter(answers.values())))
        got = {f: np.stack([answers[b][f][r] for b, r in zip(blk, row)])
               for f in fields}
    want = reference_answers(ref, config, inputs, device)
    numbers, bad = ref.compare(config, got, want, inputs)
    return numbers, bad, int(blk.shape[0])


def limits_of(config: dict, numbers: dict) -> dict:
    """Each compared number beside its limit; the harness's own
    ``repeat_mismatches`` must be 0."""
    out = {}
    for name, value in numbers.items():
        limit = 0 if name == "repeat_mismatches" else \
            config["limits"][name]
        out[name] = {"value": value, "limit": limit}
    return out


def apply_host(config: dict) -> dict:
    """The configuration's settings of the host process (``host``):
    ``intra_op_threads`` sets torch's intra-op threads; returns them."""
    import torch
    host = config.get("host", {})
    if "intra_op_threads" in host:
        torch.set_num_threads(int(host["intra_op_threads"]))
    return host


def device_info(dev) -> dict:
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool = False,
             device: str = "cuda", t0: float | None = None, call=None,
             log=None) -> dict:
    """One run of ``cell``; returns the result line as a dict (keys in the
    order printed, ``checks`` last).  ``call`` replaces the program's
    function behind the entry (tests plant faults through it); ``t0`` is
    the process's start on the host clock."""
    import torch
    import repro_torch.core.batch  # noqa: F401  (imports are set-up)
    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    dev = torch.device(device)
    config, traffic = cell.config, cell.traffic
    host = apply_host(config)
    if dev.type == "cuda":
        torch.empty(1, device=dev)       # the CUDA context, timed here
    marks = [("imports and context", time.perf_counter())]
    pool = traffic_mod.make_pool(traffic, seed, cell.bench_dir)
    marks.append(("pool", time.perf_counter()))
    blocks = Blocks(pool, pin=dev.type == "cuda")
    marks.append(("pinning", time.perf_counter()))
    caller = make_caller(cell, blocks, dev, call)
    # set-up: every block once (the cell's one bucket shape, K1's library
    # built or loaded, the plan made, the allocators warm)
    for k in range(len(pool)):
        caller.harvest(caller.submit(k))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if host.get("freeze_collector_after_setup"):
        # the set-up's objects (torch's and the pool's) leave the
        # collector's generations, so a full collection in the window
        # scans only what the window made
        gc.collect()
        gc.freeze()
    marks.append(("first calls", time.perf_counter()))
    run = Run(config, traffic, setup_s=marks[-1][1] - t0)
    prev, parts = t0, []
    for what, t in marks:
        parts.append(f"{what} {t - prev:.3f}")
        prev = t
    log(f"set-up {run.setup_s:.3f} s ({', '.join(parts)}): {len(pool)} "
        f"blocks of {traffic['batch']} pairs, {sum(blocks.cells)} live "
        "cells")

    first: dict = {}
    (run.window_s, run.calls, run.pairs, run.cells,
     diff_rows) = _window(caller, len(pool), seconds, first, blocks.cells)
    log(f"window {run.window_s:.3f} s: {run.calls} calls, {run.pairs} "
        f"pairs, {run.cells} live cells")
    if trace:
        per_call = run.window_s / max(run.calls, 1)
        n = max(4, int(math.ceil(TRACE_SECONDS / per_call)))
        run.trace = _traced(caller, len(pool), run.calls, n, blocks)
    dev_info = device_info(dev)
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    # the program's state is freed before the reference runs on the card
    del caller, blocks
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers, bad, compared = check(config, traffic, pool, first, seed, dev,
                                   load_module("reference",
                                               config["reference"],
                                               cell.bench_dir))
    numbers["repeat_mismatches"] = diff_rows
    checks = limits_of(config, numbers)
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics[kind]:
        value = load_module("metrics", m["name"], cell.bench_dir).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        dev_info["busy_s"] = run.trace.busy_s
        dev_info["window_s"] = run.trace.window_s
    result = {"correct": bool(correct), "attempted": run.pairs,
              "failed": int(diff_rows + int(np.sum(bad))),
              "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    log(f"checked {compared} sampled pairs against the reference")
    return result


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("modules of JAX or of the JAX package were loaded: "
                         + ", ".join(names))
        self.names = names
