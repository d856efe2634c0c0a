"""Time-and-pick search over the pruned design space (counterpart of
``repro.tune.search``).

For one tuning point, (kernel, engine, bucket, batch) on one device, the
sweep:

1. enumerates the legal space (``space.enumerate_space`` at the bucket),
2. keeps the top-K predicted candidates (``cost.rank``; the hand-picked
   default always survives),
3. runs each survivor through the real plan cache (``get_plan`` with
   explicit options, so the sweep never consults the table it is writing)
   and times it: one warm-up dispatch, then the median of ``iters`` rounds
   that take the candidates in turns, each dispatch by CUDA events on a
   CUDA device and by wall clock on the CPU,
4. holds every candidate's output to the default plan's before its time
   counts: bit-identical on every tensor, for every semiring, because
   ``tb_pack`` and ``strip_warps`` only regroup K1's work and reorder no
   sum,
5. picks the fastest measured candidate.  The default is always measured,
   so the winner matches or beats the hand-picked schedule in the run that
   recorded it.

``mode="fill"`` times the fill alone (K1 and the result it returns); in
``mode="align"`` the traceback walk, plain torch, dominates a plan's time
and would hide both knobs.  Lengths are drawn from ``(bucket/2, bucket]``,
the range power-of-two bucketing gives.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.runtime import plan as plan_mod

from . import cost as cost_mod
from . import space as space_mod
from .table import TuningTable


def make_batch(rng, spec, bucket: tuple, batch_size: Optional[int],
               device="cuda"):
    """Random padded inputs in the kernel's alphabet from numpy ``rng``, on
    ``device``; lengths in ``(bucket/2, bucket]``.  Returns ``(queries,
    refs, q_lens, r_lens)``, without the batch axis when ``batch_size`` is
    None (the lengths then plain ints)."""
    n = batch_size or 1
    nq, nr = bucket

    def seqs(length):
        if tuple(spec.char_shape) == (5,):
            raw = rng.random((n, length, 5)).astype(np.float32)
            return raw / raw.sum(axis=-1, keepdims=True)
        if tuple(spec.char_shape) == (2,):
            return rng.normal(size=(n, length, 2)).astype(np.float32)
        if spec.char_dtype == torch.int32:
            return rng.integers(0, 128, (n, length)).astype(np.int32)
        hi = 20 if spec.name == "protein_local" else 4
        return rng.integers(0, hi, (n, length)).astype(np.uint8)

    qs, rs = seqs(nq), seqs(nr)
    ql = rng.integers(nq // 2 + 1, nq + 1, n).astype(np.int32)
    rl = rng.integers(nr // 2 + 1, nr + 1, n).astype(np.int32)
    dev = torch.device(device)
    qt = torch.as_tensor(qs).to(dev)
    rt = torch.as_tensor(rs).to(dev)
    if batch_size is None:
        return qt[0], rt[0], int(ql[0]), int(rl[0])
    return qt, rt, torch.as_tensor(ql), torch.as_tensor(rl)


def _leaves(out):
    if dataclasses.is_dataclass(out):
        return [getattr(out, f.name) for f in dataclasses.fields(out)]
    return list(out)


def unpacked(out):
    """A fill's result with its ``('chunk', 32, pack)`` pointer store
    unpacked to one pointer a byte, so that fills at two ``tb_pack`` values
    compare pointer for pointer; any other result is returned as it is."""
    layout = getattr(out, "tb_layout", None)
    if getattr(out, "tb", None) is None or not (
            isinstance(layout, tuple) and layout[0] == "chunk"
            and len(layout) > 2):
        return out
    from repro_torch.kernels.wavefront import kernel as K1
    return dataclasses.replace(out, tb=K1.unpack_store(out.tb, layout[2]),
                               tb_layout=layout[:2])


def assert_parity(spec, ref_out, out, ctx: str = "") -> None:
    """A candidate's output must equal the default plan's bit for bit on
    every field (tensor, array or scalar), whatever the semiring; a fill's
    pointer store is compared unpacked (``unpacked``)."""
    a_leaves, b_leaves = _leaves(unpacked(ref_out)), _leaves(unpacked(out))
    assert len(a_leaves) == len(b_leaves), \
        f"{ctx}: output structure mismatch"
    for i, (a, b) in enumerate(zip(a_leaves, b_leaves)):
        if a is None or isinstance(a, (str, tuple)):
            assert a == b, f"{ctx}: leaf {i}: {a!r} != {b!r}"
            continue
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)
        b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) \
            else np.asarray(b)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx}: leaf {i}")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_once(plan, params, data, device) -> float:
    """Seconds of one dispatch from an idle device: CUDA events on a CUDA
    device, wall clock on the CPU."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        plan(params, *data)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    plan(params, *data)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 1e3


def _time_in_turns(plans, params, data, *, iters: int, device) -> list:
    """Median seconds per dispatch of each plan, after one warm-up each,
    over ``iters`` rounds that take the plans in turns, so that a drift of
    the host or the card's clocks falls on every candidate alike."""
    for plan in plans:
        plan(params, *data)
    _sync(device)
    times = [[] for _ in plans]
    for _ in range(max(iters, 1)):
        for ts, plan in zip(times, plans):
            ts.append(_time_once(plan, params, data, device))
    return [float(statistics.median(ts)) for ts in times]


def tune_point(spec, params, engine_name: str, bucket: tuple,
               batch_size: Optional[int] = None, *,
               with_traceback: bool = True, mode: str = "align",
               top_k: int = 4, iters: int = 3, seed: int = 0,
               device="cuda", log=None) -> Optional[dict]:
    """Search one point; returns the winner record (None for an engine
    with nothing to tune).  Every measurement carries its options, its
    predicted and measured seconds and cells/s."""
    dev = plan_mod.resolve_device(device)
    candidates = space_mod.enumerate_space(spec, engine_name, bucket, dev)
    if not candidates:
        return None
    default = space_mod.default_options(spec, engine_name, dev)
    wtb = bool(with_traceback and spec.traceback is not None)
    kept, pruned = cost_mod.rank(
        spec, params, engine_name, bucket, batch_size, candidates,
        default=default, top_k=top_k, with_traceback=wtb, mode=mode,
        log=log, device=dev)

    rng = np.random.default_rng(seed)
    data = make_batch(rng, spec, bucket, batch_size, dev)
    char = tuple(spec.char_shape)
    q_shape, r_shape = (bucket[0],) + char, (bucket[1],) + char
    ql = np.asarray(data[2], np.int64).reshape(-1)
    rl = np.asarray(data[3], np.int64).reshape(-1)
    cells = float((ql * rl).sum())

    def plan_for(opts):
        return plan_mod.get_plan(
            spec, engine_name, q_shape, r_shape, batch_size=batch_size,
            with_traceback=wtb, mode=mode, device=dev, **opts)

    ref_out = plan_for(default)(params, *data)
    plans = []
    for s in kept:
        opts = s["options"]
        plans.append(plan_for(opts))
        assert_parity(spec, ref_out, plans[-1](params, *data),
                      ctx=f"{spec.name}/{engine_name}/{bucket}/"
                          f"{batch_size}/{opts}")
    secs = _time_in_turns(plans, params, data, iters=iters, device=dev)
    measurements = [{**s, "seconds": t, "cells_per_s": cells / t}
                    for s, t in zip(kept, secs)]
    if log is not None:
        for m in measurements:
            log(f"measured {m['options']}: {m['seconds'] * 1e3:.4f} ms, "
                f"{m['cells_per_s']:.3g} cells/s")
    best = max(measurements, key=lambda m: m["cells_per_s"])
    base = next(m for m in measurements if m["options"] == default)
    return {"options": best["options"],
            "cells_per_s": best["cells_per_s"],
            "default_options": default,
            "default_cells_per_s": base["cells_per_s"],
            "speedup_vs_default": best["cells_per_s"] / base["cells_per_s"],
            "measurements": measurements,
            "n_pruned": len(pruned)}


def run_sweep(points, *, table: Optional[TuningTable] = None,
              top_k: int = 4, iters: int = 3, seed: int = 0,
              device="cuda", mode: str = "align", log=None,
              clear_between: bool = True) -> TuningTable:
    """Tune every ``(kernel, engine, bucket, batch_size)`` point on
    ``device`` and record the winners into a :class:`TuningTable`.
    ``clear_between`` retires each point's plans
    (``clear_plan_cache(keep_stats=True)``)."""
    from repro_torch.core import kernels_zoo

    table = table if table is not None else TuningTable()
    for kernel, engine_name, bucket, batch_size in points:
        spec, params = kernels_zoo.make(kernel)
        res = tune_point(spec, params, engine_name, tuple(bucket),
                         batch_size, top_k=top_k, iters=iters, seed=seed,
                         device=device, mode=mode, log=log)
        if res is None:
            if log is not None:
                log(f"skip {kernel}/{engine_name}: nothing to tune")
            continue
        key = table.record(
            kernel, engine_name, tuple(bucket), batch_size, res["options"],
            device=device, cells_per_s=res["cells_per_s"],
            default_options=res["default_options"],
            default_cells_per_s=res["default_cells_per_s"],
            speedup_vs_default=res["speedup_vs_default"])
        if log is not None:
            log(f"{key} -> {res['options']} "
                f"({res['speedup_vs_default']:.2f}x vs default)")
        if clear_between:
            plan_mod.clear_plan_cache(keep_stats=True)
    return table
