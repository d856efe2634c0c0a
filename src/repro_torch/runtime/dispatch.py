"""Packed batch dispatch (counterpart of ``repro.runtime.dispatch``):
variable-length pair workloads -> bucketed plans.

``run_pairs`` groups pairs with ``bucketing.pack_by_bucket``, pads each
block to its bucket and runs it through the shared plan cache.
``run_pipelined`` drives launch/harvest one block behind: a launch enqueues
the block's host-to-device copy (from pinned memory, ``non_blocking``) and
its kernels on the current stream and returns; the harvest's ``.cpu()``
is where the host waits for the device, so the host pads block N+1 while
the device computes block N.  The traceback walk inside a launch asks the
device whether it is done every 64 steps, so a launch is not wholly free of
synchronisation.  Each launch and harvest is a ``dispatch.launch`` /
``dispatch.harvest`` span (``repro_torch.obs.trace``).
"""
from __future__ import annotations

import collections
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

import repro_torch.core.traceback as tb_mod
import repro_torch.core.types as T
from repro_torch.core.spec_utils import params_on_device
from repro_torch.obs import trace as obs_trace

from . import bucketing
from . import plan as plan_mod


def run_pipelined(items: Iterable, launch: Callable, harvest: Callable, *,
                  depth: int = 2, on_abandon: Optional[Callable] = None
                  ) -> int:
    """Drive ``launch``/``harvest`` over a batch stream, ``depth - 1``
    launches ahead of the harvests.

    ``launch(item)`` enqueues device work and returns its (device-side)
    output, which is handed to ``harvest(item, out)``.  ``depth=1`` is the
    synchronous launch-then-harvest loop.  On an exception the
    un-harvested window goes to ``on_abandon(item, out)`` before the
    exception propagates.  Returns the sum of ``harvest`` return values
    (``None`` counts as 0)."""
    if depth < 1:
        raise ValueError(f"pipeline depth must be >= 1, got {depth}")
    window: collections.deque = collections.deque()
    total = 0

    def _launch(item):
        with obs_trace.span("dispatch.launch", cat="dispatch"):
            return launch(item)

    def _harvest(it, out):
        with obs_trace.span("dispatch.harvest", cat="dispatch"):
            return harvest(it, out)

    try:
        for item in items:
            window.append((item, _launch(item)))
            while len(window) >= depth:
                it, out = window.popleft()
                total += _harvest(it, out) or 0
        while window:
            it, out = window.popleft()
            total += _harvest(it, out) or 0
    except BaseException:
        if on_abandon is not None:
            while window:
                it, out = window.popleft()
                on_abandon(it, out)
        raise
    return total


def _to_host(out):
    """Copy every tensor field of a batched result to host numpy."""
    kw = {}
    for name in out.__dataclass_fields__:
        v = getattr(out, name)
        kw[name] = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
    return type(out)(**kw)


def _slice_out(out, i):
    """Row ``i`` of a host-side batched Alignment/DPResult."""
    def pick(x):
        return None if x is None else x[i]
    if isinstance(out, T.Alignment):
        return tb_mod.raise_if_truncated(T.Alignment(
            score=pick(out.score), end_i=pick(out.end_i),
            end_j=pick(out.end_j), start_i=pick(out.start_i),
            start_j=pick(out.start_j), moves=pick(out.moves),
            n_moves=pick(out.n_moves), truncated=pick(out.truncated)))
    return T.DPResult(score=pick(out.score), end_i=pick(out.end_i),
                      end_j=pick(out.end_j), tb=pick(out.tb),
                      tb_layout=out.tb_layout)


def run_pairs(spec, params, pairs: Sequence[tuple], *,
              engine_name: str = "wavefront", block: int = 8,
              with_traceback: bool = True, mode: str = "align",
              min_bucket: int = bucketing.DEFAULT_MIN_BUCKET,
              max_bucket: Optional[int] = None,
              pipeline_depth: int = 2, device="cuda") -> list:
    """Run every ``(query, ref)`` pair; results come back in input order,
    as host-side numpy values.

    Each bucketed block is padded to exactly ``block`` rows (tail rows are
    length-1 dummies) so repeated calls reuse one plan per bucket shape.
    """
    dev = plan_mod.resolve_device(device)
    params = params_on_device(params, dev)      # once, not once a block
    pairs = [(np.asarray(q), np.asarray(r)) for q, r in pairs]
    lengths = [(q.shape[0], r.shape[0]) for q, r in pairs]
    batches, _ = bucketing.pack_by_bucket(lengths, block=block,
                                          min_bucket=min_bucket,
                                          max_bucket=max_bucket)
    char = spec.char_shape
    pin = dev.type == "cuda"
    results: list = [None] * len(pairs)

    def launch(b):
        bq, br = b.bucket
        qs = torch.zeros((block, bq) + char, dtype=spec.char_dtype,
                         pin_memory=pin)
        rs = torch.zeros((block, br) + char, dtype=spec.char_dtype,
                         pin_memory=pin)
        q_np, r_np = qs.numpy(), rs.numpy()
        ql = np.ones((block,), np.int32)
        rl = np.ones((block,), np.int32)
        for row, idx in enumerate(b.indices):
            q, r = pairs[idx]
            ql[row], rl[row] = q.shape[0], r.shape[0]
            q_np[row, : ql[row]] = q
            r_np[row, : rl[row]] = r
        plan = plan_mod.get_plan(spec, engine_name, (bq,) + char,
                                 (br,) + char, batch_size=block,
                                 with_traceback=with_traceback, mode=mode,
                                 device=dev)
        return plan(params, qs.to(dev, non_blocking=True),
                    rs.to(dev, non_blocking=True), ql, rl)

    def harvest(b, out):
        host = _to_host(out)
        for row, idx in enumerate(b.indices):
            results[idx] = _slice_out(host, row)

    run_pipelined(batches, launch, harvest, depth=pipeline_depth)
    return results
