"""Plan warming (counterpart of ``repro.tune.warm``): pay a plan's first
dispatch at boot, not on request 1.

A cold service's first request at each (kernel, bucket, batch) channel pays
that plan's first dispatch: on the card the kernel library's build (``nvcc``,
when the build directory does not hold it yet) or load, and the first
launch.  Warming walks a service's channel grid at construction
(``warm_start=``) and forces each plan through one dummy dispatch of
length-1 pairs at the bucket shape, then waits for the plan's device, so the
real first request lands on a hot plan.  Every ``CompiledPlan`` stamps that
first dispatch as ``compile_s``, and ``plan_cache_info()['totals']
['compile_s']`` sums it across live and retired plans.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.runtime import plan as plan_mod


def _dummy_args(spec, q_shape: tuple, r_shape: tuple,
                batch_size: Optional[int], dev: torch.device):
    """Zero-filled inputs at the bucket shape on ``dev``, lengths pinned to
    1 (the cheapest fill the engines can run)."""
    lead = () if batch_size is None else (batch_size,)
    q = torch.zeros(lead + tuple(q_shape), dtype=spec.char_dtype, device=dev)
    r = torch.zeros(lead + tuple(r_shape), dtype=spec.char_dtype, device=dev)
    if batch_size is None:
        return q, r, 1, 1
    ones = torch.ones((batch_size,), dtype=torch.int32)
    return q, r, ones, ones


def warm_plan(spec, params, engine_name: str, q_shape: tuple,
              r_shape: tuple, *, batch_size: Optional[int] = None,
              with_traceback: bool = True, mode: str = "align",
              device="cuda", **options) -> plan_mod.CompiledPlan:
    """Fetch the plan ``get_plan`` would serve for these arguments and force
    its first dispatch with one dummy batch (no-op if already hot)."""
    plan = plan_mod.get_plan(
        spec, engine_name, tuple(q_shape), tuple(r_shape),
        batch_size=batch_size, with_traceback=with_traceback, mode=mode,
        device=device, **options)
    if plan.compile_s is None:
        dev = torch.device(plan.key.device)
        plan(params, *_dummy_args(spec, q_shape, r_shape, batch_size, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return plan


def warm_grid(spec, params, engine_name: str, points, *,
              with_traceback: bool = True, mode: str = "align",
              device="cuda") -> int:
    """Warm one plan per ``(bucket, batch_size)`` point; returns the number
    of plans that were cold (already-hot points count 0).  ``bucket`` is the
    per-pair length pair; char dims come from the spec."""
    char = spec.char_shape
    n = 0
    for bucket, batch_size in points:
        plan = warm_plan(
            spec, params, engine_name, (bucket[0],) + char,
            (bucket[1],) + char, batch_size=batch_size,
            with_traceback=with_traceback, mode=mode, device=device)
        n += plan.hits == 0 and plan.calls <= 1
    return n
