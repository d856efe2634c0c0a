"""Per-point artifacts, built lazily and shared by the rules (counterpart of
``repro.analyze.context``).

JAX's context traces a point abstractly (``eval_shape``, ``make_jaxpr``,
un-compiled HLO).  Eager torch has no trace to inspect, so the port's
context holds what a rule can learn without a card: the resolved options,
the ``PlanKey`` the cache would build, the output of the point's engine
run once on CPU tensors at the bucket shape (K1 and K2 through their plain
versions), never through the plan cache, and the host reads of the point's
whole program (fill and walk) run once on the CPU under
``launch.hlo_cost.HostReads``.  One context memoizes each, so the rules
inspecting a point pay one fill and one program run.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.launch import hlo_cost
from repro_torch.runtime import plan as plan_mod
from repro_torch.runtime import registry

from .points import PlanPoint, resolved_options


class PointContext:
    """Lazy analysis cache around one :class:`PlanPoint`; ``device`` is the
    device the options resolve for (nothing runs on it)."""

    def __init__(self, point: PlanPoint, device="cpu"):
        self.point = point
        self.spec = point.spec
        self.params = point.params
        self.device = str(device)

    @functools.cached_property
    def options(self) -> dict:
        return resolved_options(self.point, self.device)

    @functools.cached_property
    def fill(self) -> str:
        """What the plan runs (``registry.engine_fill``)."""
        return registry.engine_fill(self.point.engine, self.options)

    @functools.cached_property
    def key(self) -> plan_mod.PlanKey:
        p = self.point
        return plan_mod.PlanKey(
            kernel=self.spec.name, engine=p.engine,
            bucket_shape=(p.q_shape, p.r_shape), batch_size=p.batch_size,
            with_traceback=p.with_traceback, device=self.device,
            semiring=self.spec.semiring.name, **self.options)

    @functools.cached_property
    def fill_out(self):
        """The point's engine, run once on zero-coded CPU inputs at the
        bucket shape with full lengths (a batch of one for a single-pair
        point): the plain version of whatever kernel the plan launches."""
        p, spec = self.point, self.spec
        b = p.batch_size or 1
        q = torch.zeros((b,) + p.q_shape, dtype=spec.char_dtype)
        r = torch.zeros((b,) + p.r_shape, dtype=spec.char_dtype)
        ql = torch.full((b,), p.bucket[0], dtype=torch.int32)
        rl = torch.full((b,), p.bucket[1], dtype=torch.int32)
        declared = registry.engine_options(p.engine)
        kw = {k: v for k, v in self.options.items() if k in declared}
        if declared.get("live_bound") == "dynamic":
            kw["live_bound"] = sum(p.bucket)
        return registry.get_engine(p.engine)(
            spec, self.params, q, r, ql, rl, with_tb=p.with_traceback, **kw)

    @functools.cached_property
    def host_reads(self):
        """The host reads of the point's program (``hlo_cost.host_reads``
        on the CPU with the point's options)."""
        p = self.point
        declared = registry.engine_options(p.engine)
        opts = {k: v for k, v in self.options.items()
                if k in declared and declared[k] != "dynamic"}
        return hlo_cost.host_reads(
            self.spec, self.params, p.engine, p.q_shape, p.r_shape,
            batch_size=p.batch_size, with_traceback=p.with_traceback, **opts)
