"""Plan-point enumeration: the kernel x engine space the linter sweeps
(counterpart of ``repro.analyze.points``).

A plan point is one thing ``runtime.plan.get_plan`` could be asked to
build: a zoo kernel on a registered engine at a representative bucket shape
and batch size, with traceback iff the kernel declares an FSM and the engine
stores pointers.  The space is derived from the live registries —
``kernels_zoo.KERNELS`` on one axis, ``registry.available_engines()`` on the
other, filtered by each engine's ``supports`` predicate — so a newly
registered kernel or engine is linted without touching this module.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple

from repro_torch.core import kernels_zoo
from repro_torch.runtime import plan as plan_mod
from repro_torch.runtime import registry


@dataclasses.dataclass(frozen=True)
class PlanPoint:
    """One (kernel, engine, bucket, batch) coordinate, spec attached."""
    kernel: str
    engine: str
    bucket: Tuple[int, int]              # per-pair (Q, R) lengths
    batch_size: Optional[int]
    with_traceback: bool
    spec: object = dataclasses.field(hash=False, compare=False,
                                     default=None)
    params: object = dataclasses.field(hash=False, compare=False,
                                       default=None)

    @property
    def q_shape(self) -> tuple:
        return (self.bucket[0],) + tuple(self.spec.char_shape)

    @property
    def r_shape(self) -> tuple:
        return (self.bucket[1],) + tuple(self.spec.char_shape)

    @property
    def label(self) -> str:
        b = "single" if self.batch_size is None else f"b{self.batch_size}"
        tb = "+tb" if self.with_traceback else ""
        return (f"{self.kernel}×{self.engine} "
                f"{self.bucket[0]}x{self.bucket[1]} {b}{tb}")


def point_for(spec, params, engine: str, bucket: Tuple[int, int],
              batch_size: Optional[int] = None,
              with_traceback: Optional[bool] = None) -> PlanPoint:
    """One PlanPoint from an explicit spec (a kernel outside the zoo, or a
    test fixture)."""
    if with_traceback is None:
        with_traceback = (spec.traceback is not None
                          and registry.engine_traceback(engine))
    return PlanPoint(kernel=spec.name, engine=engine,
                     bucket=(int(bucket[0]), int(bucket[1])),
                     batch_size=batch_size, with_traceback=with_traceback,
                     spec=spec, params=params)


def enumerate_points(kernels: Optional[Iterable] = None,
                     engines: Optional[Iterable[str]] = None,
                     bucket: Tuple[int, int] = (64, 64),
                     batch_size: Optional[int] = 4,
                     ) -> Tuple[List[PlanPoint], List[str]]:
    """The registered plan-point space at one representative bucket.
    Returns ``(points, skipped)``; ``skipped`` records every unsupported
    pair with the engine's reason (facts about the space, not findings)."""
    if kernels is None:
        kernels = [name for (name, _, _) in kernels_zoo.KERNELS.values()]
    if engines is None:
        engines = registry.available_engines()
    points: List[PlanPoint] = []
    skipped: List[str] = []
    for kernel in kernels:
        spec, params = kernels_zoo.make(kernel)
        for engine in engines:
            reason = registry.engine_supports(engine, spec)
            if reason is not None:
                skipped.append(f"{spec.name}×{engine}: {reason}")
                continue
            points.append(point_for(spec, params, engine, bucket,
                                    batch_size))
    return points, skipped


def resolved_options(point: PlanPoint, device="cpu") -> dict:
    """The options this point resolves to on ``device`` by the path
    ``get_plan`` takes with no explicit option: the tuning table first,
    so the linter sees the schedule that would run, the defaults
    otherwise."""
    requested = plan_mod._tuned_defaults(
        point.spec.name, point.engine, point.bucket, point.batch_size,
        device) or {}
    return plan_mod.resolve_engine_options(point.spec, point.engine,
                                           requested, device)
