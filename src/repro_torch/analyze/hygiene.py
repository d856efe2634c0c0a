"""Registry-hygiene rules, global scope (counterpart of
``repro.analyze.hygiene``): the declarative surfaces every other part
trusts — semiring algebra, tunable grids, engine option schemas — satisfy
their contracts.  They run once per sweep: a violation poisons every point
at once.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from repro_torch.core import semiring as semiring_mod
from repro_torch.runtime import plan as plan_mod
from repro_torch.runtime import registry
from repro_torch.tune import space as tune_space

from .findings import ERROR, Finding
from .rules import Rule

_PROBES = torch.tensor([-3.5, -1.0, 0.0, 0.75, 2.25], dtype=torch.float32)
_TOL = 1e-4


def rule_semiring_laws(cfg) -> Iterator[Finding]:
    """R501: spot-check the semiring laws every engine's ⊕-fold assumes:
    ``combine`` commutes and associates (diagonals and region reductions
    reorder it), ``reduce`` is ``combine`` folded, a selective ⊕ returns
    one of its operands (traceback depends on it), and the ±1e30 sentinel
    absorbs."""
    for obj in sorted(semiring_mod.BY_OBJECTIVE):
        sr = semiring_mod.BY_OBJECTIVE[obj]
        where = f"semiring {sr.name!r} (objective {obj!r})"
        try:
            def c(a, b):
                return float(sr.combine(torch.tensor(float(a)),
                                        torch.tensor(float(b))))
            vals = [float(v) for v in _PROBES]
            bad = next(((a, b) for a in vals for b in vals
                        if abs(c(a, b) - c(b, a)) > _TOL), None)
            if bad is not None:
                yield Finding("R501", ERROR,
                              f"combine is not commutative at {bad} — "
                              f"wavefront fill order is unspecified", where)
            for a, b, d in zip(vals, vals[1:], vals[2:]):
                lhs, rhs = c(a, c(b, d)), c(c(a, b), d)
                if abs(lhs - rhs) > _TOL:
                    yield Finding("R501", ERROR,
                                  f"combine is not associative at "
                                  f"({a}, {b}, {d}): {lhs} vs {rhs}", where)
                    break
            red = float(sr.reduce(_PROBES))
            fold = vals[0]
            for v in vals[1:]:
                fold = c(fold, v)
            if abs(red - fold) > _TOL:
                yield Finding("R501", ERROR,
                              f"reduce disagrees with folded combine: "
                              f"{red} vs {fold} — region reductions and PE "
                              f"accumulation diverge", where)
            if sr.selective:
                i = int(sr.arg(_PROBES))
                if abs(red - vals[i]) > _TOL:
                    yield Finding("R501", ERROR,
                                  f"arg points at element {i} ({vals[i]}) "
                                  f"but reduce gives {red} — tracebacks "
                                  f"start at the wrong cell", where)
            sent = -1e30 if c(-1e30, 0.0) == 0.0 else 1e30
            for v in vals:
                if abs(c(sent, v) - v) > _TOL:
                    yield Finding("R501", ERROR,
                                  f"sentinel {sent:+.0e} is not absorbed: "
                                  f"combine(sentinel, {v}) = {c(sent, v)} — "
                                  f"unreachable cells leak into scores",
                                  where)
                    break
        except Exception as e:
            yield Finding("R501", ERROR,
                          f"semiring law probe failed: "
                          f"{type(e).__name__}: {e}", where)


def rule_tunable_grid(cfg) -> Iterator[Finding]:
    """R502: every engine's tunable grid is well-formed: tunables name
    declared options, grids are non-empty, and every value passes its
    option's validator (``space.grid_findings``)."""
    for engine in registry.available_engines():
        for problem in tune_space.grid_findings(engine):
            yield Finding("R502", ERROR, problem, f"engine {engine!r}")


def rule_option_key(cfg) -> Iterator[Finding]:
    """R503: every non-dynamic engine option is a PlanKey field.  The plan
    forwards resolved options by ``getattr(key, name)``, so an option
    outside the PlanKey schema raises on the first ``get_plan``."""
    key_fields = {f.name for f in dataclasses.fields(plan_mod.PlanKey)}
    for engine in registry.available_engines():
        where = f"engine {engine!r}"
        for name, default in sorted(registry.engine_options(engine).items()):
            if default == "dynamic":
                continue
            if name not in key_fields:
                yield Finding("R503", ERROR,
                              f"option {name!r} is not a PlanKey field "
                              f"{sorted(key_fields)} — the plan's "
                              f"getattr(key, {name!r}) raises on first "
                              f"get_plan", where)


GLOBAL_RULES = [
    Rule("R501", "semiring-laws", ERROR, "global", rule_semiring_laws,
         "registered semirings satisfy the laws the engines fold under"),
    Rule("R502", "tunable-grid", ERROR, "global", rule_tunable_grid,
         "tunable grids name declared options and pass their validators"),
    Rule("R503", "option-key", ERROR, "global", rule_option_key,
         "non-dynamic engine options are PlanKey fields"),
]
