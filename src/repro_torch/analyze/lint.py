"""Lint orchestration: sweep the plan-point space through the rules
(counterpart of ``repro.analyze.lint``).

``lint_all`` enumerates every registered (kernel x engine) pair at a
representative bucket and batch, builds one :class:`PointContext` per
point, and runs the selected rules — point-scope rules on every point,
kernel-scope rules once per kernel, global rules once per sweep.  Nothing
runs on a card: a point costs at most one plain fill on the CPU, and with
the R303 rule one run of its program (fill and walk) under the host-read
detector.

Rule selection takes exact IDs or prefixes (``"R3"`` the transfer family,
``"R4"`` the budget family, ``"R202"`` one rule).  A rule that crashes, as opposed to firing, is
reported as an error under its own ID.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Optional, Sequence, Tuple

from .context import PointContext
from .findings import ERROR, Finding, Report
from .hygiene import GLOBAL_RULES
from .points import PlanPoint, enumerate_points
from .rules import POINT_RULES, Rule

ALL_RULES: List[Rule] = POINT_RULES + GLOBAL_RULES
RULES_BY_ID = {r.id: r for r in ALL_RULES}


@dataclasses.dataclass
class LintConfig:
    """Budgets and thresholds the R3xx/R4xx rules judge against, and the
    device the options resolve for (None: the CUDA device when one is
    present, else the CPU; nothing is launched either way)."""
    tb_budget_bytes: int = 256 << 20      # per-block traceback store
    smem_budget_bytes: Optional[int] = None   # None: the card's, or H100's
    device: Optional[str] = None
    const_warn_bytes: int = 128 << 10     # captured-tensor thresholds
    const_error_bytes: int = 16 << 20
    hlo_rules: bool = True                # run the point's program (R303)

    def resolved_device(self) -> str:
        if self.device is not None:
            return self.device
        import torch
        return "cuda" if torch.cuda.is_available() else "cpu"

    def model(self, device):
        from repro_torch.tune import cost
        return cost.device_model(device)

    def smem_limit(self, device) -> int:
        if self.smem_budget_bytes is not None:
            return self.smem_budget_bytes
        return self.model(device).smem_per_block


def select_rules(rules: Optional[Iterable[str]] = None,
                 ignore: Optional[Iterable[str]] = None) -> List[Rule]:
    """Resolve ID/prefix selections against the rule registry."""
    def match(rule: Rule, pats: Iterable[str]) -> bool:
        return any(rule.id.startswith(p.upper()) for p in pats)

    selected = [r for r in ALL_RULES if rules is None or match(r, rules)]
    if ignore:
        selected = [r for r in selected if not match(r, ignore)]
    if rules is not None:
        unmatched = [p for p in rules
                     if not any(r.id.startswith(p.upper())
                                for r in ALL_RULES)]
        if unmatched:
            raise ValueError(
                f"unknown rule selector(s) {unmatched}; known rules: "
                f"{sorted(RULES_BY_ID)}")
    return selected


def _run_rule(rule: Rule, report: Report, *args) -> None:
    try:
        report.extend(rule.fn(*args))
    except Exception as e:                      # a crashed rule is a finding
        where = ""
        if args and isinstance(args[0], PointContext):
            where = args[0].point.label
        report.findings.append(Finding(
            rule.id, ERROR,
            f"lint rule crashed: {type(e).__name__}: {e}", where))


def lint_point(point: PlanPoint, config: Optional[LintConfig] = None,
               rules: Optional[Iterable[str]] = None,
               ignore: Optional[Iterable[str]] = None) -> Report:
    """Run the point- and kernel-scope rules on one plan point."""
    cfg = config or LintConfig()
    selected = [r for r in select_rules(rules, ignore)
                if r.scope in ("point", "kernel")]
    report = Report(points=1, rules_run=[r.id for r in selected])
    ctx = PointContext(point, cfg.resolved_device())
    for rule in selected:
        _run_rule(rule, report, ctx, cfg)
    return report


def lint_all(kernels: Optional[Iterable] = None,
             engines: Optional[Iterable[str]] = None,
             bucket: Tuple[int, int] = (64, 64),
             batch_size: Optional[int] = 4,
             rules: Optional[Iterable[str]] = None,
             ignore: Optional[Iterable[str]] = None,
             config: Optional[LintConfig] = None,
             points: Optional[Sequence[PlanPoint]] = None) -> Report:
    """Sweep the registered plan-point space (or an explicit ``points``
    list) through the selected rules; ``report.ok`` (no error finding) is
    the gate."""
    cfg = config or LintConfig()
    device = cfg.resolved_device()
    selected = select_rules(rules, ignore)
    t0 = time.perf_counter()
    if points is None:
        points, skipped = enumerate_points(kernels, engines, bucket,
                                           batch_size)
    else:
        points, skipped = list(points), []
    report = Report(points=len(points), skipped=skipped,
                    rules_run=[r.id for r in selected])

    point_rules = [r for r in selected if r.scope == "point"]
    kernel_rules = [r for r in selected if r.scope == "kernel"]
    global_rules = [r for r in selected if r.scope == "global"]

    seen_kernels = set()
    for point in points:
        ctx = PointContext(point, device)
        if point.kernel not in seen_kernels:
            seen_kernels.add(point.kernel)
            for rule in kernel_rules:
                _run_rule(rule, report, ctx, cfg)
        for rule in point_rules:
            _run_rule(rule, report, ctx, cfg)
    for rule in global_rules:
        _run_rule(rule, report, cfg)

    report.elapsed_s = time.perf_counter() - t0
    return report
