"""Finding/Report datatypes of the plan linter (counterpart of
``repro.analyze.findings``).

A *finding* is one rule firing at one location — a (kernel × engine ×
bucket × batch) plan point for point-scope rules, a kernel or an engine
for the scoped hygiene rules, or the whole registry.  Severities:

  * ``error``   — the plan point is wrong or will fail: a mis-declared
    recurrence, an over-budget kernel, a cache-key hazard.  CI fails.
  * ``warning`` — legal but costly or fragile: 64-bit parameters a
    kernel narrows, register spills, budget pressure.  Reported, never
    fatal.
  * ``info``    — observations (padding waste, skipped checks).
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

ERROR = "error"
WARNING = "warning"
INFO = "info"
SEVERITIES = (ERROR, WARNING, INFO)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str                     # e.g. 'R202'
    severity: str                 # error | warning | info
    message: str
    where: str = ""               # 'global_linear×wavefront 64x64 b4', ...

    def format(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.severity.upper():7s} {self.rule}{loc}: {self.message}"


@dataclasses.dataclass
class Report:
    """One lint run: findings plus sweep accounting."""
    findings: List[Finding] = dataclasses.field(default_factory=list)
    points: int = 0               # plan points swept
    skipped: List[str] = dataclasses.field(default_factory=list)
    rules_run: List[str] = dataclasses.field(default_factory=list)
    elapsed_s: Optional[float] = None

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    def by_severity(self, severity: str) -> List[Finding]:
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self) -> List[Finding]:
        return self.by_severity(ERROR)

    @property
    def ok(self) -> bool:
        return not self.errors

    def to_dict(self) -> dict:
        return {
            "points": self.points,
            "rules": sorted(self.rules_run),
            "skipped": list(self.skipped),
            "elapsed_s": self.elapsed_s,
            "counts": {s: len(self.by_severity(s)) for s in SEVERITIES},
            "findings": [dataclasses.asdict(f) for f in self.findings],
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def format_text(self, verbose: bool = False) -> str:
        lines = []
        order = {ERROR: 0, WARNING: 1, INFO: 2}
        for f in sorted(self.findings,
                        key=lambda f: (order[f.severity], f.rule, f.where)):
            if f.severity == INFO and not verbose:
                continue
            lines.append(f.format())
        n_err, n_warn, n_info = (len(self.by_severity(s)) for s in SEVERITIES)
        el = f" in {self.elapsed_s:.1f}s" if self.elapsed_s is not None else ""
        lines.append(
            f"linted {self.points} plan points ({len(self.skipped)} "
            f"skipped as unsupported){el}: {n_err} error(s), "
            f"{n_warn} warning(s), {n_info} info")
        return "\n".join(lines)
