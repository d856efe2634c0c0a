"""Static analysis of the port's kernel x engine plan space (counterpart of
``repro.analyze``).

The DP-HLS paper catches mis-parameterized kernels at synthesis time —
bitwidths that overflow, bands that prune the objective, blocks that
overflow on-chip memory — before a bitstream exists.  This package is that
gate for the port: it sweeps every registered (kernel x engine x
bucket/batch) plan point without a card and reports findings with JAX's
stable rule IDs:

  * R1xx recurrence legality (PE cell contract on CPU tensors, band reach,
    unit cost);
  * R2xx cache-key and dtype hazards (hashable deterministic keys, the
    plain fill's dtypes, 64-bit parameters K1 would narrow);
  * R3xx transfers (host reads in the PE and its initializers, tensors
    they capture, and every host read of the point's program, fill and
    walk, run once on the CPU under ``launch.hlo_cost.HostReads``: the
    counterparts of JAX's callbacks in the jaxpr, constants captured by
    the trace and host transfers in the lowered HLO);
  * R4xx budgets (K1's shared memory at the point's warps per pair and the
    kept ptxas reports of K1 and K2, K1's grid legality, the traceback
    store);
  * R5xx registry hygiene (semiring laws, tunable grids, option schema).

Entry points: :func:`lint_all`, :func:`lint_point` (one point, e.g. from
:func:`point_for`), and ``python -m repro_torch.analyze`` (the counterpart
of ``scripts/lint_plans.py``).
"""
from .findings import ERROR, INFO, SEVERITIES, WARNING, Finding, Report
from .lint import (ALL_RULES, RULES_BY_ID, LintConfig, lint_all, lint_point,
                   select_rules)
from .points import PlanPoint, enumerate_points, point_for, resolved_options
from .context import PointContext

__all__ = [
    "ERROR", "WARNING", "INFO", "SEVERITIES",
    "Finding", "Report", "LintConfig",
    "ALL_RULES", "RULES_BY_ID", "select_rules",
    "lint_all", "lint_point",
    "PlanPoint", "PointContext", "enumerate_points", "point_for",
    "resolved_options",
]
