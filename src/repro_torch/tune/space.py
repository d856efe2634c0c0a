"""Legal schedule design space of one (kernel spec, engine) pair
(counterpart of ``repro.tune.space``).

The grid is derived, never hand-listed: engines declare their tunable option
values at registration (``registry.engine_tunable``), and every point of the
cartesian product goes through the runtime's own ``resolve_engine_options``;
a candidate the plan cache would reject (``tb_pack=8`` on a 4-bit-pointer
kernel) is dropped, and candidates that resolve to the same values collapse
to one (a score-only kernel pins ``tb_pack=1``).  Given a bucket, points K1
cannot launch there (more warps a pair than the query has 32-row strips) are
dropped too.
"""
from __future__ import annotations

import itertools
from typing import Optional

from repro_torch.runtime import plan as plan_mod
from repro_torch.runtime import registry


def tunable_names(engine_name: str) -> list[str]:
    """Sorted tunable option names of an engine ([] = nothing to tune)."""
    return sorted(registry.engine_tunable(engine_name))


def default_options(spec, engine_name: str, device="cuda") -> dict:
    """The hand-picked default point on the tunable axes: what an empty
    request resolves to today (``strip_warps=None`` is K1's heuristic), and
    the baseline every candidate must match bit for bit."""
    resolved = plan_mod.resolve_engine_options(spec, engine_name, {},
                                               device)
    return {n: resolved[n] for n in tunable_names(engine_name)}


def grid_findings(engine_name: str) -> list[str]:
    """Static problems in an engine's declared tunable grid, one string per
    violation ([] when clean): tunables must name declared options, grids
    must be non-empty, and every value must pass its option's validator
    (``tb_pack`` a power of two, the others integers >= 1).  The plan
    linter's R502 calls this per engine."""
    problems: list[str] = []
    opts = registry.engine_options(engine_name)
    for name, values in sorted(registry.engine_tunable(engine_name).items()):
        if name not in opts:
            problems.append(
                f"tunable {name!r} not declared in options={sorted(opts)}")
        if not values:
            problems.append(f"tunable {name!r} declares an empty grid")
        for v in values:
            try:
                if name == "tb_pack":
                    plan_mod.validate_pow2_option(name, v)
                else:
                    plan_mod.validate_int_option(name, v, minimum=1)
            except ValueError as e:
                problems.append(f"grid value {name}={v!r}: {e}")
    return problems


def _launchable(options: dict, bucket: Optional[tuple]) -> bool:
    """Whether K1 can launch a point's ``strip_warps`` at ``bucket``
    (always True without a bucket or a warps count)."""
    warps = options.get("strip_warps")
    if bucket is None or warps is None:
        return True
    from repro_torch.kernels.wavefront import kernel as K1
    lo, hi = K1.warps_range(bucket[0])
    return lo <= warps <= hi


def enumerate_space(spec, engine_name: str, bucket: Optional[tuple] = None,
                    device="cuda") -> list[dict]:
    """Every legal, distinct tunable-option combination for this spec (and
    bucket, when given).  Returns [] for an engine with nothing to tune."""
    grid = registry.engine_tunable(engine_name)
    if not grid:
        return []
    names = sorted(grid)
    seen: dict[tuple, dict] = {}
    for combo in itertools.product(*(grid[n] for n in names)):
        requested = dict(zip(names, combo))
        try:
            resolved = plan_mod.resolve_engine_options(
                spec, engine_name, requested, device)
        except ValueError:
            continue                  # illegal at this spec; not an error
        point = {n: resolved[n] for n in names}
        if not _launchable(point, bucket):
            continue
        key = tuple(point[n] for n in names)
        if key not in seen:
            seen[key] = point
    return list(seen.values())
