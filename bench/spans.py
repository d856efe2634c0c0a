"""The program's spans in the traced segment, and the arithmetic the
per-layer metrics read them with.

While torch.profiler records, every ``repro_torch.obs.trace.span`` opens a
``record_function`` range, so the program's spans are ``user_annotation``
events of the timeline, on the profiler's clock, beside the CUDA runtime
calls they make.  On the batch entry's path (nesting by time):

    batch.align                  core/batch.py: the whole align_batch call
      batch.h2d                  core/api.py as_codes: the codes' copy
      plan.get                   runtime/plan.py get_plan
        plan.tune_lookup         the tuning table's lookup
      plan.run                   CompiledPlan._run
        plan.lens                host lengths, their copies, live_bound
        k1.prep                  kernels/wavefront/ops.py: lengths, padding,
                                 boundaries
        k1.launch                K.wavefront_fill (kernel.py _launch)
        k1.fold                  the strip fold

A span's own host time is its duration less the child spans named, less
the time its thread spent blocked in the CUDA runtime's synchronising
calls under it (the calls ``host_submit_ms`` subtracts, so that the
readings add up).  An event lies under a span when its midpoint does, so
the trace's rounding of start and duration cannot move it out.  Every
reading is None where the trace holds no device operation (nothing ran on
a card) or no span of the program (a program that emits none).
"""
from __future__ import annotations

from bench import load_module, trace

ANNOTATION = "user_annotation"
ENTRY = "batch.align"
PLAN = ("plan.get", "plan.run")
K1 = ("k1.prep", "k1.launch", "k1.fold")
PROGRAM = ("batch.", "plan.", "k1.")       # the program's span names
BLOCKING = load_module("metrics", "host_submit_ms").BLOCKING


def _under(inner, outer) -> bool:
    s, d = outer
    return s <= inner[0] + inner[1] / 2 <= s + d


def intervals(tl, name: str) -> list:
    """(start_us, dur_us) of each span named ``name``."""
    return [(s, d) for n, cat, s, d in tl.host
            if n == name and cat == ANNOTATION]


def waits(tl) -> list:
    """(start_us, dur_us) of each blocking CUDA runtime call."""
    return [(s, d) for n, cat, s, d in tl.host
            if cat == "cuda_runtime" and n in BLOCKING]


def calls(tl) -> int:
    """The traced calls: the harness's ``bench.submit`` spans."""
    return len(intervals(tl, trace.SUBMIT))


def own_us(tl, name: str, children=()) -> float:
    """Summed over the spans named ``name``: each one's duration less the
    spans of ``children`` under it, less the blocking waits under it that
    lie under none of those children."""
    kids = [iv for c in children for iv in intervals(tl, c)]
    ws = waits(tl)
    total = 0.0
    for span in intervals(tl, name):
        inner = [k for k in kids if _under(k, span)]
        total += span[1] - sum(d for _, d in inner)
        total -= sum(w[1] for w in ws if _under(w, span)
                     and not any(_under(w, k) for k in inner))
    return total


def wait_us(tl, name: str) -> float:
    """The blocking waits under the spans named ``name``."""
    spans = intervals(tl, name)
    return sum(w[1] for w in waits(tl) if any(_under(w, s) for s in spans))


def readable(tl, names) -> bool:
    """Whether the segment ran on a card and holds spans of ``names``."""
    return (tl is not None and bool(tl.device) and calls(tl) > 0
            and any(intervals(tl, n) for n in names))


def per_call_ms(tl, us: float) -> float:
    return us / calls(tl) / 1e3


def _named(tl):
    """(name, start, dur) of the program's spans and the harness's submit
    and harvest spans."""
    harness = (trace.SUBMIT, trace.HARVEST)
    return [(n, s, d) for n, cat, s, d in tl.host
            if cat == ANNOTATION and (n.startswith(PROGRAM) or n in harness)]


def _shortest(named, start: float, dur: float):
    """The name of the shortest of ``named`` holding all of ``[start,
    start + dur]``, or None."""
    best = None
    for n, s, d in named:
        if s <= start and start + dur <= s + d and \
                (best is None or d < best[1]):
            best = (n, d)
    return None if best is None else best[0]


def by_span(tl, items, whole: bool = False) -> dict:
    """``items`` (start_us, dur_us) summed by the shortest span holding
    each one's midpoint (``whole``: all of it): {span: [count, us]}."""
    named = _named(tl)
    out: dict = {}
    for s, d in items:
        name = _shortest(named, s, d) if whole else \
            _shortest(named, s + d / 2, 0.0)
        row = out.setdefault(name or "none", [0, 0.0])
        row[0] += 1
        row[1] += d
    return out


def split_by_span(tl, items) -> dict:
    """``items`` cut where spans start and end, each piece summed by the
    innermost span over it: {span: us}."""
    named = _named(tl)
    out: dict = {}
    for s, d in items:
        near = [x for x in named if x[1] < s + d and s < x[1] + x[2]]
        cuts = sorted({s, s + d} | {t for _, a, b in near
                                    for t in (a, a + b) if s < t < s + d})
        for a, b in zip(cuts, cuts[1:]):
            k = _shortest(near, (a + b) / 2, 0.0) or "none"
            out[k] = out.get(k, 0.0) + b - a
    return out
