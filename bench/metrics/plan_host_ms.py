"""plan_host_ms: the host's own milliseconds a traced call in the plan
(``runtime/plan.py``): the ``plan.get`` span, plus the ``plan.run`` span
less its ``k1.*`` children, each less the blocking CUDA runtime calls
under it (``bench/spans.py``)."""
from bench import spans


def read(run):
    tl = run.trace
    if not spans.readable(tl, spans.PLAN):
        return None
    return spans.per_call_ms(tl, spans.own_us(tl, "plan.get")
                             + spans.own_us(tl, "plan.run", spans.K1))
