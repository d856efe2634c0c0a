"""k1_host_ms: the host's own milliseconds a traced call in K1's wrapper
(``kernels/wavefront/ops.py`` and ``kernel.py::_launch``): the
``k1.prep``, ``k1.launch`` and ``k1.fold`` spans, each less the blocking
CUDA runtime calls under it (``bench/spans.py``)."""
from bench import spans


def read(run):
    tl = run.trace
    if not spans.readable(tl, spans.K1):
        return None
    return spans.per_call_ms(tl, sum(spans.own_us(tl, n) for n in spans.K1))
