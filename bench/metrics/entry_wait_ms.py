"""entry_wait_ms: the milliseconds a traced call that the host thread
spends blocked in synchronising CUDA runtime calls inside the batch entry
(the ``batch.align`` span): the wait for the previous call's K1 that the
codes' synchronous copy (``core/api.py::as_codes``) makes
(``bench/spans.py``)."""
from bench import spans


def read(run):
    tl = run.trace
    if not spans.readable(tl, (spans.ENTRY,)):
        return None
    return spans.per_call_ms(tl, spans.wait_us(tl, spans.ENTRY))
