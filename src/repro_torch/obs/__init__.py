"""Runtime observability of the port (copy of ``repro.obs``): span tracing,
metrics, Perfetto timelines.

Three pieces, layered over the batch entry, the plan cache, K1's wrapper,
the serving gateway, the pipelined dispatcher and the mapper ladder:

* :mod:`repro_torch.obs.trace` — a thread-safe, near-zero-overhead span
  tracer with two sinks: per-thread ring buffers (one process-global
  switch) and, while a ``torch.profiler`` session records, its timeline;
* :mod:`repro_torch.obs.metrics` — counters / gauges / log-bucketed
  histograms with JSON snapshots and Prometheus text exposition, plus
  the plan-compile ledger;
* :mod:`repro_torch.obs.export` — Chrome trace-event JSON (load at
  https://ui.perfetto.dev) and the schema validator.

Quickstart::

    from repro_torch import obs
    obs.trace.enable()
    svc.serve(n_workers=4)
    svc.dump_trace("gateway_trace.json")     # open in Perfetto
    print(svc.metrics()["reconcile"])        # submitted == resolved?
"""
from . import export, metrics, trace
from .export import (to_chrome_trace, validate_chrome_trace,
                     write_chrome_trace)
from .metrics import (COMPILE_LEDGER, REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry, get_registry)
from .trace import counter, disable, enable, enabled, instant, span

__all__ = [
    "trace", "metrics", "export",
    "enable", "disable", "enabled", "span", "instant", "counter",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "COMPILE_LEDGER", "get_registry",
    "to_chrome_trace", "write_chrome_trace", "validate_chrome_trace",
]
