"""Runtime observability of the port (copy of ``repro.obs``): span tracing,
metrics, Perfetto timelines.

Three pieces, layered over the serving gateway, the plan cache, the
pipelined dispatcher and the mapper ladder:

* :mod:`repro_torch.obs.trace` — a thread-safe, near-zero-overhead span
  tracer (per-thread ring buffers, one process-global switch);
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
from .trace import (annotate, counter, disable, disable_profiler_bridge,
                    enable, enable_profiler_bridge, enabled, instant, span,
                    traced)

__all__ = [
    "trace", "metrics", "export",
    "enable", "disable", "enabled", "span", "instant", "traced",
    "counter", "annotate", "enable_profiler_bridge",
    "disable_profiler_bridge",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "COMPILE_LEDGER", "get_registry",
    "to_chrome_trace", "write_chrome_trace", "validate_chrome_trace",
]
