"""host_submit_ms: the host's own milliseconds a call in the entry, from
the traced segment: each ``bench.submit`` span (the entry's call, the plan
lookup, the launches) less the time its thread spent blocked in the CUDA
runtime's synchronising calls under it (the synchronous input copy waits
there for the previous call's kernels), averaged over the traced calls."""
from bench import trace

# CUDA runtime calls in which the host waits for the device
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")


def read(run):
    tl = run.trace
    if tl is None:
        return None
    spans = [(s, d) for n, cat, s, d in tl.host
             if n == trace.SUBMIT and cat == "user_annotation"]
    if not spans:
        return None
    waits = [(s, d) for n, cat, s, d in tl.host
             if cat == "cuda_runtime" and n in BLOCKING]
    own_us = 0.0
    for s, d in spans:
        own_us += d - sum(wd for ws, wd in waits
                          if s <= ws and ws + wd <= s + d)
    return own_us / len(spans) / 1e3
