"""device_idle_share: the share of the traced segment in which no device
operation (kernel, copy or set) runs, in percent, from the profiler's
timeline."""


def read(run):
    tl = run.trace
    if tl is None or tl.window_s <= 0 or tl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
