"""k1_roofline: the least time an H100 could take for the traced calls'
live cells (``bench/floor.py`` and the configuration's frozen floor), over
the device time of K1's kernels (``wavefront_kernel``) in the traced
segment, in percent."""
from bench import floor

KERNEL = "wavefront_kernel"


def read(run):
    tl = run.trace
    if tl is None:
        return None
    k1_s = tl.device_seconds(KERNEL)
    if k1_s <= 0 or tl.cells <= 0:
        return None
    bound_s, _ = floor.bound_seconds(run.config["floor"], tl.cells, tl.bases,
                                     tl.pairs)
    return 100.0 * bound_s / k1_s
