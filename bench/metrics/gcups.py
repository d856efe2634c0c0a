"""gcups: the live cells (q_len x r_len) of every pair harvested in the
window, over the window's seconds, in billions a second (host clock)."""


def read(run):
    if run.window_s <= 0 or run.cells <= 0:
        return None
    return run.cells / run.window_s / 1e9
