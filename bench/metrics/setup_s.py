"""setup_s: seconds from the process's start to the first timed call:
imports, the CUDA context, loading or building K1's library, making the
pool and running each block once (host clock)."""


def read(run):
    return run.setup_s
