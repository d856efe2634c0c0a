"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Nothing here builds or loads a kernel at import time."""


def aligned16(t):
    """``t`` made contiguous, copied once more if its data does not start
    on a 16-byte boundary (the K3 and K4 kernels load 16-byte chunks)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
