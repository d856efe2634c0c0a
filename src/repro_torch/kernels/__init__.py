"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Nothing here builds or loads a kernel at import time."""
