"""PyTorch/CUDA port of the DP-HLS alignment framework.

Mirrors the module layout of the JAX package ``repro``: ``repro_torch.core``
holds the kernel declarations, traceback and public API, ``repro_torch.runtime``
the engine registry, bucketing, plan cache and batch dispatch, and
``repro_torch.kernels`` the hand-written CUDA kernels with their plain
PyTorch versions.  The package imports torch and numpy only.

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; without a CUDA device they raise instead of falling back.
"""
