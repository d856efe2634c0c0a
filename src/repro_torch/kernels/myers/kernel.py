"""K2: the Myers bit-vector kernel for Hopper, its launcher and its plain
PyTorch version (port of ``repro/kernels/myers/kernel.py``).

``myers_fill`` takes a batch of padded pairs and returns, per pair, the
corner score, the last-row minimum and its first column, after the column
sweep of ``repro_torch.core.myers`` with the provable-k exit.  A CUDA tensor
goes to the CUDA kernel in ``csrc/myers.cu``; a CPU tensor goes to
``myers_fill_plain``.  Nothing falls back from one to the other.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core import myers as M

SOURCE = Path(__file__).resolve().parent / "csrc" / "myers.cu"
# 64-bit words per column the CUDA kernel is instantiated for
WORDS = (1, 2, 4, 8, 16)
MAX_QUERY = 64 * WORDS[-1]
# Steps between the kernel's tests of the provable-k exit (it also tests the
# last column), a copy of csrc/myers.cu's CHECK_EVERY: min(best, score -
# columns left) never falls again once it exceeds k, so a late test gives
# the outputs of a test at every column.
CHECK_EVERY = 8

# CUDA kernel launches since import (or since a caller reset it to 0); the
# plain version does not count.
launches = 0


def n_words(q_bucket: int) -> int:
    """The kernel instantiation (64-bit words per column) for a query
    bucket."""
    need = max(1, -(-int(q_bucket) // 64))
    for nw in WORDS:
        if nw >= need:
            return nw
    raise ValueError(f"query bucket {q_bucket} exceeds K2's largest "
                     f"instantiation ({MAX_QUERY} rows)")


def _check_inputs(query, ref, lens):
    if query.dim() != 2 or ref.dim() != 2:
        raise ValueError("query and ref must be (batch, length)")
    B, Q = query.shape
    R = ref.shape[1]
    if Q < 1 or R < 1:
        raise ValueError("query and reference buckets must be at least 1")
    want = {"query": (query, torch.uint8, (B, Q)),
            "ref": (ref, torch.uint8, (B, R)),
            "lens": (lens, torch.int32, (B, 2))}
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != query.device:
            raise ValueError(f"{name} is on {t.device}, query on "
                             f"{query.device}")


def myers_fill(query, ref, lens, *, glob: bool, k: int):
    """Sweep a batch of pairs.

    query (B, Q) and ref (B, R) uint8 codes, lens (B, 2) int32
    ``[q_len, r_len]``; ``glob`` selects the corner score (edit_distance)
    over the last-row search (edit_search); ``k >= 0`` stops a pair once its
    distance provably exceeds k.  Returns ``(score, best, best_j)``, each
    (B,) int32; a pair stopped early, or with an empty side, reports
    ``(1 << 30, 1 << 30, 0)``.
    """
    _check_inputs(query, ref, lens)
    if query.device.type == "cpu":
        return myers_fill_plain(query, ref, lens, glob=glob, k=k)
    if query.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not "
                         f"{query.device}")
    return _launch(query.contiguous(), ref.contiguous(), lens.contiguous(),
                   bool(glob), int(k))


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE).lib
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.myers_fill_launch.argtypes = [i] * 3 + [p] * 6 + [i] * 3 + [p]
        lib.myers_fill_launch.restype = i
        _LIB = lib
    return _LIB


def _launch(query, ref, lens, glob, k):
    global launches
    lib = _lib()
    dev = query.device
    B, Q = query.shape
    R = ref.shape[1]
    nw = n_words(Q)
    score = torch.empty((B,), dtype=torch.int32, device=dev)
    best = torch.empty((B,), dtype=torch.int32, device=dev)
    best_j = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.myers_fill_launch(
            nw, int(glob), k, query.data_ptr(), ref.data_ptr(),
            lens.data_ptr(), score.data_ptr(),
            best.data_ptr(), best_j.data_ptr(), B, Q, R, stream)
    if err:
        raise RuntimeError(f"K2 myers_fill launch failed: CUDA error {err} "
                           f"(Q={Q}, R={R}, batch {B}, {nw} words)")
    launches += 1
    return score, best, best_j


def myers_fill_plain(query, ref, lens, *, glob: bool, k: int):
    """Plain PyTorch version of ``myers_fill``: same arguments, same outputs
    bit for bit.  It runs ``core.myers.sweep`` over (B, words) tensors of
    32-bit words held in int64."""
    score, best, best_j, _ = M.sweep(query, ref, lens, glob=glob, k=int(k))
    return score, best, best_j
