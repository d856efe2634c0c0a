"""K2: the Myers bit-vector kernel for Hopper, its launcher and its plain
PyTorch version (port of ``repro/kernels/myers/kernel.py``).

``myers_fill`` takes a batch of padded pairs and returns, per pair, the
corner score, the last-row minimum and its first column, after the column
sweep of ``repro_torch.core.myers`` with the provable-k exit.  A CUDA tensor
goes to the CUDA kernel in ``csrc/myers.cu``; a CPU tensor goes to
``myers_fill_plain``.  Nothing falls back from one to the other.

The sweep dispatches the operator ``repro_torch::myers_fill`` (see
``kernels/__init__.py``), counted by ``fill_work`` from shapes alone.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.core import myers as M
from repro_torch.kernels import Work, call, nbytes, register_work

SOURCE = Path(__file__).resolve().parent / "csrc" / "myers.cu"
# 64-bit words per column the CUDA kernel is instantiated for
WORDS = (1, 2, 4, 8, 16)
MAX_QUERY = 64 * WORDS[-1]
# int32 lane operations K2's work needs, counted from the word step in
# csrc/myers.cu at the fewest Hopper instructions: LOP3 does any
# three-input logic per 32-bit half, IADD3 and IADD3.X the 64-bit add, LEA
# (low half, with the carry-in bit) and SHF.L.U64.HI (high half) a shift by
# one.  Per live word-column: xv, eq & vp, the add, xh, ph, mh, ph << 1,
# mh << 1, vp and vn at 2 each, and hin's -1 into eq's low half at 1.  Per
# word that hands hout to the word above: the top bits of ph and mh, 1
# each.  Per column of the search the screen runs: the score's two bit
# extracts (a shift and a mask each), one IADD3, and the argmin (a compare
# and two selects).
OPS_PER_WORD_COLUMN = 21
OPS_PER_HANDOFF = 2
OPS_PER_COLUMN = 8
# Steps between the kernel's tests of the provable-k exit (it also tests the
# last column), a copy of csrc/myers.cu's CHECK_EVERY: min(best, score -
# columns left) never falls again once it exceeds k, so a late test gives
# the outputs of a test at every column.
CHECK_EVERY = 8

# CUDA kernel launches since import (or since a caller reset it to 0); the
# plain version does not count.  Service workers launch from several
# threads, so the count is taken under a lock.
launches = 0
_COUNT_LOCK = threading.Lock()


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
    if query.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not "
                         f"{query.device}")
    return call(torch.ops.repro_torch.myers_fill, _FILL, (query, ref, lens),
                query, ref, lens, bool(glob), int(k))


@torch.library.custom_op("repro_torch::myers_fill", mutates_args=())
def _fill_op(query: torch.Tensor, ref: torch.Tensor, lens: torch.Tensor,
             glob: bool, k: int
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``myers_fill``'s operator: (score, best, best_j)."""
    raise ValueError(f"K2 runs on CUDA or CPU tensors, not {query.device}")


@_fill_op.register_kernel("cpu")
def _fill_cpu(query, ref, lens, glob, k):
    return myers_fill_plain(query, ref, lens, glob=glob, k=k)


@_fill_op.register_kernel("cuda")
def _fill_cuda(query, ref, lens, glob, k):
    return _launch(query.contiguous(), ref.contiguous(), lens.contiguous(),
                   glob, k)


_FILL = {"cpu": _fill_cpu, "cuda": _fill_cuda}


@_fill_op.register_fake
def _fill_fake(query, ref, lens, glob, k):
    return tuple(query.new_empty((query.shape[0],), dtype=torch.int32)
                 for _ in range(3))


def fill_work(query, ref, lens, glob, k) -> Work:
    """K2: ``OPS_PER_WORD_COLUMN`` int32 operations for each of the
    instantiation's words (``n_words`` of the query bucket) in every
    reference column of every pair, the query, reference and lengths read
    and three int32 outputs written once.  A pair that stops early (the
    provable-k exit) or is shorter than its bucket does less, so the count
    is an upper bound."""
    B, Q = query.shape
    R = ref.shape[1]
    return Work({"int32": OPS_PER_WORD_COLUMN * n_words(Q) * R * B},
                nbytes(query, ref, lens) + 3 * B * 4)


register_work(_fill_op, fill_work)


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
    with _COUNT_LOCK:
        launches += 1
    return score, best, best_j


def myers_fill_plain(query, ref, lens, *, glob: bool, k: int):
    """Plain PyTorch version of ``myers_fill``: same arguments, same outputs
    bit for bit.  It runs ``core.myers.sweep`` over (B, words) tensors of
    32-bit words held in int64."""
    score, best, best_j, _ = M.sweep(query, ref, lens, glob=glob, k=int(k))
    return score, best, best_j
