"""FSM traceback executor (counterpart of ``repro.core.traceback``).

The fill stores traceback pointers, packed ``pack`` per byte along the lane
axis when the kernel declares a narrow ``ptr_bits``; the walk is a pointer
chase driven by the kernel's FSM ``(state, ptr) -> (move, next_state)``.

The port reads the layout the wavefront kernel K1 emits,
``('chunk', n_pe[, pack])``: ``tb[chunk, lane // pack, w]`` with strip
height ``n_pe``, ``lane = (i - 1) % n_pe`` and chunk-local wavefront
``w = lane + j - 1``; lane ``l`` lives in slot ``l % pack`` of its byte
(8 // pack bits each); and the reference engine's row-major ``'row'``
store, ``tb[i, j]`` over the whole (Q+1, R+1) matrix; and the eager
wavefront engine's (``core.engine``) ``'diag'`` / ``('diag', pack)`` store,
``tb[(i + j) - 1, i // pack]`` with lane i in slot ``i % pack``.

The walk is plain torch: the JAX package computes it outside any kernel.
``run_batched`` advances every row of a block with masked updates over a
step bound the host already knows, and asks the device whether all rows are
done only every ``DONE_CHECK_EVERY`` steps, because each such test is a
host synchronisation.
"""
from __future__ import annotations

import numpy as np
import torch

from . import types as T

DONE_CHECK_EVERY = 64


class TracebackTruncated(RuntimeError):
    """The walk ran out of its ``max_len`` step budget before reaching a stop
    cell — the recorded path is a corrupt prefix."""


def pack_lanes(ptr, pack: int):
    """Pack pointers along the last axis: ``(..., lanes)`` small ints ->
    ``(..., ceil(lanes / pack))`` uint8, ``pack`` slots of 8 // pack bits per
    byte (slot s = lane ``base + s``).  ``pack=1`` is a cast."""
    if pack == 1:
        return ptr.to(torch.uint8)
    if pack not in (2, 4, 8):
        raise ValueError(f"pack must be 1, 2, 4 or 8, got {pack}")
    width = 8 // pack
    lanes = ptr.shape[-1]
    padded = -(-lanes // pack) * pack
    if padded != lanes:
        ptr = torch.nn.functional.pad(ptr, (0, padded - lanes))
    slots = ptr.reshape(ptr.shape[:-1] + (padded // pack, pack))
    slots = slots.to(torch.int32) & ((1 << width) - 1)
    acc = torch.zeros(slots.shape[:-1], dtype=torch.int32, device=ptr.device)
    for s in range(pack):
        acc = acc | (slots[..., s] << (s * width))
    return acc.to(torch.uint8)


def _unpack(byte, slot, pack: int):
    width = 8 // pack
    return (byte.to(torch.int32) >> (slot * width)) & ((1 << width) - 1)


def _chunk_layout(layout):
    if isinstance(layout, tuple) and layout[0] == "chunk":
        return layout[1], (layout[2] if len(layout) > 2 else 1)
    raise ValueError(f"unknown tb layout {layout!r}")


def _diag_pack(layout):
    """The pack factor of a 'diag' layout, None for any other layout."""
    if layout == "diag":
        return 1
    if isinstance(layout, tuple) and layout[0] == "diag":
        return layout[1]
    return None


def _make_reader(tb, layout):
    """``read(i, j) -> ptr`` over a batched store: ``(B, C, n_pe/pack, W)``
    for the chunk layout, ``(B, Q+1, R+1)`` for ``'row'``, ``(B, rows,
    ceil((Q+1)/pack))`` for the 'diag' layouts; ``i``/``j`` are ``(B,)``.

    Boundary cells (i == 0 or j == 0) hold no pointer and read as END, as
    in the reference engine's row-major store, whose row 0 and column 0
    hold 0.  (JAX's chunk reader clamps them onto a stored cell instead,
    which a local kernel's walk can reach after a diagonal step out of row
    1 or column 1.)"""
    rows = torch.arange(tb.shape[0], device=tb.device)
    if layout == "row":
        def read_row(i, j):
            return tb[rows, i.clamp(0, tb.shape[1] - 1).long(),
                      j.clamp(0, tb.shape[2] - 1).long()].to(torch.int32)
        return read_row
    dpack = _diag_pack(layout)
    if dpack is not None:
        # boundary cells read 0 here too: diagonal d stores no pointer at
        # lane 0 (row 0) or at lane d (column 0)
        def read_diag(i, j):
            d = (i + j - 1).clamp(0, tb.shape[1] - 1).long()
            byte = tb[rows, d, (i // dpack).clamp(0, tb.shape[2] - 1).long()]
            return _unpack(byte, i % dpack, dpack)
        return read_diag
    n_pe, pack = _chunk_layout(layout)

    def read(i, j):
        c = torch.div(i - 1, n_pe, rounding_mode="floor").clamp(
            0, tb.shape[1] - 1)
        lane = torch.remainder(i - 1, n_pe).clamp(0, n_pe - 1)
        w = (lane + j - 1).clamp(0, tb.shape[3] - 1)
        byte = tb[rows, c, lane // pack, w]
        ptr = _unpack(byte, lane % pack, pack)
        return torch.where((i <= 0) | (j <= 0), 0, ptr)
    return read


def default_max_len(tb_shape, layout) -> int:
    """Safe step budget from the (unbatched) store shape: an upper bound on
    Q + R, plus one for the terminating cell."""
    if layout == "row":
        return tb_shape[0] + tb_shape[1]
    if _diag_pack(layout) is not None:
        return tb_shape[0] + 1          # >= Q + R wavefront rows
    n_pe, _ = _chunk_layout(layout)
    q = tb_shape[0] * n_pe
    r = tb_shape[2] - n_pe + 1
    return q + r + 1


def _fsm_step(tspec, read, i, j, state):
    """One FSM transition for every row."""
    stop_here = tspec.stop_fn(i, j)
    ptr = read(i, j)
    move, nstate = tspec.fsm(state, ptr)
    # Boundary cells hold no pointer: kernels that trace to the origin/top
    # row walk LEFT along row 0 and UP along column 0; local/overlap
    # kernels end there instead (END pointer / stop condition).
    if tspec.stop in (T.STOP_ORIGIN, T.STOP_TOP_ROW):
        on_row0 = (i == 0) & (j > 0)
        on_col0 = (j == 0) & (i > 0)
        move = torch.where(on_row0, T.MOVE_LEFT,
                           torch.where(on_col0, T.MOVE_UP, move))
        nstate = torch.where(on_row0 | on_col0, state, nstate)
    is_end = stop_here | (move == T.MOVE_END)
    di = ((move == T.MOVE_DIAG) | (move == T.MOVE_UP)).to(torch.int32)
    dj = ((move == T.MOVE_DIAG) | (move == T.MOVE_LEFT)).to(torch.int32)
    return move.to(torch.int32), nstate.to(torch.int32), is_end, di, dj


def run_batched(spec: T.DPKernelSpec, result: T.DPResult,
                max_len: int | None = None,
                step_bound: int | None = None) -> T.Alignment:
    """Walk every row of a batched fill from its end cell to its start.

    ``max_len`` is the move array's length (default: from the store shape).
    ``step_bound`` is the most steps any row can take, known on the host
    before launch (``max(q_len + r_len) + 1`` over the block); the loop runs
    at most that many masked steps and stops early once every row is done.
    Bit-identical to the JAX walk row by row.
    """
    tspec = spec.traceback
    if tspec is None:
        raise ValueError(f"kernel {spec.name} has no traceback")
    tb = result.tb
    if max_len is None:
        max_len = default_max_len(tuple(tb.shape[1:]), result.tb_layout)
    bound = max_len if step_bound is None else min(int(step_bound), max_len)
    dev = tb.device
    n = tb.shape[0]
    rows = torch.arange(n, device=dev)
    read = _make_reader(tb, result.tb_layout)

    i = torch.as_tensor(result.end_i, device=dev).to(torch.int32).reshape(n)
    j = torch.as_tensor(result.end_j, device=dev).to(torch.int32).reshape(n)
    state = torch.full((n,), tspec.initial_state, dtype=torch.int32,
                       device=dev)
    k = torch.zeros((n,), dtype=torch.int32, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    moves = torch.zeros((n, max_len), dtype=torch.uint8, device=dev)
    for step in range(bound):
        if step and step % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        active = ~done & (k < max_len)
        move, nstate, is_end, di, dj = _fsm_step(tspec, read, i, j, state)
        rec = torch.where(is_end, 0, move).to(torch.uint8)
        kc = k.clamp(0, max_len - 1).long()
        moves[rows, kc] = torch.where(active, rec, moves[rows, kc])
        go = active & ~is_end
        i = torch.where(go, i - di, i)
        j = torch.where(go, j - dj, j)
        k = torch.where(go, k + 1, k)
        state = torch.where(active, nstate, state)
        done = done | (active & is_end)
    return T.Alignment(score=result.score, end_i=result.end_i,
                       end_j=result.end_j, start_i=i, start_j=j,
                       moves=moves, n_moves=k, truncated=~done)


def run(spec: T.DPKernelSpec, result: T.DPResult,
        max_len: int | None = None) -> T.Alignment:
    """Walk one alignment: ``result`` holds a single pair (no batch axis)."""
    batched = T.DPResult(
        score=result.score, end_i=torch.as_tensor(result.end_i).reshape(1),
        end_j=torch.as_tensor(result.end_j).reshape(1),
        tb=result.tb[None], tb_layout=result.tb_layout)
    a = run_batched(spec, batched, max_len)
    return T.Alignment(score=result.score, end_i=result.end_i,
                       end_j=result.end_j, start_i=a.start_i[0],
                       start_j=a.start_j[0], moves=a.moves[0],
                       n_moves=a.n_moves[0], truncated=a.truncated[0])


def raise_if_truncated(alignment: T.Alignment) -> T.Alignment:
    """Host-side guard: error out instead of consuming a corrupt partial
    path."""
    t = alignment.truncated
    if t is not None and bool(np.any(_to_numpy(t))):
        raise TracebackTruncated(
            "traceback ran out of its step budget before reaching a stop "
            "cell; the move array is a corrupt partial path (re-run with a "
            "larger max_len — the default budget derived from the pointer "
            "store is always sufficient)")
    return alignment


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Host-side utilities
# ---------------------------------------------------------------------------
def moves_to_cigar(moves, n_moves, ops=None) -> str:
    """end->start move array -> CIGAR string (start->end order).  The
    default map follows the repo convention (MOVE_UP = query-consuming =
    'D')."""
    if ops is None:
        ops = {T.MOVE_DIAG: "M", T.MOVE_UP: "D", T.MOVE_LEFT: "I"}
    n = int(n_moves)
    if n == 0:
        return ""
    mv = _to_numpy(moves)[:n][::-1]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(mv)) + 1])
    ends = np.concatenate([starts[1:], [n]])
    return "".join(f"{e - s}{ops[int(mv[s])]}"
                   for s, e in zip(starts, ends))


def path_cells(alignment: T.Alignment):
    """The (i, j) cells on the path from start to end (host-side)."""
    i0, j0 = int(alignment.start_i), int(alignment.start_j)
    mv = _to_numpy(alignment.moves)[: int(alignment.n_moves)][::-1]
    mv = mv.astype(np.int64)
    di = np.cumsum((mv == T.MOVE_DIAG) | (mv == T.MOVE_UP))
    dj = np.cumsum((mv == T.MOVE_DIAG) | (mv == T.MOVE_LEFT))
    ii = np.concatenate([[i0], i0 + di])
    jj = np.concatenate([[j0], j0 + dj])
    return [(int(a), int(b)) for a, b in zip(ii, jj)]
