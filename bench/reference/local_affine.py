"""Plain reference of Smith-Waterman-Gotoh (local alignment, affine gaps)
in PyTorch, written from the recurrence alone: it imports nothing of the
program and reads only the configuration's scoring and the codes.

For cells 1 <= i <= q_len, 1 <= j <= r_len (query on rows):

    I(i, j) = max(H(i, j-1) + open, I(i, j-1) + extend)     (from the left)
    D(i, j) = max(H(i-1, j) + open, D(i-1, j) + extend)     (from above)
    H(i, j) = max(H(i-1, j-1) + s(q_i, r_j), I(i, j), D(i, j), 0)

with H = 0 and I = D = dead on row 0 and column 0.  A gap of k bases
costs ``open + (k - 1) * extend``.  The answer is the best H over every
live cell and its end cell, the first best cell in row-major order.

The sweep runs row by row, vectorised over pairs and columns, in the
integer type it is given: int32 is exact; the control runs it in a
narrower type, whose sums wrap as the card's would.
"""
from __future__ import annotations

import numpy as np
import torch

FIELDS = ("score", "end_i", "end_j")
TB_FIELDS = ("start_i", "start_j", "n_moves", "moves")
EXACT_DTYPE = torch.int32
# int16 holds every score of these cells exactly (|score| <= 4096), so it
# is no fault; the control steps down to int8, the first type that is one
CONTROL_DTYPE = torch.int8

MOVE_END, MOVE_DIAG, MOVE_UP, MOVE_LEFT = 0, 1, 2, 3


def _scoring(cfg):
    p = cfg["program"]["params"]
    return (int(p["match"]), int(p["mismatch"]), int(p["gap_open"]),
            int(p["gap_extend"]))


def _sweep(cfg, q, r, ql, rl, dtype, keep: bool):
    """Best score and end cell of each pair, row by row; with ``keep``
    also the H, I and D matrices (3, B, Q+1, R+1) for a walk.

    Within a row, I is a running maximum: with ``gap_open <= gap_extend``
    an opening from a cell whose H came from I never beats extending that
    I, so I(i, j) = open + (j-1) extend + max_{k<j} (Hp(i, k) - k extend)
    over Hp, H without I; then H = max(Hp, I)."""
    match, mismatch, go, ge = _scoring(cfg)
    if go > ge:
        raise ValueError("the row sweep needs gap_open <= gap_extend")
    B, Q = q.shape
    R = r.shape[1]
    dev = q.device
    dead = torch.iinfo(dtype).min // 2
    c = {k: torch.tensor(v, dtype=dtype, device=dev)
         for k, v in (("m", match), ("x", mismatch), ("zero", 0),
                      ("dead", dead))}
    col = torch.arange(R + 1, device=dev)
    # in a narrower type these wrap, as the card's sums would
    k_ext = (col * ge).to(dtype)
    opening = (go + (col[1:] - 1) * ge).to(dtype)
    ql = ql.to(dev, torch.int64)
    live_col = (col >= 1) & (col <= rl.to(dev, torch.int64)[:, None])
    h = torch.zeros((B, R + 1), dtype=dtype, device=dev)        # row 0
    d = torch.full((B, R + 1), dead, dtype=dtype, device=dev)
    edge = torch.full((B, 1), dead, dtype=dtype, device=dev)
    best = torch.full((B,), dead, dtype=dtype, device=dev)
    bi = torch.zeros((B,), dtype=torch.int64, device=dev)
    bj = torch.zeros((B,), dtype=torch.int64, device=dev)
    mats = None
    if keep:
        mats = torch.full((3, B, Q + 1, R + 1), dead, dtype=dtype,
                          device=dev)
        mats[0, :, 0, :] = 0
        mats[0, :, :, 0] = 0
    for i in range(1, Q + 1):
        s = torch.where(q[:, i - 1:i] == r, c["m"], c["x"])
        d = torch.maximum(h + go, d + ge)
        d[:, 0] = dead
        hp = torch.maximum(torch.maximum(h[:, :-1] + s, d[:, 1:]),
                           c["zero"])
        hp = torch.cat([torch.zeros_like(edge), hp], 1)
        run = torch.cummax(hp - k_ext, 1).values
        ins = torch.cat([edge, run[:, :-1] + opening], 1)
        h = torch.maximum(hp, ins)
        hm = torch.where(live_col & (i <= ql)[:, None], h, c["dead"])
        top = hm.max(1).values
        first = torch.where(hm == top[:, None], col, R + 1).min(1).values
        take = top > best
        best = torch.where(take, top, best)
        bi = torch.where(take, i, bi)
        bj = torch.where(take, first, bj)
        if keep:
            for k, v in enumerate((h, ins, d)):
                mats[k][:, i] = v
    return best, bi, bj, mats


def _walk(cfg, q, r, mats, ends):
    """The reference's own traceback from each end cell, with the tie
    rules of the recurrence above read in a fixed order: H takes the
    diagonal, then D only where it is larger, then I only where it is
    larger, and ends where H <= 0; a gap layer extends only where the
    extension is larger than the opening."""
    match, mismatch, go, ge = _scoring(cfg)
    H, I, D = (m.cpu().numpy().astype(np.int64) for m in mats)
    q, r = q.cpu().numpy(), r.cpu().numpy()
    out = []
    for b, (i, j) in enumerate(ends):
        moves, state = [], "M"
        while True:
            if i <= 0 or j <= 0:
                break
            if state == "M":
                m = H[b, i - 1, j - 1] + (match if q[b, i - 1] == r[b, j - 1]
                                          else mismatch)
                src, h = MOVE_DIAG, m
                if D[b, i, j] > h:
                    src, h = MOVE_UP, D[b, i, j]
                if I[b, i, j] > h:
                    src, h = MOVE_LEFT, I[b, i, j]
                if h <= 0:
                    break
            else:
                src = MOVE_UP if state == "D" else MOVE_LEFT
            moves.append(src)
            if src == MOVE_DIAG:
                i, j, state = i - 1, j - 1, "M"
            elif src == MOVE_UP:
                ext = D[b, i - 1, j] + ge > H[b, i - 1, j] + go
                i, state = i - 1, "D" if ext else "M"
            else:
                ext = I[b, i, j - 1] + ge > H[b, i, j - 1] + go
                j, state = j - 1, "I" if ext else "M"
        out.append((i, j, moves[::-1]))
    return out


def reference(cfg, queries, refs, q_lens, r_lens, *, device="cpu",
              dtype=EXACT_DTYPE, walk=False) -> dict:
    """The answers of a batch of pairs as numpy arrays: ``score``,
    ``end_i``, ``end_j`` and, with ``walk``, the path of each
    (``start_i``, ``start_j``, ``moves`` in start-to-end order)."""
    q = torch.as_tensor(np.asarray(queries)).to(device)
    r = torch.as_tensor(np.asarray(refs)).to(device)
    best, bi, bj, mats = _sweep(cfg, q, r, torch.as_tensor(q_lens),
                                torch.as_tensor(r_lens), dtype, walk)
    out = {"score": best.cpu().numpy().astype(np.int64),
           "end_i": bi.cpu().numpy(), "end_j": bj.cpu().numpy()}
    if walk:
        paths = _walk(cfg, q, r, mats, zip(out["end_i"], out["end_j"]))
        out["start_i"] = np.array([p[0] for p in paths])
        out["start_j"] = np.array([p[1] for p in paths])
        out["moves"] = [np.array(p[2], np.int64) for p in paths]
    return out


def control(cfg, queries, refs, q_lens, r_lens, *, device="cpu") -> dict:
    """The reference in the program's place at the control precision."""
    return reference(cfg, queries, refs, q_lens, r_lens, device=device,
                     dtype=CONTROL_DTYPE)


def path_score(cfg, q, r, start_i, start_j, moves) -> int | None:
    """The score of a path of moves (start to end) from (start_i,
    start_j), or None where it leaves the matrix.  Each maximal run of one
    gap move is one gap."""
    match, mismatch, go, ge = _scoring(cfg)
    i, j, total, prev = int(start_i), int(start_j), 0, None
    if i < 0 or j < 0:
        return None
    for mv in moves:
        mv = int(mv)
        if mv == MOVE_DIAG:
            i, j = i + 1, j + 1
            if i > len(q) or j > len(r):
                return None
            total += match if q[i - 1] == r[j - 1] else mismatch
        elif mv in (MOVE_UP, MOVE_LEFT):
            i, j = (i + 1, j) if mv == MOVE_UP else (i, j + 1)
            if i > len(q) or j > len(r):
                return None
            total += ge if mv == prev else go
        else:
            return None
        prev = mv
    return total


def compare(cfg, got: dict, want: dict, inputs) -> tuple:
    """(numbers, bad): ``mismatched_pairs`` counts pairs whose score or end
    cell differs from the reference's; with a traceback, ``tb_bad_paths``
    counts paths that do not run from their start to the reported end cell
    or do not score the reference's best.  ``bad`` marks each failing
    pair."""
    bad = ((np.asarray(got["score"], np.int64) != want["score"])
           | (np.asarray(got["end_i"], np.int64) != want["end_i"])
           | (np.asarray(got["end_j"], np.int64) != want["end_j"]))
    numbers = {"mismatched_pairs": int(bad.sum())}
    if "moves" in got:
        queries, refs, q_lens, r_lens = inputs
        tb_bad = np.zeros_like(bad)
        for k in range(bad.shape[0]):
            n = int(got["n_moves"][k])
            mv = np.asarray(got["moves"][k])[:n][::-1]    # start -> end
            q = queries[k][: int(q_lens[k])]
            r = refs[k][: int(r_lens[k])]
            s = path_score(cfg, q, r, got["start_i"][k], got["start_j"][k],
                           mv)
            di = int(np.sum((mv == MOVE_DIAG) | (mv == MOVE_UP)))
            dj = int(np.sum((mv == MOVE_DIAG) | (mv == MOVE_LEFT)))
            tb_bad[k] = (s is None or s != want["score"][k]
                         or int(got["start_i"][k]) + di != want["end_i"][k]
                         or int(got["start_j"][k]) + dj != want["end_j"][k])
        numbers["tb_bad_paths"] = int(tb_bad.sum())
        bad = bad | tb_bad
    return numbers, bad
