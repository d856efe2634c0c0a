"""Myers bit-parallel edit distance, the plain PyTorch engine (counterpart of
``repro.core.myers``).

For the unit-cost kernels (#16 ``edit_distance``, #17 ``edit_search``) one
column of the DP matrix is delta-encoded in two bit-vectors (VP/VN: +1/-1
vertical differences) and advances with a few word-wide bitwise operations
instead of one update per cell (Myers 1999).  Longer queries use Hyyrö's
blocked form: words couple only through the horizontal delta ``hin``/``hout``
at their boundary row.

Words are 32 bits wide here, each held in an int64: PyTorch has no full
uint32/uint64 arithmetic on the CPU, so every ``+``, ``~`` and ``<<`` is
masked with ``& MASK``, which keeps ``>>`` logical and the int64 free of
overflow.  Kernel K2 (``kernels/myers``) uses native 64-bit words; results do
not depend on the word width.

Modes follow the kernel's region: ``REGION_CORNER`` (edit_distance) feeds
``hin = +1`` into every column (row 0 costs j) and answers at the corner;
``REGION_LAST_ROW`` (edit_search) feeds ``hin = 0`` and answers with the
last-row minimum and its first column.  With a threshold ``k >= 0`` a row
stops as soon as its distance provably exceeds k: the last-row score moves
by at most 1 per column.
"""
from __future__ import annotations

import torch

from . import types as T

# Fixed symbol-table height: covers DNA_N (5 codes) and PROTEIN (24 codes);
# reference codes are clipped into it, query codes past it match nothing.
N_SYMBOLS = 32
WORD_BITS = 32
MASK = (1 << WORD_BITS) - 1
DONE_CHECK_EVERY = 64

# Kernels whose recurrence the myers engine hard-codes.
UNIT_COST_KERNELS = ("edit_distance", "edit_search")


def supports(spec: T.DPKernelSpec):
    """None when the myers engine can compute ``spec``, else the reason."""
    if spec.name not in UNIT_COST_KERNELS:
        return (f"myers engine computes the unit-cost edit recurrence and "
                f"only accepts kernels {UNIT_COST_KERNELS}, "
                f"got {spec.name!r}")
    if spec.band is not None:
        return ("myers engine does not support fixed banding; "
                "use params['max_dist'] thresholding instead")
    if spec.objective != "min":
        return (f"unit-cost edit distance is a min-objective recurrence, "
                f"got objective={spec.objective!r}")
    if spec.region not in (T.REGION_CORNER, T.REGION_LAST_ROW):
        return (f"myers engine computes corner (distance) or last-row "
                f"(search) optima only, got region={spec.region!r}")
    return None


def check_spec(spec: T.DPKernelSpec) -> None:
    reason = supports(spec)
    if reason is not None:
        raise ValueError(reason)


def build_peq(queries, q_lens, n_words: int):
    """Per-query match tables: ``peq[b, s, w]`` has bit t set iff query row
    ``32 w + t`` (< q_lens[b]) holds symbol ``s``.  Padding rows and codes
    of ``N_SYMBOLS`` or more match nothing.  (B, N_SYMBOLS, n_words) int64
    holding 32-bit words."""
    B, Q = queries.shape
    dev = queries.device
    rows = torch.arange(Q, device=dev)
    codes = queries.long()
    live = (rows < q_lens[:, None]) & (codes < N_SYMBOLS)
    # each (symbol, word, bit) is hit at most once, so a sum is a bitwise or
    index = codes.clamp(max=N_SYMBOLS - 1) * n_words + rows // WORD_BITS
    bits = torch.where(live, 1 << (rows % WORD_BITS), 0)
    peq = torch.zeros((B, N_SYMBOLS * n_words), dtype=torch.int64, device=dev)
    peq.scatter_add_(1, index, bits)
    return peq.reshape(B, N_SYMBOLS, n_words)


def _advance_word(hin_pos, hin_neg, vp, vn, eq):
    """One 32-bit word of one column (Myers 1999 / Hyyrö's blocked step) for
    every row of the batch.  The horizontal delta at the word's boundary row,
    the only state crossing words, travels as two 0/1 words: ``hin_pos``
    (+1) and ``hin_neg`` (-1).  Returns ``(hout_pos, hout_neg, vp, vn, ph,
    mh)``."""
    xv = eq | vn
    eq = eq | hin_neg
    xh = ((((eq & vp) + vp) & MASK) ^ vp) | eq
    ph = vn | ((xh | vp) ^ MASK)
    mh = vp & xh
    ph_s = ((ph << 1) & MASK) | hin_pos
    mh_s = ((mh << 1) & MASK) | hin_neg
    top = WORD_BITS - 1
    return (ph >> top, mh >> top, mh_s | ((xv | ph_s) ^ MASK), ph_s & xv,
            ph, mh)


def sweep(queries, refs, lens, *, glob: bool, k: int, trace: bool = False):
    """The column sweep of a batch: ``queries`` (B, Q) and ``refs`` (B, R)
    uint8 codes, ``lens`` (B, 2) int32 ``[q_len, r_len]`` (clamped to the
    buckets).  Runs each row to its ``r_len``, or stops it once a threshold
    ``k >= 0`` is provably exceeded.

    Returns ``(score, best, best_j, cols)`` int32 (B,): the last-row score
    at the corner, the last-row minimum and its first column (search mode;
    ``SENT``/0 in corner mode), and the columns each row ran.  A row that
    stopped early, or whose query or reference is empty, reports
    ``(SENT, SENT, 0)``.  ``trace=True`` appends the last-row score after
    each column, (B, columns swept + 1) int32 with column 0 = q_len, held at
    its last value past a row's ``r_len`` or stop."""
    B, Q = queries.shape
    R = refs.shape[1]
    dev = queries.device
    sent = T.INT_SENTINEL
    q_len = lens[:, 0].long().clamp(0, Q)
    r_len = lens[:, 1].long().clamp(0, R)
    n_words = max(1, -(-Q // WORD_BITS))
    peq = build_peq(queries, q_len, n_words)
    # the score row q_len sits at word sw, bit sb; words above sw never
    # reach it (carries move up a word only through hin), so they are skipped
    last = (q_len - 1).clamp(min=0)
    sw = last // WORD_BITS
    sb = last % WORD_BITS
    live_words = int(sw.max()) + 1 if B else 0
    n_cols = int(r_len.max()) if B else 0
    ref_codes = refs.long().clamp(max=N_SYMBOLS - 1)

    vp = [torch.full((B,), MASK, dtype=torch.int64, device=dev)
          for _ in range(live_words)]
    vn = [torch.zeros((B,), dtype=torch.int64, device=dev)
          for _ in range(live_words)]
    score = q_len.clone()
    best = torch.full((B,), sent, dtype=torch.int64, device=dev)
    best_j = torch.zeros((B,), dtype=torch.int64, device=dev)
    cols = torch.zeros((B,), dtype=torch.int64, device=dev)
    active = (q_len >= 1) & (r_len >= 1)
    stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)
    # row 0 costs j in corner mode (hin = +1 into every column), 0 in search
    hin_pos0 = torch.full((B,), int(glob), dtype=torch.int64, device=dev)
    hin_neg0 = torch.zeros((B,), dtype=torch.int64, device=dev)
    trail = [score] if trace else None
    for j in range(1, n_cols + 1):
        in_ref = j <= r_len
        if k >= 0:
            # most optimistic finish: the last-row score moves <= 1/column
            reach = torch.minimum(best, score - (r_len - (j - 1)))
            stop = active & in_ref & (reach > k)
            stopped |= stop
            active &= ~stop
        active &= in_ref
        if j % DONE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        eq_col = peq[rows, ref_codes[:, j - 1]]
        hp, hn = hin_pos0, hin_neg0
        ph_w, mh_w = [], []
        for w in range(live_words):
            hp, hn, vp[w], vn[w], ph, mh = _advance_word(hp, hn, vp[w], vn[w],
                                                         eq_col[:, w])
            ph_w.append(ph)
            mh_w.append(mh)
        ph = torch.stack(ph_w, 1).gather(1, sw[:, None])[:, 0]
        mh = torch.stack(mh_w, 1).gather(1, sw[:, None])[:, 0]
        inc = ((ph >> sb) & 1) - ((mh >> sb) & 1)
        score = torch.where(active, score + inc, score)
        if not glob:
            upd = active & (score < best)
            best = torch.where(upd, score, best)
            best_j = torch.where(upd, j, best_j)
        cols += active.long()
        if trace:
            trail.append(score)

    dead = stopped | (q_len < 1) | (r_len < 1)
    score = torch.where(dead, sent, score)
    best = torch.where(dead, sent, best)
    best_j = torch.where(dead, 0, best_j)
    i32 = torch.int32
    out = (score.to(i32), best.to(i32), best_j.to(i32), cols.to(i32))
    if trace:
        out += (torch.stack(trail, 1).to(i32),)
    return out
