"""Plain reference of the pair-HMM forward likelihood (GATK
HaplotypeCaller's PairHMM model, log space), written from the model
alone: it imports nothing of the program and works its parameters out
again from the configuration's probabilities in float64.

States M (both advance), X (the read advances: from above) and Y (the
haplotype advances: from the left); read x on rows, haplotype y on
columns.  With a = log(delta) (gap open), e = log(eps) (gap extend),
t_mm = log(1 - 2 delta), t_gm = log(1 - eps), g the gap emission and
em(x_i, y_j) the match or mismatch emission:

    M(i, j) = em + logaddexp(M(i-1, j-1) + t_mm,
                             logaddexp(X(i-1, j-1), Y(i-1, j-1)) + t_gm)
    X(i, j) = g + logaddexp(M(i-1, j) + a, X(i-1, j) + e)
    Y(i, j) = g + logaddexp(M(i, j-1) + a, Y(i, j-1) + e)

Row 0 starts free along the haplotype (Y = 0 at every column, M = X
dead); column 0 below row 0 is dead.  The likelihood is
``logsumexp_j logaddexp(M, X)(q_len, j)`` over 1 <= j <= r_len,
unnormalised over the start column.
"""
from __future__ import annotations

import math

import numpy as np
import torch

FIELDS = ("score",)
TB_FIELDS = ()
EXACT_DTYPE = torch.float64
# the configuration states float32; the nearest type below it is bfloat16
CONTROL_DTYPE = torch.bfloat16
DEAD = -1e30


def _model(cfg):
    p = cfg["program"]["params"]
    delta, eps, match_p = (float(p[k]) for k in ("delta", "eps", "match_p"))
    m = cfg["model"]
    mis = (1.0 - match_p) / float(m["mismatch_divisor"])
    return {"a": math.log(delta), "e": math.log(eps),
            "t_mm": math.log(1.0 - 2.0 * delta), "t_gm": math.log(1.0 - eps),
            "g": math.log(float(m["gap_emission"])),
            "em_match": math.log(match_p), "em_mis": math.log(mis)}


def _sweep(cfg, q, r, ql, rl, dtype):
    P = _model(cfg)
    B, Q = q.shape
    R = r.shape[1]
    dev = q.device
    c = {k: torch.tensor(v, dtype=dtype, device=dev) for k, v in P.items()}
    dead = torch.tensor(DEAD, dtype=dtype, device=dev)
    zero = torch.tensor(0.0, dtype=dtype, device=dev)
    slot = torch.arange(Q + 1, device=dev)
    q_slot = torch.cat([q[:, :1], q], 1)
    ql = ql.to(dev, torch.int64)[:, None]
    rl = rl.to(dev, torch.int64)[:, None]
    full = lambda v: torch.full((B, Q + 1), v, dtype=dtype, device=dev)
    lae = torch.logaddexp
    # d = 0: (0, 0) with Y = 0; d = 1: (0, 1) with Y = 0, (1, 0) dead
    m2, x2, y2 = full(DEAD), full(DEAD), full(DEAD)
    y2[:, 0] = 0.0
    m1, x1, y1 = full(DEAD), full(DEAD), full(DEAD)
    y1[:, 0] = 0.0
    acc = torch.full((B,), DEAD, dtype=dtype, device=dev)
    dead_col = full(DEAD)[:, :1]
    shift = lambda t: torch.cat([dead_col, t[:, :-1]], 1)
    for d in range(2, Q + R + 1):
        j = d - slot
        rj = r.index_select(1, (j - 1).clamp(0, R - 1))
        em = torch.where(q_slot == rj, c["em_match"], c["em_mis"])
        m = em + lae(shift(m2) + c["t_mm"],
                     lae(shift(x2), shift(y2)) + c["t_gm"])
        x = c["g"] + lae(shift(m1) + c["a"], shift(x1) + c["e"])
        y = c["g"] + lae(m1 + c["a"], y1 + c["e"])
        row0 = slot == 0
        col0 = (j == 0) & ~row0
        m = torch.where(row0 | col0, dead, m)
        x = torch.where(row0 | col0, dead, x)
        y = torch.where(row0, zero, torch.where(col0, dead, y))
        last = (slot == ql) & (j >= 1) & (j <= rl)       # (B, Q+1)
        f = torch.where(last, lae(m, x), dead)
        acc = lae(acc, torch.logsumexp(f, 1))
        m2, x2, y2, m1, x1, y1 = m1, x1, y1, m, x, y
    return acc


def reference(cfg, queries, refs, q_lens, r_lens, *, device="cpu",
              dtype=EXACT_DTYPE, walk=False) -> dict:
    """The log-likelihood of each pair, as a numpy float64 array."""
    if walk:
        raise ValueError("the pair-HMM forward has no traceback")
    q = torch.as_tensor(np.asarray(queries)).to(device)
    r = torch.as_tensor(np.asarray(refs)).to(device)
    acc = _sweep(cfg, q, r, torch.as_tensor(q_lens),
                 torch.as_tensor(r_lens), dtype)
    return {"score": acc.to(torch.float64).cpu().numpy()}


def control(cfg, queries, refs, q_lens, r_lens, *, device="cpu") -> dict:
    """The reference in the program's place at the control precision."""
    return reference(cfg, queries, refs, q_lens, r_lens, device=device,
                     dtype=CONTROL_DTYPE)


def compare(cfg, got: dict, want: dict, inputs) -> tuple:
    """(numbers, bad): ``llk_gap_max`` is the widest gap, in nats, between
    a pair's log-likelihood and the reference's; a pair is bad where its
    gap passes the configuration's limit."""
    gap = np.abs(np.asarray(got["score"], np.float64) - want["score"])
    gap = np.where(np.isfinite(gap), gap, np.inf)
    limit = float(cfg["limits"]["llk_gap_max"])
    return ({"llk_gap_max": float(gap.max()) if gap.size else 0.0},
            gap > limit)
