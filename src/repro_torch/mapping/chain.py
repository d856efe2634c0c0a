"""Anchor chaining (mapping stage 3; counterpart of ``repro.mapping.chain``):
a sparse 1-D DP over each read's anchor list, batched over reads.

Anchors sorted by (r_pos, q_pos) get

    f[i] = k + max(0, max_{j < i} f[j] + gain(j, i))

with the minimap2-style gain ``min(dq, dr, k) - gap_scale * |dr - dq|`` for
co-linear predecessors (dq, dr > 0, dr bounded, bounded diagonal skew).  The
DP is a loop of A steps over (B, A) tensors; the parent-pointer walk that
reports the chain's span and diagonal range is a masked loop of at most A
steps that asks the device whether every row is done only every
``DONE_CHECK_EVERY`` steps.  Scores stay float32 as in the JAX package: they
are half-integers, so every sum is exact and ties resolve the same way;
``argmax`` returns the first maximum in both packages.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG = -1e9
DONE_CHECK_EVERY = 64


class ChainResult(NamedTuple):
    """Best chain of each read (tensors of shape (B,), or numpy scalars for
    one read on the host).

    Coordinates are k-mer start positions of the first/last chained anchor;
    ``d_min``/``d_max`` bound the chain's diagonals r_pos - q_pos.
    ``score2`` is the best chain score outside the primary chain's reference
    neighbourhood (feeds mapq).
    """
    score: object
    score2: object
    n_anchors: object
    q_start: object
    q_end: object
    r_start: object
    r_end: object
    d_min: object
    d_max: object


def chain_anchors(q_pos, r_pos, valid, k: int, read_len, *,
                  max_dist: int = 512, max_skew: int = 64,
                  gap_scale: float = 0.5) -> ChainResult:
    """Chain (B, A) anchors already sorted by (r_pos, q_pos) along the last
    axis (see ``seed.top_anchors``); ``read_len`` is (B,)."""
    B, A = q_pos.shape
    dev = q_pos.device
    q = q_pos.to(torch.int32)
    r = r_pos.to(torch.int32)
    read_len = torch.as_tensor(read_len, device=dev).to(torch.int32)
    kf = float(k)
    f = torch.full((B, A), NEG, dtype=torch.float32, device=dev)
    p = torch.full((B, A), -1, dtype=torch.int64, device=dev)
    for i in range(A):
        if i == 0:          # no predecessor: as JAX, bv = NEG and no parent
            bv = torch.full((B,), NEG, dtype=torch.float32, device=dev)
            bj = torch.zeros((B,), dtype=torch.int64, device=dev)
        else:
            # predecessors j < i only; later columns would all read NEG
            dq = q[:, i:i + 1] - q[:, :i]
            dr = r[:, i:i + 1] - r[:, :i]
            skew = (dr - dq).abs()
            ok = (valid[:, :i] & valid[:, i:i + 1] & (dq > 0) & (dr > 0)
                  & (dr <= max_dist) & (skew <= max_skew))
            gain = (torch.minimum(dq, dr).clamp(max=k).float()
                    - gap_scale * skew.float())
            cand = torch.where(ok, f[:, :i] + gain, NEG)
            bj = torch.argmax(cand, dim=1)
            bv = cand.gather(1, bj[:, None])[:, 0]
        f[:, i] = torch.where(valid[:, i], kf + bv.clamp(min=0.0), NEG)
        p[:, i] = torch.where(bv > 0, bj, -1)

    rows = torch.arange(B, device=dev)
    e = torch.argmax(f, dim=1)
    d = r - q
    q_end, r_end = q[rows, e], r[rows, e]
    cur, n = e, torch.ones((B,), dtype=torch.int32, device=dev)
    qs, rs, dmin, dmax = q_end, r_end, d[rows, e], d[rows, e]
    for step in range(A):
        parent = p[rows, cur]
        go = (parent >= 0) & (n < A)
        if step % DONE_CHECK_EVERY == 0 and not bool(go.any()):
            break
        nxt = torch.where(go, parent, cur)
        n = n + go.to(torch.int32)
        qs = torch.where(go, torch.minimum(qs, q[rows, nxt]), qs)
        rs = torch.where(go, torch.minimum(rs, r[rows, nxt]), rs)
        dmin = torch.where(go, torch.minimum(dmin, d[rows, nxt]), dmin)
        dmax = torch.where(go, torch.maximum(dmax, d[rows, nxt]), dmax)
        cur = nxt

    # runner-up: best chain ending outside the primary's ref neighbourhood
    away = valid & ((r < (rs - read_len)[:, None])
                    | (r > (r_end + read_len)[:, None]))
    score2 = torch.where(away, f, NEG).amax(dim=1).clamp(min=0.0)
    return ChainResult(score=f[rows, e], score2=score2, n_anchors=n,
                       q_start=qs, q_end=q_end, r_start=rs, r_end=r_end,
                       d_min=dmin, d_max=dmax)
