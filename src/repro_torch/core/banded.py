"""Band-packed diagonal sweep, O(n·W) work for banded kernels (#11-13)
(counterpart of ``repro.core.banded``).

The generic engines compute whole anti-diagonals and mask the cells outside
the band.  Here lanes hold only the band: on anti-diagonal d the cells
satisfy |2i - d| <= W, at most W + 1 of them.  Lane k holds row i =
base(d) + k with base(d) = max(floor((d - W + 1) / 2), 0); from one
diagonal to the next the base moves by 0 or 1, so the up, diagonal and left
neighbours sit at lane offsets that depend on the parity (the cycled
systolic addressing of paper §2.2.4).  ``W + 2`` lanes hold the band and the
slack of that shift.

The JAX package computes this engine in XLA, outside any Pallas kernel, so
the port runs it as eager torch on the inputs' device, one diagonal of the
whole batch at a time.  Each pair keeps the JAX engine's per-pair loop
exactly: it stops after its last live diagonal (``q_len + r_len``) and,
under ``xdrop``, once its two carried diagonals hold no live cell; a
stopped pair's state no longer changes.  A neighbour that falls outside
the lanes reads the sentinel, as the reference engine's out-of-band cells
do; JAX's engine clamps such a read to the edge lane, which changes no
score of #11-13 but adds mass to a banded pair-HMM (ROADMAP queue 3).
Score-only: banded traceback kernels run a generic engine when a path is
needed.
"""
from __future__ import annotations

import torch

from . import types as T
from .spec_utils import batch_lens, params_on_device

# under xdrop, ask the device whether any pair is still live this often
_XDROP_POLL = 16


def run(spec: T.DPKernelSpec, params, queries, refs, q_lens=None,
        r_lens=None, *, with_tb: bool = False, xdrop=None) -> T.DPResult:
    """Score a batch: queries (B, Q) + char_shape, refs (B, R) + char_shape
    on one device; q_lens/r_lens (B,) effective lengths (None = full).

    The end cell is the first optimum in diagonal order, then lane order
    (``repro.core.banded``'s rule, not the reference's row-major one);
    under a sum semiring the score is the ⊕-fold of the objective region
    and the end cell (0, 0).  ``with_tb`` is part of the engine signature;
    no pointer store is built."""
    if spec.band is None:
        raise ValueError("banded engine requires spec.band")
    if xdrop is not None and spec.is_sum:
        raise ValueError(
            "xdrop prunes by a running best score; sum-semiring kernels "
            "have no best to drop from")
    W = int(spec.band)
    B, Q = queries.shape[:2]
    R = refs.shape[1]
    L = spec.n_layers
    dt = spec.score_dtype
    sent = spec.sentinel()
    dev = queries.device
    params = params_on_device(params, dev)
    q_len = batch_lens(Q if q_lens is None else q_lens, B, dev)
    r_len = batch_lens(R if r_lens is None else r_lens, B, dev)
    char = tuple(queries.shape[2:])

    lanes = W + 2
    # a pair's diagonals beyond q_len + r_len hold no valid cell
    live_d = torch.clamp(q_len + r_len, max=Q + R)
    last = int(live_d.max()) if B else 0
    # what every pair's diagonal d shares, for all d at once (row d - 1 of
    # each table): rows i and columns j per lane, each neighbour's lane in
    # the diagonal it lives on, and where a neighbour comes from the init
    # row or column or reads the sentinel (outside the lanes)
    d = torch.arange(1, last + 1, device=dev)[:, None]
    base = ((d - W + 1).div(2, rounding_mode="floor")).clamp(min=0)
    b1 = ((d - W).div(2, rounding_mode="floor")).clamp(min=0)
    b2 = ((d - W - 1).div(2, rounding_mode="floor")).clamp(min=0)
    i = (base + torch.arange(lanes, device=dev)).to(torch.int32)
    j = (d - i).to(torch.int32)
    row0 = spec.init_row(params, torch.arange(
        R + 1, dtype=torch.int32, device=dev)).to(dt).reshape(R + 1, L)
    col0 = spec.init_col(params, torch.arange(
        Q + 1, dtype=torch.int32, device=dev)).to(dt).reshape(Q + 1, L)
    top, side = (i == 1)[..., None], (j == 1)[..., None]
    up_row0 = row0[j.clamp(0, R).long()]
    left_col0 = col0[i.clamp(0, Q).long()]
    diag_init = torch.where(side, col0[(i - 1).clamp(0, Q).long()],
                            row0[(j - 1).clamp(0, R).long()])

    def neighbour(lane, init_mask, init):
        """(lane index into the carried diagonal, override mask, override
        values): the override is the init row/column where it applies and
        the sentinel where the lane falls outside the band's lanes."""
        out = ((lane < 0) | (lane > lanes - 1))[..., None]
        over = torch.where(init_mask, init, torch.full_like(init, sent))
        return lane.clamp(0, lanes - 1).long(), init_mask | out, over

    diag_nb = neighbour(i - 1 - b2, top | side, diag_init)
    up_nb = neighbour(i - 1 - b1, top, up_row0)
    left_nb = neighbour(i - b1, side, left_col0)
    q_idx = (i - 1).clamp(0, Q - 1).long()
    r_idx = (j - 1).clamp(0, R - 1).long()
    in_band = (i >= 1) & (j >= 1) & ((i - j).abs() <= W)
    prim = spec.primary_layer

    def take(buf, nb, k):
        lane, mask, over = nb
        return torch.where(mask[k], over[k], buf[:, lane[k]])

    def live(buf):
        return spec.better(buf[..., prim], sent).any(dim=1)

    def region(ik, jk):
        """The objective region's selector; ``valid`` holds the interior
        and the band (``spec_utils.region_mask``)."""
        if spec.region == T.REGION_CORNER:
            return (ik == ql) & (jk == rl)
        if spec.region == T.REGION_LAST_ROW:
            return ik == ql
        if spec.region == T.REGION_LAST_ROW_COL:
            return (ik == ql) | (jk == rl)
        return None                                   # REGION_ALL

    # d = 0 holds only cell (0, 0), at lane 0
    prev2 = torch.full((B, lanes, L), sent, dtype=dt, device=dev)
    prev = prev2.clone()
    prev[:, 0] = row0[0]
    best = torch.full((B,), sent, dtype=dt, device=dev)
    bi = torch.zeros((B,), dtype=torch.int32, device=dev)
    bj = torch.zeros((B,), dtype=torch.int32, device=dev)
    xbest = torch.full((B,), sent, dtype=dt, device=dev)
    ql, rl = q_len[:, None], r_len[:, None]
    for k in range(last):
        act = k < live_d
        if xdrop is not None:
            act = act & (live(prev) | live(prev2))
            if (k + 1) % _XDROP_POLL == 0 and not bool(act.any()):
                break
        ik, jk = i[k], j[k]
        scores, _ = spec.pe(
            params, queries[:, q_idx[k]].reshape((B * lanes,) + char),
            refs[:, r_idx[k]].reshape((B * lanes,) + char),
            take(prev2, diag_nb, k).reshape(B * lanes, L),
            take(prev, up_nb, k).reshape(B * lanes, L),
            take(prev, left_nb, k).reshape(B * lanes, L),
            ik.repeat(B), jk.repeat(B))
        valid = in_band[k] & (ik <= ql) & (jk <= rl)
        new = torch.where(valid[..., None], scores.to(dt).reshape(B, lanes, L),
                          sent)
        if xdrop is not None:
            # X-drop: prune cells more than xdrop behind the running best
            # over the band's cells; the band shrinks per pair and the pair
            # stops once it is empty
            p = new[..., prim]
            xb = spec.combine(xbest, spec.reduce_best(p, axis=1))
            thr = xb + xdrop if spec.is_min else xb - xdrop
            new = torch.where(spec.better(thr[:, None], p)[..., None], sent,
                              new)
            xbest = torch.where(act, xb, xbest)
        sel = region(ik, jk)
        rmask = valid if sel is None else valid & sel
        cand = torch.where(rmask, new[..., prim], sent)
        if spec.is_sum:
            nb = spec.combine(best, spec.reduce_best(cand, axis=1))
            best = torch.where(act, nb, best)
        else:
            lane_best = spec.reduce_best(cand, axis=1)
            lane_i = ik[spec.arg_best(cand, axis=1)]
            upd = act & spec.better(lane_best, best)
            best = torch.where(upd, lane_best, best)
            bi = torch.where(upd, lane_i, bi)
            bj = torch.where(upd, k + 1 - lane_i, bj)
        keep = act[:, None, None]
        prev2, prev = (torch.where(keep, prev, prev2),
                       torch.where(keep, new, prev))
    return T.DPResult(score=best, end_i=bi, end_j=bj, tb=None,
                      tb_layout="diag")
