"""Anti-diagonal wavefront engine in eager torch (counterpart of
``repro.core.engine``).

JAX computes this engine in XLA, outside any Pallas kernel; the port runs it
the same way, as eager torch on the inputs' device, batched over pairs: each
step evaluates one anti-diagonal of every pair, a ``(B, lanes, L)`` tensor
with lane i holding cell (i, d - i), from the two diagonals before it.  It
keeps the JAX engine's semantics cell for cell:

  * the boundary row (lane 0) and column (lane i == d) come from
    ``spec.init_row`` / ``spec.init_col``, masked by effective length and
    band;
  * the loop is strip-mined: ``strip`` anti-diagonals run between two tests
    of the loop condition, and a pair stops once ``ceil(live_bound /
    strip)`` strips have run (``live_bound`` defaults to the pair's own
    ``q_len + r_len``) or, under ``xdrop``, once neither carried diagonal
    holds a live cell.  In the port each such test is a host
    synchronisation, so ``strip`` is also how often the host asks; a
    stopped pair's state no longer changes, as under JAX's vmapped loop;
  * X-drop prunes a cell whose primary-layer score falls more than
    ``xdrop`` behind the running best of all computed cells;
  * the end cell is the first optimum in diagonal order, then lane order;
    a corner region captures its single cell on diagonal q_len + r_len;
  * pointers go to the ``'diag'`` store, ``tb[d - 1, i]`` for cell (i, j)
    on diagonal d = i + j, packed ``tb_pack`` per byte along the lane axis
    (``('diag', pack)``).

The runtime's ``wavefront`` engine runs this module only when ``xdrop`` is
set: kernel K1 runs every other wavefront fill (``runtime.registry``).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import types as T
from .spec_utils import (band_mask, batch_lens, params_on_device,
                         region_mask, resolve_tb_pack)
from .traceback import pack_lanes

# Anti-diagonals per loop step by device type (the wavefront engine's
# ``strip`` option default; JAX keys the same dict on its backend).  On a
# GPU each test of the loop condition is a host synchronisation the strip
# amortises; the CPU keeps the seed schedule.
STRIP_DEFAULTS = {"cpu": 1, "default": 8}


def default_strip(device) -> int:
    """``STRIP_DEFAULTS`` resolved against a device's type."""
    return STRIP_DEFAULTS.get(torch.device(device).type,
                              STRIP_DEFAULTS["default"])


def run(spec: T.DPKernelSpec, params, queries, refs, q_lens=None,
        r_lens=None, *, strip: Optional[int] = None,
        tb_pack: Optional[int] = None, live_bound=None,
        xdrop: Optional[int] = None, with_tb: bool = True) -> T.DPResult:
    """Fill a batch: queries (B, Q) + char_shape, refs (B, R) + char_shape
    on one device; q_lens/r_lens (B,) effective lengths (None = full).

    ``live_bound`` is one diagonal count shared by the batch (a batched
    plan passes ``max(q_lens + r_lens)``); None bounds each pair by its own
    ``q_len + r_len``.  Returns per-pair score and end cell, and, when the
    spec has a traceback and ``with_tb`` is set, the ``(B, rows,
    ceil((Q + 1) / pack))`` pointer store."""
    B, Q = queries.shape[:2]
    R = refs.shape[1]
    L = spec.n_layers
    dt = spec.score_dtype
    sent = spec.sentinel()
    dev = queries.device
    params = params_on_device(params, dev)
    q_len = batch_lens(Q if q_lens is None else q_lens, B, dev)
    r_len = batch_lens(R if r_lens is None else r_lens, B, dev)
    tb_on = with_tb and spec.traceback is not None
    strip = default_strip(dev) if strip is None else int(strip)
    if strip < 1:
        raise ValueError(f"strip must be >= 1, got {strip}")
    pack = resolve_tb_pack(spec, tb_pack)
    if xdrop is not None and spec.is_sum:
        raise ValueError(
            "xdrop prunes by a running best score; sum-semiring kernels "
            "have no best to drop from")
    char = tuple(queries.shape[2:])
    prim = spec.primary_layer
    lanes = Q + 1
    i_idx = torch.arange(lanes, dtype=torch.int32, device=dev)
    ql, rl = q_len[:, None], r_len[:, None]

    # boundary scores: the init row (shared) and the init column, masked
    # per pair by effective length and band
    row0 = spec.init_row(params, torch.arange(
        R + 1, dtype=torch.int32, device=dev)).to(dt).reshape(R + 1, L)
    col0 = spec.init_col(params, i_idx).to(dt).reshape(lanes, L)
    col_keep = (i_idx <= ql) & band_mask(spec, i_idx, 0)
    col0 = torch.where(col_keep[..., None], col0, sent)      # (B, lanes, L)
    # lane i holds q[i - 1] (lane 0 is the boundary row; its char unused)
    q_lane = torch.cat([queries[:, :1], queries], dim=1).reshape(
        (B * lanes,) + char)
    i_flat = i_idx.repeat(B)
    sent_row = torch.full((B, 1, L), sent, dtype=dt, device=dev)

    n_steps = -(-(Q + R) // strip)
    if live_bound is None:
        bound = q_len + r_len
        host_bound = int(bound.max()) if B else 0
    else:
        host_bound = int(live_bound)
        bound = torch.full((B,), host_bound, dtype=torch.int32, device=dev)
    live_steps = torch.clamp((bound + strip - 1) // strip, max=n_steps)
    host_steps = min(-(-host_bound // strip), n_steps)

    # d = 0 holds only cell (0, 0), at lane 0; d = -1 holds nothing
    prev2 = torch.full((B, lanes, L), sent, dtype=dt, device=dev)
    prev = prev2.clone()
    if bool(band_mask(spec, 0, 0)):
        prev[:, 0] = row0[0]
    best = torch.full((B,), sent, dtype=dt, device=dev)
    bi = torch.zeros((B,), dtype=torch.int32, device=dev)
    bj = torch.zeros((B,), dtype=torch.int32, device=dev)
    xbest = torch.full((B,), sent, dtype=dt, device=dev)
    tb = (torch.zeros((B, n_steps * strip, lanes), dtype=torch.uint8,
                      device=dev) if tb_on else None)
    running = torch.ones((B,), dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)
    corner_lane = q_len.clamp(0, lanes - 1).long()
    corner_d = q_len + r_len
    corner_ok = (q_len >= 1) & (r_len >= 1)

    def live(buf):
        return spec.better(buf[..., prim], sent).any(dim=1)

    for s in range(host_steps):
        running = running & (s < live_steps)
        if xdrop is not None:
            # stop once neither carried diagonal holds a live cell: d + 1
            # reads prev for up/left and prev2 for diag
            running = running & (live(prev) | live(prev2))
            if not bool(running.any()):
                break
        keep = running[:, None, None]
        for k in range(strip):
            d = s * strip + 1 + k
            j = d - i_idx
            r_idx = (j - 1).clamp(0, R - 1).long()
            diag_v = torch.cat([sent_row, prev2[:, :-1]], dim=1)
            up_v = torch.cat([sent_row, prev[:, :-1]], dim=1)
            scores, ptr = spec.pe(
                params, q_lane, refs[:, r_idx].reshape((B * lanes,) + char),
                diag_v.reshape(B * lanes, L), up_v.reshape(B * lanes, L),
                prev.reshape(B * lanes, L), i_flat, d - i_flat)
            scores = scores.to(dt).reshape(B, lanes, L)
            interior = (i_idx >= 1) & (j >= 1) & (i_idx <= ql) & (j <= rl)
            valid = interior & band_mask(spec, i_idx, j)
            new = torch.where(valid[..., None], scores, sent)
            # boundary row (lane 0) and boundary column (lane i == d)
            if d <= R and bool(band_mask(spec, 0, d)):
                on_row0 = (d <= r_len)[:, None, None] & (i_idx == 0)[:, None]
                new = torch.where(on_row0, row0[d], new)
            if d < lanes:
                new[:, d] = col0[:, d]
            if xdrop is not None:
                p = new[..., prim]
                xb = spec.combine(xbest, spec.reduce_best(p, axis=1))
                thr = xb + xdrop if spec.is_min else xb - xdrop
                new = torch.where(spec.better(thr[:, None], p)[..., None],
                                  sent, new)
                xbest = torch.where(running, xb, xbest)
            if spec.region == T.REGION_CORNER and not spec.is_sum:
                # the region is the single cell (q_len, r_len) on diagonal
                # q_len + r_len: capture it directly
                cell = new[rows, corner_lane, prim]
                upd = (running & (d == corner_d) & corner_ok
                       & spec.better(cell, best))
                best = torch.where(upd, cell, best)
                bi = torch.where(upd, q_len, bi)
                bj = torch.where(upd, r_len, bj)
            else:
                rmask = region_mask(spec, i_idx, j, ql, rl)
                cand = torch.where(rmask, new[..., prim], sent)
                if spec.is_sum:
                    # ⊕-accumulate the region's mass across wavefronts; end
                    # cells carry no path meaning under a sum and stay 0
                    nb = spec.combine(best, spec.reduce_best(cand, axis=1))
                    best = torch.where(running, nb, best)
                else:
                    lane_best = spec.reduce_best(cand, axis=1)
                    lane_arg = spec.arg_best(cand, axis=1).to(torch.int32)
                    upd = running & spec.better(lane_best, best)
                    best = torch.where(upd, lane_best, best)
                    bi = torch.where(upd, lane_arg, bi)
                    bj = torch.where(upd, d - lane_arg, bj)
            if tb_on:
                tb[:, d - 1] = torch.where(
                    valid & running[:, None], ptr.reshape(B, lanes), 0).to(
                    torch.uint8)
            prev2, prev = (torch.where(keep, prev, prev2),
                           torch.where(keep, new, prev))
    layout = "diag" if pack == 1 else ("diag", pack)
    if tb_on:
        tb = pack_lanes(tb, pack)
    return T.DPResult(score=best, end_i=bi, end_j=bj, tb=tb,
                      tb_layout=layout)
