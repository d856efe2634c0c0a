"""Wrapper around K2 (port of ``repro/kernels/myers/ops.py``): the ``myers``
engine of the registry.  It launches the sweep and applies the result
contract of ``repro.core.myers.run``: an empty pair reports the sentinel, a
distance above ``params['max_dist']`` (when >= 0) saturates to the sentinel,
a dead result ends at (0, 0), and a live one ends at ``(q_len, r_len)``
(edit_distance) or at the first column of the last-row minimum
(edit_search).
"""
from __future__ import annotations

import torch

from repro_torch.core import myers as M
from repro_torch.core import types as T
from repro_torch.core.spec_utils import batch_lens
from . import kernel as K


def run(spec: T.DPKernelSpec, params, queries, refs, q_lens=None,
        r_lens=None, *, with_tb: bool = False) -> T.DPResult:
    """Score a batch: queries (B, Q), refs (B, R) uint8 codes on one device;
    q_lens/r_lens (B,) effective lengths (None = full).  The engine is
    score-only: ``with_tb`` is part of the engine signature and no pointer
    store is built."""
    M.check_spec(spec)
    B, Q = queries.shape
    R = refs.shape[1]
    dev = queries.device
    q_lens = batch_lens(Q if q_lens is None else q_lens, B, dev)
    r_lens = batch_lens(R if r_lens is None else r_lens, B, dev)
    k = int(params.get("max_dist", -1))
    glob = spec.region == T.REGION_CORNER
    lens = torch.stack([q_lens, r_lens], dim=1).contiguous()
    score, best, best_j = K.myers_fill(queries.contiguous(), refs.contiguous(),
                                       lens, glob=glob, k=k)
    sent = spec.sentinel()
    dist = score if glob else best
    if k >= 0:
        dist = torch.where(dist > k, sent, dist)
    ok = (q_lens >= 1) & (r_lens >= 1)
    dist = torch.where(ok, dist, sent).to(torch.int32)
    live = ok & (dist < sent)
    zero = torch.zeros_like(q_lens)
    end_i = torch.where(live, q_lens, zero)
    end_j = torch.where(live, r_lens if glob else best_j, zero)
    return T.DPResult(score=dist, end_i=end_i, end_j=end_j, tb=None,
                      tb_layout="diag")
