"""Seeding (mapping stage 2; counterpart of ``repro.mapping.seed``): query
minimizers -> reference anchors, batched over reads.

An anchor is a (q_pos, r_pos) pair asserting that the k-mer at read position
q_pos also occurs at reference position r_pos.  Each read's minimizers are
looked up in the sorted bucket table, and up to ``max_hits`` occurrences per
seed come out as fixed-shape masked arrays.  Seeds with more than
``max_occ`` occurrences are dropped (repeat masking).
"""
from __future__ import annotations

import torch

from . import index as index_mod

# Anchors sort by (r_pos, q_pos), invalid entries last.  Both keys lie in
# [0, 2**31 - 1], so one int64 key ``(r << 32) | q`` orders them exactly at
# any reference length.
_INVALID = 2**31 - 1


def seed_anchors(index: index_mod.MinimizerIndex, reads, read_lens,
                 max_hits: int = 8, max_occ: int = 64):
    """Anchors of a batch of padded reads (B, L) against the index.

    Returns ``(q_pos, r_pos, valid)``, each (B, n_windows * max_hits), q_pos
    and r_pos int32; ``valid`` masks real anchors (minimizer inside the
    effective read, occurrence exists, seed not repeat-masked).
    """
    pos, h = index_mod.minimizers(reads, index.k, index.w)   # (B, n_win)
    B, n_win = pos.shape
    dev = pos.device
    read_lens = torch.as_tensor(read_lens, device=dev).long().reshape(B)
    # live minimizers only: k-mer fully inside the effective read
    ok = pos <= (read_lens - index.k)[:, None]
    # adjacent windows repeat minimizers; keep the first occurrence
    prev = torch.cat([torch.full((B, 1), -1, dtype=pos.dtype, device=dev),
                      pos[:, :-1]], dim=1)
    ok &= pos != prev
    lo, hi = index_mod.lookup_range(index, h)
    cnt = hi - lo
    ok &= (cnt > 0) & (cnt <= max_occ)
    t = torch.arange(max_hits, device=dev)
    hit_ok = ok[..., None] & (t < cnt[..., None])             # (B, n_win, H)
    hit_idx = (lo[..., None] + t).clamp(0, index.positions.shape[0] - 1)
    r_pos = torch.where(hit_ok, index.positions[hit_idx], 0)
    q_pos = pos[..., None].expand(B, n_win, max_hits)
    return (q_pos.reshape(B, -1), r_pos.reshape(B, -1).to(torch.int32),
            hit_ok.reshape(B, -1))


def top_anchors(q_pos, r_pos, valid, n_anchors: int):
    """Sort anchors along the last axis by (r_pos, q_pos), invalid last, and
    keep the first ``n_anchors``: the fixed-size input of the chaining DP.
    The sort is stable, as ``jnp.lexsort`` is."""
    r_key = torch.where(valid, r_pos, _INVALID).long()
    q_key = torch.where(valid, q_pos, _INVALID).long()
    order = torch.argsort((r_key << 32) | q_key, dim=-1,
                          stable=True)[..., :n_anchors]
    return (q_pos.gather(-1, order), r_pos.gather(-1, order),
            valid.gather(-1, order))
