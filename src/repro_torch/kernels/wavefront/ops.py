"""Wrapper around K1 (port of ``repro/kernels/wavefront/ops.py``): pads the
query to the lane strip, builds the masked boundary row and column, launches
the fill, and reduces across strips to the ``DPResult`` the engines return.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import types as T
from repro_torch.core.spec_utils import band_mask, resolve_tb_pack
from . import kernel as K


def _lens(x, n, dev):
    t = torch.as_tensor(x, device=dev).to(torch.int32).reshape(-1)
    return t.expand(n).contiguous() if t.numel() == 1 else t.reshape(n)


def boundaries(spec: T.DPKernelSpec, params, q_bucket: int, r_bucket: int,
               q_lens, r_lens):
    """The init row (B, R + 1, L) and column (B, Q + 1, L), masked to the
    sentinel past each pair's effective length and outside the band — the
    boundary ``core/reference.py`` fills from."""
    L = spec.n_layers
    dev = q_lens.device
    sent = spec.sentinel()
    j = torch.arange(r_bucket + 1, dtype=torch.int32, device=dev)
    i = torch.arange(q_bucket + 1, dtype=torch.int32, device=dev)
    row = spec.init_row(params, j).to(torch.int32).reshape(-1, L)
    col = spec.init_col(params, i).to(torch.int32).reshape(-1, L)
    row_keep = (j <= r_lens[:, None]) & band_mask(spec, 0, j)
    col_keep = (i <= q_lens[:, None]) & band_mask(spec, i, 0)
    return (torch.where(row_keep[..., None], row, sent).contiguous(),
            torch.where(col_keep[..., None], col, sent).contiguous())


def run(spec: T.DPKernelSpec, params, queries, refs, q_lens=None,
        r_lens=None, *, tb_pack: Optional[int] = None,
        with_tb: bool = True) -> T.DPResult:
    """Fill a batch: queries (B, Q), refs (B, R) uint8 codes on one device;
    q_lens/r_lens (B,) effective lengths (None = full).

    The end cell is the first optimum in (strip, lane) order — row-major
    first, the same cell as ``core/reference.py`` picks — with each lane's
    first column."""
    B, Q = queries.shape
    R = refs.shape[1]
    dev = queries.device
    pack = resolve_tb_pack(spec, tb_pack)
    q_lens = _lens(Q if q_lens is None else q_lens, B, dev)
    r_lens = _lens(R if r_lens is None else r_lens, B, dev)
    pad = (-Q) % K.N_PE
    if pad:
        queries = torch.nn.functional.pad(queries, (0, pad))
    init_row, init_col = boundaries(spec, params, Q + pad, R, q_lens, r_lens)
    lens = torch.stack([q_lens, r_lens], dim=1).contiguous()
    tb, best, best_j = K.wavefront_fill(
        spec, params, queries.contiguous(), refs.contiguous(), init_row,
        init_col, lens, tb_pack=pack, with_tb=with_tb)
    flat = best.reshape(B, -1)
    k = torch.argmax(flat, dim=1, keepdim=True)     # first max
    score = flat.gather(1, k)[:, 0]
    end_i = (k[:, 0] + 1).to(torch.int32)           # chunk * n_pe + lane + 1
    end_j = best_j.reshape(B, -1).gather(1, k)[:, 0]
    layout = ("chunk", K.N_PE) if pack == 1 else ("chunk", K.N_PE, pack)
    return T.DPResult(score=score, end_i=end_i, end_j=end_j, tb=tb,
                      tb_layout=layout)
