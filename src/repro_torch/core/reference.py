"""Reference engine of the port: the full-matrix oracle (counterpart of
``repro.core.reference``).

It computes the whole (Q+1, R+1, L) score matrix and the row-major pointer
store ``tb[i, j]`` (layout ``'row'``) for a batch of pairs.  Each cell
computes the spec's own PE on the same neighbours as
``repro.core.reference``'s row-major scan, so the values are those of the
row-major recurrence; the order of evaluation is an anti-diagonal sweep
over the batch (a diagonal depends only on the two before it).  The sweep
(``sweep``, which K1's plain version also runs) keeps the matrix
diagonal-major, ``diag_major[b, i + j, i] = cell (i, j)``,
so that a diagonal's three neighbours are slices of the two diagonals
before it, and turns it row-major once at the end.  It runs eagerly on
the device of its inputs, with no kernel of its own.
"""
from __future__ import annotations

import torch

from . import types as T
from .spec_utils import (band_mask, batch_lens, params_on_device,
                         region_mask)


def boundaries(spec: T.DPKernelSpec, params, q_bucket: int, r_bucket: int,
               q_lens, r_lens):
    """The init row (B, R + 1, L) and column (B, Q + 1, L) of the spec's
    score type, masked to the sentinel past each pair's effective length
    and outside the band: the boundary every fill starts from."""
    L = spec.n_layers
    dev = q_lens.device
    sent = spec.sentinel()
    j = torch.arange(r_bucket + 1, dtype=torch.int32, device=dev)
    i = torch.arange(q_bucket + 1, dtype=torch.int32, device=dev)
    dt = spec.score_dtype
    row = spec.init_row(params, j).to(dt).reshape(-1, L)
    col = spec.init_col(params, i).to(dt).reshape(-1, L)
    row_keep = (j <= r_lens[:, None]) & band_mask(spec, 0, j)
    col_keep = (i <= q_lens[:, None]) & band_mask(spec, i, 0)
    return (torch.where(row_keep[..., None], row, sent).contiguous(),
            torch.where(col_keep[..., None], col, sent).contiguous())


def sweep(spec: T.DPKernelSpec, params, queries, refs, init_row, init_col,
          q_len, r_len):
    """The DP over a batch from its masked boundary: queries (B, Q) +
    char_shape, refs (B, R) + char_shape, init_row (B, R + 1, L) and
    init_col (B, Q + 1, L) as ``boundaries`` gives them, q_len/r_len (B,)
    int32.  Returns scores (B, Q+1, R+1, L) and pointers (B, Q+1, R+1)
    uint8, row-major; cells past the effective lengths or outside the band
    keep the boundary or the sentinel, and pointer 0."""
    B, Q = queries.shape[:2]
    R = refs.shape[1]
    L = spec.n_layers
    dev = queries.device
    dt = spec.score_dtype
    sent = spec.sentinel()
    char = tuple(queries.shape[2:])
    params = params_on_device(params, dev)
    n_diag = Q + R + 1

    j_idx = torch.arange(R + 1, dtype=torch.int32, device=dev)
    i_idx = torch.arange(Q + 1, dtype=torch.int32, device=dev)
    # dm[b, d, i] = cell (i, d - i); row 0 at dm[:, j, 0], column 0 at
    # dm[:, i, i]
    dm = torch.full((B, n_diag, Q + 1, L), sent, dtype=dt, device=dev)
    dm[:, : R + 1, 0] = init_row
    dm[:, i_idx[1:].long(), i_idx[1:].long()] = init_col[:, 1:]
    ptrs = torch.zeros((B, n_diag, Q + 1), dtype=torch.uint8, device=dev)

    rows = i_idx[1:]                                   # i = 1..Q
    d_idx = torch.arange(n_diag, dtype=torch.int32, device=dev)
    j_all = d_idx[:, None] - rows                      # (n_diag, Q)
    valid = ((j_all >= 1) & (j_all <= r_len[:, None, None])
             & (rows <= q_len[:, None, None])
             & band_mask(spec, rows, j_all))           # (B, n_diag, Q)
    # the reference reversed and padded by Q on both sides: the characters
    # r[d - 1 - i] of rows i = 1..Q on diagonal d are one slice of it
    pad = torch.zeros((B, Q) + char, dtype=refs.dtype, device=dev)
    rev = torch.cat([pad, refs, pad], dim=1).flip(1)
    K = R + 2 * Q
    q_chars = queries.reshape((B * Q,) + char)
    i_flat = rows.repeat(B)
    last = int((q_len + r_len).max()) if B else 0
    for d in range(2, min(n_diag - 1, last) + 1):
        up = dm[:, d - 1, :Q].reshape(B * Q, L)
        left = dm[:, d - 1, 1:].reshape(B * Q, L)
        diag = dm[:, d - 2, :Q].reshape(B * Q, L)
        r_chars = rev[:, K - d - Q + 1: K - d + 1].reshape((B * Q,) + char)
        scores, ptr = spec.pe(params, q_chars, r_chars, diag, up, left,
                              i_flat, d - i_flat)
        ok = valid[:, d]
        dm[:, d, 1:] = torch.where(ok[..., None],
                                   scores.to(dt).reshape(B, Q, L),
                                   dm[:, d, 1:])
        ptrs[:, d, 1:] = torch.where(ok, ptr.reshape(B, Q), 0).to(
            torch.uint8)
    # row-major: cell (i, j) = dm[:, i + j, i]
    ii = i_idx.long()[:, None]
    jj = j_idx.long()[None, :]
    return dm[:, ii + jj, ii], ptrs[:, ii + jj, ii]


def fill_matrix(spec: T.DPKernelSpec, params, queries, refs, q_lens=None,
                r_lens=None):
    """Scores (B, Q+1, R+1, L) of the spec's score type and pointers
    (B, Q+1, R+1) uint8 of a batch: queries (B, Q) + char_shape, refs
    (B, R) + char_shape; q_lens/r_lens (B,) effective lengths (None =
    full).  Row 0 is the masked init row, column 0 the masked init column;
    cells past the effective lengths or outside the band hold the sentinel
    and pointer 0."""
    B, Q = queries.shape[:2]
    R = refs.shape[1]
    dev = queries.device
    q_len = batch_lens(Q if q_lens is None else q_lens, B, dev)
    r_len = batch_lens(R if r_lens is None else r_lens, B, dev)
    init_row, init_col = boundaries(spec, params, Q, R, q_len, r_len)
    return sweep(spec, params, queries, refs, init_row, init_col, q_len,
                 r_len)


def run(spec: T.DPKernelSpec, params, queries, refs, q_lens=None,
        r_lens=None, *, with_tb: bool = True) -> T.DPResult:
    """Fill a batch and reduce its objective region: the first optimum in
    row-major order (its end cell; (0, 0) when the region holds only the
    sentinel), or, under a sum semiring, the ⊕-fold of the region with end
    cells (0, 0).  The result carries the matrix and the ``'row'`` store
    whatever ``with_tb`` says (the engine keeps both anyway)."""
    B, Q = queries.shape[:2]
    R = refs.shape[1]
    dev = queries.device
    q_len = batch_lens(Q if q_lens is None else q_lens, B, dev)
    r_len = batch_lens(R if r_lens is None else r_lens, B, dev)
    mat, tb = fill_matrix(spec, params, queries, refs, q_len, r_len)
    ii = torch.arange(Q + 1, dtype=torch.int32, device=dev)[:, None]
    jj = torch.arange(R + 1, dtype=torch.int32, device=dev)[None, :]
    mask = region_mask(spec, ii, jj, q_len[:, None, None],
                       r_len[:, None, None])
    cand = torch.where(mask, mat[..., spec.primary_layer],
                       spec.sentinel()).reshape(B, -1)
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    if spec.is_sum:
        return T.DPResult(score=spec.reduce_best(cand, axis=1), end_i=zero,
                          end_j=zero, tb=tb, tb_layout="row", matrix=mat)
    flat = spec.arg_best(cand, axis=1)
    return T.DPResult(score=cand.gather(1, flat[:, None])[:, 0],
                      end_i=(flat // (R + 1)).to(torch.int32),
                      end_j=(flat % (R + 1)).to(torch.int32),
                      tb=tb, tb_layout="row", matrix=mat)
