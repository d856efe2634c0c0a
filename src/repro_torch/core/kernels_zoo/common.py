"""PE functions, traceback FSMs and boundary inits of the kernel zoo, as
torch ops over a lane vector (counterpart of
``repro.core.kernels_zoo.common``).

A PE here takes ``(N,)`` query/reference codes and ``(N, n_layers)``
neighbour scores and returns ``(N, n_layers)`` scores of the spec's score
type and ``(N,)`` int32 pointers.  These are the plain versions of the CUDA
functors in ``repro_torch/kernels/wavefront/csrc/``: both must follow the
same order of comparisons, because ties decide the stored pointer.
"""
from __future__ import annotations

import torch

from .. import types as T

# Linear-gap pointer encoding (2 bits).
P_END, P_DIAG, P_UP, P_LEFT = 0, 1, 2, 3
LINEAR_PTR_BITS = 2

# Affine pointer byte: bits 0-1 = H source, bit 2 = I-extend, bit 3 = D-extend.
A_END, A_DIAG, A_UP, A_LEFT = 0, 1, 2, 3
AFFINE_PTR_BITS = 4
# Two-piece pointer byte: bits 0-2 = H source, bits 3-6 = I1/D1/I2/D2 extend.
TP_END, TP_DIAG, TP_UP1, TP_LEFT1, TP_UP2, TP_LEFT2 = 0, 1, 2, 3, 4, 5
TWO_PIECE_PTR_BITS = 7

ST_MM, ST_INS, ST_DEL, ST_INS2, ST_DEL2 = 0, 1, 2, 3, 4

DEAD = -(1 << 30)


def _i32(x):
    return x.to(torch.int32)


# ---------------------------------------------------------------------------
# Linear gap (N_LAYERS = 1)
# ---------------------------------------------------------------------------
def linear_pe(sub_fn, local: bool = False):
    """H = best(diag + sub, up + gap, left + gap) [, 0]; first of a tie wins."""
    def pe(params, q, r, diag, up, left, i, j):
        gap = params["gap"]
        m = diag[:, 0] + sub_fn(params, q, r)
        d = up[:, 0] + gap
        ins = left[:, 0] + gap
        best = m
        ptr = torch.full(m.shape, P_DIAG, dtype=torch.int32,
                         device=m.device)
        ptr = torch.where(d > best, P_UP, ptr)
        best = torch.maximum(best, d)
        ptr = torch.where(ins > best, P_LEFT, ptr)
        best = torch.maximum(best, ins)
        if local:
            ptr = torch.where(best <= 0, P_END, ptr)
            best = best.clamp(min=0)
        return best[:, None], ptr
    return pe


def linear_fsm(state, ptr):
    move = torch.where(ptr == P_END, T.MOVE_END,
                       torch.where(ptr == P_DIAG, T.MOVE_DIAG,
                                   torch.where(ptr == P_UP, T.MOVE_UP,
                                               T.MOVE_LEFT)))
    return _i32(move), state


def linear_tb(stop: str) -> T.TracebackSpec:
    return T.TracebackSpec(n_states=1, fsm=linear_fsm, stop=stop)


# ---------------------------------------------------------------------------
# Affine gap, Gotoh (N_LAYERS = 3: H, I, D)
# ---------------------------------------------------------------------------
def affine_pe(sub_fn, local: bool = False):
    def pe(params, q, r, diag, up, left, i, j):
        go, ge = params["gap_open"], params["gap_extend"]
        ins_open = left[:, 0] + go
        ins_ext = left[:, 1] + ge
        ins = torch.maximum(ins_open, ins_ext)
        i_ext_bit = _i32(ins_ext > ins_open)
        del_open = up[:, 0] + go
        del_ext = up[:, 2] + ge
        dele = torch.maximum(del_open, del_ext)
        d_ext_bit = _i32(del_ext > del_open)
        m = diag[:, 0] + sub_fn(params, q, r)
        h = m
        src = torch.full_like(m, A_DIAG)
        src = torch.where(dele > h, A_UP, src)
        h = torch.maximum(h, dele)
        src = torch.where(ins > h, A_LEFT, src)
        h = torch.maximum(h, ins)
        if local:
            src = torch.where(h <= 0, A_END, src)
            h = h.clamp(min=0)
        ptr = src | (i_ext_bit << 2) | (d_ext_bit << 3)
        return torch.stack([h, ins, dele], dim=-1), ptr
    return pe


def affine_fsm(state, ptr):
    src = ptr & 3
    i_ext = (ptr >> 2) & 1
    d_ext = (ptr >> 3) & 1
    in_mm = state == ST_MM
    going_up = torch.where(in_mm, src == A_UP, state == ST_DEL)
    going_left = torch.where(in_mm, src == A_LEFT, state == ST_INS)
    ended = in_mm & (src == A_END)
    move = torch.where(ended, T.MOVE_END,
                       torch.where(going_up, T.MOVE_UP,
                                   torch.where(going_left, T.MOVE_LEFT,
                                               T.MOVE_DIAG)))
    nstate = torch.where(going_up & (d_ext == 1), ST_DEL,
                         torch.where(going_left & (i_ext == 1), ST_INS,
                                     ST_MM))
    return _i32(move), _i32(nstate)


def affine_tb(stop: str) -> T.TracebackSpec:
    return T.TracebackSpec(n_states=3, fsm=affine_fsm, stop=stop)


def _gap_cost(k, go, ge):
    return torch.where(k == 0, 0, go + (k - 1) * ge)


def affine_init_row(params, j):
    """H/I follow the gap cost open+(k-1)*ext; D unreachable in row 0."""
    cost = _gap_cost(j, params["gap_open"], params["gap_extend"])
    dead = torch.full_like(cost, DEAD)
    return torch.stack([cost, cost, dead], dim=-1)


def affine_init_col(params, i):
    cost = _gap_cost(i, params["gap_open"], params["gap_extend"])
    dead = torch.full_like(cost, DEAD)
    return torch.stack([cost, dead, cost], dim=-1)


def local_affine_init(params, k):
    """Local affine boundary: zero H, dead gap layers."""
    z = torch.zeros_like(k)
    dead = torch.full_like(k, DEAD)
    return torch.stack([z, dead, dead], dim=-1)


# ---------------------------------------------------------------------------
# Two-piece affine, minimap2-style (N_LAYERS = 5: H, I1, D1, I2, D2)
# ---------------------------------------------------------------------------
def two_piece_pe(sub_fn):
    def pe(params, q, r, diag, up, left, i, j):
        go1, ge1 = params["gap_open"], params["gap_extend"]
        go2, ge2 = params["gap_open2"], params["gap_extend2"]

        def gap_layer(prev_h, prev_g, go, ge):
            opn, ext = prev_h + go, prev_g + ge
            return torch.maximum(opn, ext), _i32(ext > opn)

        i1, i1e = gap_layer(left[:, 0], left[:, 1], go1, ge1)
        d1, d1e = gap_layer(up[:, 0], up[:, 2], go1, ge1)
        i2, i2e = gap_layer(left[:, 0], left[:, 3], go2, ge2)
        d2, d2e = gap_layer(up[:, 0], up[:, 4], go2, ge2)
        m = diag[:, 0] + sub_fn(params, q, r)
        h, src = m, torch.full_like(m, TP_DIAG)
        for cand, code in ((d1, TP_UP1), (i1, TP_LEFT1), (d2, TP_UP2),
                           (i2, TP_LEFT2)):
            src = torch.where(cand > h, code, src)
            h = torch.maximum(h, cand)
        ptr = src | (i1e << 3) | (d1e << 4) | (i2e << 5) | (d2e << 6)
        return torch.stack([h, i1, d1, i2, d2], dim=-1), ptr
    return pe


def two_piece_fsm(state, ptr):
    src = ptr & 7
    i1e, d1e = (ptr >> 3) & 1, (ptr >> 4) & 1
    i2e, d2e = (ptr >> 5) & 1, (ptr >> 6) & 1
    in_mm = state == ST_MM
    up1 = torch.where(in_mm, src == TP_UP1, state == ST_DEL)
    left1 = torch.where(in_mm, src == TP_LEFT1, state == ST_INS)
    up2 = torch.where(in_mm, src == TP_UP2, state == ST_DEL2)
    left2 = torch.where(in_mm, src == TP_LEFT2, state == ST_INS2)
    ended = in_mm & (src == TP_END)
    going_up = up1 | up2
    going_left = left1 | left2
    move = torch.where(ended, T.MOVE_END,
                       torch.where(going_up, T.MOVE_UP,
                                   torch.where(going_left, T.MOVE_LEFT,
                                               T.MOVE_DIAG)))
    nstate = torch.where(up1 & (d1e == 1), ST_DEL,
             torch.where(left1 & (i1e == 1), ST_INS,
             torch.where(up2 & (d2e == 1), ST_DEL2,
             torch.where(left2 & (i2e == 1), ST_INS2, ST_MM))))
    return _i32(move), _i32(nstate)


def two_piece_tb(stop: str) -> T.TracebackSpec:
    return T.TracebackSpec(n_states=5, fsm=two_piece_fsm, stop=stop)


def _two_piece_costs(params, k):
    c1 = _gap_cost(k, params["gap_open"], params["gap_extend"])
    c2 = _gap_cost(k, params["gap_open2"], params["gap_extend2"])
    return torch.maximum(c1, c2), c1, c2


def two_piece_init_row(params, j):
    h, c1, c2 = _two_piece_costs(params, j)
    dead = torch.full_like(h, DEAD)
    return torch.stack([h, c1, dead, c2, dead], dim=-1)


def two_piece_init_col(params, i):
    h, c1, c2 = _two_piece_costs(params, i)
    dead = torch.full_like(h, DEAD)
    return torch.stack([h, dead, c1, dead, c2], dim=-1)


# ---------------------------------------------------------------------------
# Substitution functions and simple inits
# ---------------------------------------------------------------------------
def dna_sub(params, q, r):
    return _i32(torch.where(q == r, params["match"], params["mismatch"]))


def matrix_sub(params, q, r):
    """Look up ``params['sub'][q, r]``; codes past the matrix clamp to its
    last row/column (as JAX's gather does)."""
    sub = params["sub"].to(device=q.device, dtype=torch.int32)
    n = sub.shape[0] - 1
    return sub[q.long().clamp(max=n), r.long().clamp(max=n)]


def zeros_init(n_layers):
    def init(params, k):
        return torch.zeros(tuple(k.shape) + (n_layers,), dtype=torch.int32,
                           device=k.device)
    return init


def linear_gap_init(params, k):
    return (params["gap"] * k)[..., None]
