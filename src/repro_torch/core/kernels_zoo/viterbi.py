"""Kernel #10: Viterbi algorithm for a 3-state (M/I/D) pair-HMM in log
space (counterpart of ``repro.core.kernels_zoo.viterbi``): two transition
scalars (mu, lambda) and a 5x5 emission matrix over {A, C, G, T, -}, f32
scores, no traceback."""
from __future__ import annotations

import numpy as np
import torch

from .. import types as T

_DEAD = -1e30


def default_params(delta=0.2, eps=0.1, match_p=0.9):
    """Log-space pair-HMM parameters, rounded to float32 as the JAX
    package stores them: delta (lambda) is the gap-open probability, eps
    (mu) the gap-extend probability; the emission favours matching
    bases."""
    n = 5
    em = np.full((n, n), (1.0 - match_p) / (n - 1))
    np.fill_diagonal(em, match_p)

    def f32(x):
        return float(np.float32(x))
    return {
        "log_lambda": f32(np.log(delta)),
        "log_mu": f32(np.log(eps)),
        "t_mm": f32(np.log(1.0 - 2.0 * delta)),
        "t_gm": f32(np.log(1.0 - eps)),
        "emission": torch.as_tensor(np.log(em).astype(np.float32)),
        "gap_emission": f32(np.log(0.25)),
    }


def scalar(params, name):
    """A float parameter as a 0-d f32 tensor, so that sums of parameters
    round to f32 as they do in the JAX package."""
    return torch.as_tensor(params[name], dtype=torch.float32)


def emission(params, q, r):
    """``params['emission'][q, r]``; codes past the table clamp to its
    last row/column (as JAX's gather does)."""
    tab = params["emission"].to(device=q.device, dtype=torch.float32)
    n = tab.shape[0] - 1
    return tab[q.long().clamp(0, n), r.long().clamp(0, n)]


def _pe(params, q, r, diag, up, left, i, j):
    em = emission(params, q, r)
    t_mi = scalar(params, "log_lambda")   # M -> I/D (open)
    t_ii = scalar(params, "log_mu")       # I -> I / D -> D (extend)
    ge = scalar(params, "gap_emission")
    m = em + torch.maximum(diag[:, 0] + scalar(params, "t_mm"),
                           torch.maximum(diag[:, 1], diag[:, 2])
                           + scalar(params, "t_gm"))
    ins = ge + torch.maximum(left[:, 0] + t_mi, left[:, 1] + t_ii)
    dele = ge + torch.maximum(up[:, 0] + t_mi, up[:, 2] + t_ii)
    return (torch.stack([m, ins, dele], dim=-1),
            torch.zeros(m.shape, dtype=torch.int32, device=m.device))


def _gap_run(params, k):
    """t_mi + (k - 1) t_ii + k ge for k >= 1, dead at k == 0."""
    t_mi, t_ii = scalar(params, "log_lambda"), scalar(params, "log_mu")
    ge = scalar(params, "gap_emission")
    cost = t_mi + (k - 1).to(torch.float32) * t_ii \
        + k.to(torch.float32) * ge
    return torch.where(k == 0, _DEAD, cost).to(torch.float32)


def _init_row(params, j):
    ins = _gap_run(params, j)
    m = torch.where(j == 0, 0.0, _DEAD).to(torch.float32)
    dead = torch.full_like(m, _DEAD)
    return torch.stack([m, ins, dead], dim=-1)


def _init_col(params, i):
    dele = _gap_run(params, i)
    m = torch.where(i == 0, 0.0, _DEAD).to(torch.float32)
    dead = torch.full_like(m, _DEAD)
    return torch.stack([m, dead, dele], dim=-1)


def viterbi(**kw) -> T.DPKernelSpec:
    return T.DPKernelSpec(
        name="viterbi_pairhmm", n_layers=3,
        pe=_pe, init_row=_init_row, init_col=_init_col,
        objective="max", region=T.REGION_CORNER,
        score_dtype=torch.float32, traceback=None,
        family=T.PEFamily(T.FAMILY_VITERBI, T.SUB_EMISSION), **kw)
