"""Kernels #16/#17 — unit-cost edit distance (Levenshtein), min-objective
(counterpart of ``repro.core.kernels_zoo.edit``).

``edit_distance`` is the global (corner) Levenshtein distance,
``edit_search`` the semiglobal variant: the query end to end against the
best reference substring, the pre-filter shape of the read mapper's ladder.
Both are score-only.  The ``myers`` engine (kernel K2) computes them
bit-parallel; K1 does not run them (it implements max-plus only), so the
specs carry no PE family.

``params['max_dist']`` is the k-threshold the ``myers`` engine honours: a
distance above k reports the sentinel.  ``max_dist < 0`` disables it.
"""
from __future__ import annotations

import torch

from .. import types as T


def default_params(max_dist: int = -1):
    return {"max_dist": int(max_dist)}


def _edit_pe(params, q, r, diag, up, left, i, j):
    m = diag[:, 0] + (q != r).to(torch.int32)
    best = torch.minimum(m, torch.minimum(up[:, 0] + 1, left[:, 0] + 1))
    return best[:, None], torch.zeros_like(best)


def _unit_init(params, k):
    return k.to(torch.int32)[..., None]


def _zeros_init(params, k):
    return torch.zeros(tuple(k.shape) + (1,), dtype=torch.int32,
                       device=k.device)


def edit_distance(**kw) -> T.DPKernelSpec:
    """#16 global Levenshtein distance: D[0][j] = j, D[i][0] = i, optimum
    at the corner."""
    return T.DPKernelSpec(
        name="edit_distance", n_layers=1, pe=_edit_pe,
        init_row=_unit_init, init_col=_unit_init,
        objective="min", region=T.REGION_CORNER, **kw)


def edit_search(**kw) -> T.DPKernelSpec:
    """#17 semiglobal Levenshtein: free start and end in the reference
    (D[0][j] = 0, optimum in the last row)."""
    return T.DPKernelSpec(
        name="edit_search", n_layers=1, pe=_edit_pe,
        init_row=_zeros_init, init_col=_unit_init,
        objective="min", region=T.REGION_LAST_ROW, **kw)
