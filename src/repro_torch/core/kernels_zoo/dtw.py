"""Kernels #9 (DTW over complex signals) and #14 (sDTW over integer
squiggles): min-objective DP, the paper's 'replace max with min' variation
(counterpart of ``repro.core.kernels_zoo.dtw``)."""
from __future__ import annotations

import torch

from .. import types as T
from . import common as C

_INF = 1e30


def _dtw_pe(cost_fn):
    """cost + min(diag, up, left); a later candidate wins only when
    strictly smaller."""
    def pe(params, q, r, diag, up, left, i, j):
        c = cost_fn(params, q, r)
        best = diag[:, 0]
        ptr = torch.full(best.shape, C.P_DIAG, dtype=torch.int32,
                         device=best.device)
        ptr = torch.where(up[:, 0] < best, C.P_UP, ptr)
        best = torch.minimum(best, up[:, 0])
        ptr = torch.where(left[:, 0] < best, C.P_LEFT, ptr)
        best = torch.minimum(best, left[:, 0])
        return (c + best)[:, None], ptr
    return pe


def _manhattan_complex(params, q, r):
    return (q[:, 0] - r[:, 0]).abs() + (q[:, 1] - r[:, 1]).abs()


def _abs_int(params, q, r):
    return (q.to(torch.int32) - r.to(torch.int32)).abs()


def _corner_zero_init(dt):
    far = _INF if dt.is_floating_point else (1 << 30)

    def init(params, k):
        return torch.where(k == 0, 0, far).to(dt)[..., None]
    return init


def dtw(**kw) -> T.DPKernelSpec:
    """#9: global DTW on complex-valued signals (Manhattan distance)."""
    return T.DPKernelSpec(
        name="dtw", n_layers=1,
        pe=_dtw_pe(_manhattan_complex),
        init_row=_corner_zero_init(torch.float32),
        init_col=_corner_zero_init(torch.float32),
        objective="min", region=T.REGION_CORNER,
        score_dtype=torch.float32, char_shape=(2,), char_dtype=torch.float32,
        traceback=C.linear_tb(T.STOP_ORIGIN), ptr_bits=C.LINEAR_PTR_BITS,
        family=T.PEFamily(T.FAMILY_DTW, T.SUB_COMPLEX), **kw)


def default_dtw_params():
    return {}


def _sdtw_row_init(params, j):
    return torch.zeros(tuple(j.shape) + (1,), dtype=torch.int32,
                       device=j.device)


def _sdtw_col_init(params, i):
    return torch.where(i == 0, 0, 1 << 30).to(torch.int32)[..., None]


def sdtw(**kw) -> T.DPKernelSpec:
    """#14: semi-global DTW (SquiggleFilter): query anchored, free start and
    end along the reference; score-only."""
    return T.DPKernelSpec(
        name="sdtw", n_layers=1,
        pe=_dtw_pe(_abs_int),
        init_row=_sdtw_row_init, init_col=_sdtw_col_init,
        objective="min", region=T.REGION_LAST_ROW,
        score_dtype=torch.int32, char_shape=(), char_dtype=torch.int32,
        traceback=None, family=T.PEFamily(T.FAMILY_DTW, T.SUB_ABS), **kw)


def default_sdtw_params():
    return {}
