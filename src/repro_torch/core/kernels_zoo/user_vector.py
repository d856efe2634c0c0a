"""PEs over vector characters as a user declares them, beside two zoo
kernels K1 once ran only through hand-written functors: the cases K1's
generated functors are held to over vector characters (the CPU tests
against the JAX package, ``chip_smoke.py`` phase 3c on the card).

- ``dtw_band``: #9 with a Sakoe-Chiba band of 8 (complex samples);
- ``profile_last_row``: #8, semi-global over the last row;
- ``euclid``: Euclidean DTW over 3-channel f32 samples, band 16;
- ``chebyshev``: subsequence Chebyshev DTW over 3-channel samples, scaled
  by a parameter;
- ``profile_local``: local profile-to-profile alignment over 5-vector
  columns through a matrix product;
- ``quality``: quality-aware global linear alignment over (base, phred)
  bytes with int32 scores, a mismatch costing 1 + min(phred) // 10.

Not in the zoo's registry: ``make(name)`` gives (spec, params).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import types as T
from . import common as C
from . import dtw, profile

NAMES = ("dtw_band", "profile_last_row", "euclid", "chebyshev",
         "profile_local", "quality")

# 3 for a shared row of two columns, -1 otherwise: profiles of one family
# score above zero, unrelated ones below
PROFILE_S = torch.full((5, 5), -1.0) + 4.0 * torch.eye(5)


def dtw_step(c, diag, up, left):
    """cost + min(diag, up, left), a later candidate only when strictly
    smaller (zoo #9's order)."""
    best = diag[:, 0]
    ptr = torch.full(best.shape, C.P_DIAG, dtype=torch.int32,
                     device=best.device)
    ptr = torch.where(up[:, 0] < best, C.P_UP, ptr)
    best = torch.minimum(best, up[:, 0])
    ptr = torch.where(left[:, 0] < best, C.P_LEFT, ptr)
    best = torch.minimum(best, left[:, 0])
    return (c + best)[:, None], ptr


def euclid_pe(params, q, r, diag, up, left, i, j):
    return dtw_step(((q - r) ** 2).sum(-1).sqrt(), diag, up, left)


def cheb_pe(params, q, r, diag, up, left, i, j):
    return dtw_step((q - r).abs().amax(-1) / params["scale"], diag, up,
                    left)


def profile_local_sub(params, q, r):
    return ((q @ params["S"]) * r).sum(-1)


def quality_sub(params, q, r):
    """A mismatch costs 1 + min(phred) // 10: a mismatch the reads are
    sure of costs more."""
    mis = 1 + torch.minimum(q[:, 1], r[:, 1]).to(torch.int32) // 10
    return torch.where(q[:, 0] == r[:, 0], params["match"], -mis)


def far_init(params, k):
    return torch.where(k == 0, 0.0, 1e30).to(torch.float32)[..., None]


def free_init(params, k):
    return torch.zeros(tuple(k.shape) + (1,), dtype=torch.float32,
                       device=k.device)


_F32 = dict(n_layers=1, score_dtype=torch.float32, char_dtype=torch.float32,
            ptr_bits=C.LINEAR_PTR_BITS)
_DTW3 = dict(_F32, objective="min", char_shape=(3,))


def make(name):
    """(spec, params) of the case ``name`` (one of ``NAMES``)."""
    if name == "dtw_band":
        return dtw.dtw(band=8), dtw.default_dtw_params()
    if name == "profile_last_row":
        return (dataclasses.replace(profile.profile(),
                                    region=T.REGION_LAST_ROW),
                profile.default_params())
    if name == "euclid":
        return T.DPKernelSpec(
            name="euclid_dtw", pe=euclid_pe, init_row=far_init,
            init_col=far_init, region=T.REGION_CORNER, band=16,
            traceback=C.linear_tb(T.STOP_ORIGIN), **_DTW3), {}
    if name == "chebyshev":
        return T.DPKernelSpec(
            name="chebyshev_sdtw", pe=cheb_pe, init_row=free_init,
            init_col=far_init, region=T.REGION_LAST_ROW,
            traceback=C.linear_tb(T.STOP_TOP_ROW), **_DTW3), {"scale": 0.5}
    if name == "profile_local":
        return T.DPKernelSpec(
            name="profile_local", pe=C.linear_pe(profile_local_sub,
                                                 local=True),
            init_row=free_init, init_col=free_init, region=T.REGION_ALL,
            char_shape=(5,), traceback=C.linear_tb(T.STOP_PTR_END),
            **_F32), {"S": PROFILE_S.clone(), "gap": -1.0}
    if name == "quality":
        return T.DPKernelSpec(
            name="quality_global", n_layers=1, pe=C.linear_pe(quality_sub),
            init_row=C.linear_gap_init, init_col=C.linear_gap_init,
            region=T.REGION_CORNER, char_shape=(2,), char_dtype=torch.uint8,
            traceback=C.linear_tb(T.STOP_ORIGIN),
            ptr_bits=C.LINEAR_PTR_BITS), {"match": 2, "gap": -3}
    raise KeyError(f"unknown vector-character case {name!r}")
