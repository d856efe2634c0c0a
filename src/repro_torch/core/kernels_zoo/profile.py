"""Kernel #8: profile-profile alignment (MSA-style), counterpart of
``repro.core.kernels_zoo.profile``.

Characters are profile columns, 5-vectors of {A, C, G, T, gap}
frequencies; the substitution score is the sum of pairs q^T S r.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import types as T
from . import common as C


def default_params(match=2.0, mismatch=-3.0, gap=-2.0, gap_gap=0.0):
    s = np.full((5, 5), mismatch, np.float32)
    np.fill_diagonal(s, match)
    s[4, :] = gap      # residue vs gap column
    s[:, 4] = gap
    s[4, 4] = gap_gap  # gap vs gap is free
    return {"sub_matrix": torch.as_tensor(s),
            "gap": float(np.float32(gap))}


def sop_sub(params, q, r):
    """q @ S @ r per lane, summed in a fixed order (t_k = sum_m q_m S_mk
    with m ascending, then sum_k t_k r_k with k ascending; one rounding
    per product and per sum), the order the CUDA functor keeps."""
    s = params["sub_matrix"].to(device=q.device, dtype=torch.float32)
    t = q[:, 0:1] * s[0]
    for m in range(1, s.shape[0]):
        t = t + q[:, m:m + 1] * s[m]
    out = t[:, 0] * r[:, 0]
    for k in range(1, s.shape[1]):
        out = out + t[:, k] * r[:, k]
    return out


def _gap_init(params, k):
    gap = torch.as_tensor(params["gap"], dtype=torch.float32)
    return (gap * k.to(torch.float32))[..., None]


def profile(**kw) -> T.DPKernelSpec:
    return T.DPKernelSpec(
        name="profile", n_layers=1,
        pe=C.linear_pe(sop_sub),
        init_row=_gap_init, init_col=_gap_init,
        region=T.REGION_CORNER,
        score_dtype=torch.float32, char_shape=(5,), char_dtype=torch.float32,
        traceback=C.linear_tb(T.STOP_ORIGIN), ptr_bits=C.LINEAR_PTR_BITS,
        family=T.PEFamily(T.FAMILY_PROFILE, T.SUB_SOP), **kw)


def make_profile(rng: np.random.Generator, n: int,
                 n_seqs: int = 8) -> np.ndarray:
    """Random sequence profile: per-column frequencies over {A,C,G,T,-}."""
    counts = rng.multinomial(n_seqs, [0.22, 0.22, 0.22, 0.22, 0.12], size=n)
    return (counts / n_seqs).astype(np.float32)
