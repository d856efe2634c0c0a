"""Forward-backward posterior decoding for the pair-HMM (counterpart of
``repro.prob.posterior``).

Two full-matrix fills, the forward spec on (read, hap) and the backward
spec on the reversed pair, and one log-space combination give the
posterior probability of every alignment event:

    P(read base i matched to hap base j)   = exp(F_M(i,j) + B_M(i,j) - Z)
    P(read base i inserted after hap j)    = exp(F_X(i,j) + B_X(i,j) - Z)

Both fills run through ``core.api.fill`` on the ``reference`` engine,
whose (Q+1, R+1, L) score matrix is the store forward-backward needs.  The
backward matrix comes out in reversed coordinates (cell (i', j') holds
B(q_len - i', r_len - j')) and is un-reversed here.

Identities (checked in tests): ``log_z`` equals the backward spec's score,
and every read row's posterior mass sums to 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import api

from . import kernels as K


@dataclasses.dataclass
class PosteriorResult:
    """Posterior decode of one (read, haplotype) pair.

    ``post_match[i, j]`` / ``post_ins[i, j]`` are (q_len, r_len) arrays for
    read base i+1 and hap base j+1; ``log_z`` is the forward
    log-likelihood, ``log_z_backward`` the same mass folded by the backward
    fill.  ``map_path`` gives per-read-base argmax hap positions (-1 where
    an insertion dominates)."""
    log_z: float
    log_z_backward: float
    post_match: np.ndarray
    post_ins: np.ndarray

    @property
    def map_path(self) -> np.ndarray:
        best_j = np.argmax(self.post_match, axis=1)
        p_match = self.post_match[np.arange(len(best_j)), best_j]
        p_ins = self.post_ins.sum(axis=1)
        return np.where(p_match >= p_ins, best_j, -1)


def forward_backward(params, read, hap, *, engine_name: str = "reference",
                     device="cuda") -> PosteriorResult:
    """Posterior-decode one pair on ``device`` (the card unless ``"cpu"``
    is asked for).  ``engine_name`` must be a full-matrix engine."""
    q = np.ascontiguousarray(np.asarray(read, np.uint8))
    r = np.ascontiguousarray(np.asarray(hap, np.uint8))
    Q, R = len(q), len(r)
    if Q < 1 or R < 1:
        raise ValueError(f"posterior needs non-empty sequences, got ({Q}, {R})")
    fres = api.fill(K.cached_pairhmm(), params, q, r,
                    engine_name=engine_name, device=device)
    bres = api.fill(K.cached_pairhmm_backward(), params,
                    q[::-1].copy(), r[::-1].copy(),
                    engine_name=engine_name, device=device)
    if fres.matrix is None or bres.matrix is None:
        raise ValueError(f"engine {engine_name!r} keeps no score matrix")
    F = fres.matrix.cpu().double().numpy()[: Q + 1, : R + 1]
    Brev = bres.matrix.cpu().double().numpy()[: Q + 1, : R + 1]
    B = Brev[::-1, ::-1]            # B(i, j, s) = Brev(Q - i, R - j, s)
    log_z = float(fres.score)
    post_match = np.exp(F[1:, 1:, 0] + B[1:, 1:, 0] - log_z)
    post_ins = np.exp(F[1:, 1:, 1] + B[1:, 1:, 1] - log_z)
    return PosteriorResult(log_z=log_z, log_z_backward=float(bres.score),
                           post_match=post_match, post_ins=post_ins)
