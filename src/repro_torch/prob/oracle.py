"""Exhaustive path-enumeration oracle for the pair-HMM forward model (a
copy of ``repro.prob.oracle``).

Sums every legal state path's log-probability in float64 — exponential
cost, tiny inputs only, and *zero shared code* with any engine: the
ground truth the forward kernels (and the benchmark parity gate) are
validated against.
"""
from __future__ import annotations

import numpy as np


def oracle_forward(params, q, r) -> float:
    """Total log-probability of read ``q`` given haplotype ``r``.

    Paths start in Y on row 0 (any column — the free-start mass), must
    immediately enter M (row 0 is init-only: no Y->Y chaining there),
    and terminate the moment the read is consumed, from M or X — the
    exact model ``prob.kernels.pairhmm`` computes with DP.
    """
    em = np.asarray(params["emission"], np.float64)
    ge = float(params["gap_emission"])
    t_mm, t_gm = float(params["t_mm"]), float(params["t_gm"])
    lo, le = float(params["log_lambda"]), float(params["log_mu"])
    q = np.asarray(q)
    r = np.asarray(r)
    Q, R = len(q), len(r)
    M, X, Y = 0, 1, 2
    trans = {(M, M): t_mm, (X, M): t_gm, (Y, M): t_gm,
             (M, X): lo, (X, X): le, (M, Y): lo, (Y, Y): le}
    total = [-np.inf]

    def rec(i, j, s, lp):
        if i == Q:
            if s in (M, X):
                total[0] = np.logaddexp(total[0], lp)
            return
        if j < R and (s, M) in trans:
            rec(i + 1, j + 1, M, lp + trans[(s, M)] + em[q[i], r[j]])
        if (s, X) in trans:
            rec(i + 1, j, X, lp + trans[(s, X)] + ge)
        if i >= 1 and j < R and (s, Y) in trans:
            rec(i, j + 1, Y, lp + trans[(s, Y)] + ge)

    for j0 in range(R):
        rec(0, j0, Y, 0.0)
    return total[0]
