"""GATK-style pair-HMM kernels, semiring-generic: forward, Viterbi and
backward (counterpart of ``repro.prob.kernels``).

One PE template covers the family: written against ``semiring.combine``
it is the Viterbi scorer under max-plus and the forward-likelihood
recurrence under log-sum-exp.  Kernel K1 compiles both
(``csrc/wavefront_ext.cu``); the functions here are their plain versions.

Model (read x on the query axis, haplotype y on the reference axis):

  * states M (match/mismatch, consumes both), X (read insertion, the
    engines' *up* move) and Y (haplotype gap, the *left* move);
  * transitions M->X = M->Y = delta (gap open), X->X = Y->Y = eps (gap
    extend), X->M = Y->M = 1 - eps, M->M = 1 - 2 delta; X<->Y forbidden;
  * emissions: a 5x5 table for M and a flat ``gap_emission`` for X/Y (the
    parameter layout of zoo kernel #10: one ``default_params`` dict drives
    both);
  * free start and end along the haplotype: row 0 carries unit mass in Y
    at every column and the likelihood sums M + X over the last row, so it
    is unnormalized over start positions (``prob.genotype`` subtracts
    ``log r_len``).

Layers ``[M, X, Y, F]`` with ``F = M ⊕ X``: ``region=LAST_ROW`` and the sum
semiring's region fold give ``logsumexp_j F(q_len, j)``, the forward
likelihood.  ``pairhmm_backward`` is the suffix recurrence as a forward
fill over the reversed pair: its cell (i', j') holds B(q_len - i',
r_len - j') (see ``prob.posterior``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import semiring as S
from repro_torch.core import types as T
from repro_torch.core.kernels_zoo import viterbi as viterbi_mod

_DEAD = -1e30

# the zoo Viterbi kernel's parameter dict is this family's parameter dict
default_params = viterbi_mod.default_params
_p = viterbi_mod.scalar


def _zeros_ptr(x):
    return torch.zeros(x.shape, dtype=torch.int32, device=x.device)


def _forward_pe(sr: S.Semiring):
    """⊕ over incoming transitions; ``up`` consumes a read base (X),
    ``left`` a haplotype base (Y)."""
    def pe(params, q, r, diag, up, left, i, j):
        em = viterbi_mod.emission(params, q, r)
        t_open, t_ext = _p(params, "log_lambda"), _p(params, "log_mu")
        ge = _p(params, "gap_emission")
        m = em + sr.combine(diag[:, 0] + _p(params, "t_mm"),
                            sr.combine(diag[:, 1], diag[:, 2])
                            + _p(params, "t_gm"))
        x = ge + sr.combine(up[:, 0] + t_open, up[:, 1] + t_ext)
        y = ge + sr.combine(left[:, 0] + t_open, left[:, 2] + t_ext)
        f = sr.combine(m, x)             # termination-eligible mass
        return torch.stack([m, x, y, f], dim=-1), _zeros_ptr(m)
    return pe


def _forward_init_row(params, j):
    """Free start along the haplotype: unit mass in Y at every column."""
    y = torch.zeros(j.shape, dtype=torch.float32, device=j.device)
    dead = torch.full_like(y, _DEAD)
    return torch.stack([dead, dead, y, dead], dim=-1)


def _forward_init_col(params, i):
    """Column 0: only the (0, 0) start cell is live."""
    y = torch.where(i == 0, 0.0, _DEAD).to(torch.float32)
    dead = torch.full_like(y, _DEAD)
    return torch.stack([dead, dead, y, dead], dim=-1)


def pairhmm(objective: str = "logsumexp", **kw) -> T.DPKernelSpec:
    """The pair-HMM spec at a semiring: ``'logsumexp'`` (default) is the
    forward likelihood log P(read | haplotype), ``'max'`` the best single
    alignment's log-probability (always <= forward).  ``band=W`` prunes
    |i - j| > W."""
    sr = S.from_objective(objective)
    return T.DPKernelSpec(
        name=f"pairhmm_{sr.name}", n_layers=4,
        pe=_forward_pe(sr),
        init_row=_forward_init_row, init_col=_forward_init_col,
        objective=objective, region=T.REGION_LAST_ROW,
        score_dtype=torch.float32, primary_layer=3, traceback=None,
        family=T.PEFamily(T.FAMILY_PAIRHMM_FORWARD, T.SUB_EMISSION), **kw)


def _backward_pe(sr: S.Semiring):
    """Backward values as a forward-style fill over reversed inputs:

      B_M = (t_mm + em) B_M(diag) ⊕ (delta + ge) B_X(up)
                                  ⊕ (delta + ge) B_Y(left)
      B_X = (t_gm + em) B_M(diag) ⊕ (eps + ge) B_X(up)
      B_Y = (t_gm + em) B_M(diag) ⊕ (eps + ge) B_Y(left)

    and the start mass S = (t_gm + em) B_M(diag), whose last-row fold is
    the total mass Z (see ``repro.prob.kernels._backward_pe``)."""
    def pe(params, q, r, diag, up, left, i, j):
        em = viterbi_mod.emission(params, q, r)
        t_open, t_ext = _p(params, "log_lambda"), _p(params, "log_mu")
        ge = _p(params, "gap_emission")
        to_m_from_m = _p(params, "t_mm") + em + diag[:, 0]
        to_m_from_gap = _p(params, "t_gm") + em + diag[:, 0]
        m = sr.combine(to_m_from_m,
                       sr.combine(t_open + ge + up[:, 1],
                                  t_open + ge + left[:, 2]))
        x = sr.combine(to_m_from_gap, t_ext + ge + up[:, 1])
        y = sr.combine(to_m_from_gap, t_ext + ge + left[:, 2])
        return (torch.stack([m, x, y, to_m_from_gap], dim=-1),
                _zeros_ptr(m))
    return pe


def _backward_init_row(params, j):
    """Row i' = 0 holds B(q_len, ·): exit from M or X with unit weight."""
    z = torch.zeros(j.shape, dtype=torch.float32, device=j.device)
    dead = torch.full_like(z, _DEAD)
    return torch.stack([z, z, dead, dead], dim=-1)


def _backward_init_col(params, i):
    """Column j' = 0 holds B(·, r_len): only X-chains remain."""
    t_open, t_ext = _p(params, "log_lambda"), _p(params, "log_mu")
    ge = _p(params, "gap_emission")
    fi = i.to(torch.float32)
    x = fi * (t_ext + ge)
    m = torch.where(i == 0, 0.0,
                    t_open + ge + (i - 1).to(torch.float32) * (t_ext + ge))
    dead = torch.full_like(x, _DEAD)
    return torch.stack([m.to(torch.float32), x, dead, dead], dim=-1)


def pairhmm_backward(objective: str = "logsumexp", **kw) -> T.DPKernelSpec:
    """Backward pair-HMM fill (run it on the reversed read and haplotype):
    its score, ``logsumexp_j S(0, j)``, equals the forward likelihood."""
    sr = S.from_objective(objective)
    return T.DPKernelSpec(
        name=f"pairhmm_backward_{sr.name}", n_layers=4,
        pe=_backward_pe(sr),
        init_row=_backward_init_row, init_col=_backward_init_col,
        objective=objective, region=T.REGION_LAST_ROW,
        score_dtype=torch.float32, primary_layer=3, traceback=None,
        family=T.PEFamily(T.FAMILY_PAIRHMM_BACKWARD, T.SUB_EMISSION), **kw)


# One spec object per configuration: the plan cache keys plans by the spec
# object, so every caller of the same kernel resolves it through these.
@functools.lru_cache(maxsize=None)
def cached_pairhmm(objective: str = "logsumexp", band=None) -> T.DPKernelSpec:
    return pairhmm(objective, band=band)


@functools.lru_cache(maxsize=None)
def cached_pairhmm_backward(objective: str = "logsumexp") -> T.DPKernelSpec:
    return pairhmm_backward(objective)
