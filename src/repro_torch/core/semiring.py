"""Scoring semirings on tensors: the algebra a DP kernel accumulates paths
under (port of ``repro.core.semiring``).

  * max-plus    — ⊕ = max:       alignment scores; the optimum path exists.
  * min-plus    — ⊕ = min:       the DTW family.
  * log-sum-exp — ⊕ = logaddexp: pair-HMM forward/posterior; every cell holds
    the total mass of its paths, so no single path exists to trace back.

``⊗`` is ``+`` in every case.  The unreachable-cell "zero" is the engines'
large-magnitude sentinel (±1e30 in float32), which ``logaddexp`` absorbs
bit-exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def _flat(x, axis):
    return (x.reshape(-1), 0) if axis is None else (x, axis)


def _max(x, axis=None):
    x, axis = _flat(x, axis)
    return torch.amax(x, dim=axis)


def _min(x, axis=None):
    x, axis = _flat(x, axis)
    return torch.amin(x, dim=axis)


def _argmax(x, axis=None):
    x, axis = _flat(x, axis)
    return torch.argmax(x, dim=axis)


def _argmin(x, axis=None):
    x, axis = _flat(x, axis)
    return torch.argmin(x, dim=axis)


def _logsumexp(x, axis=None):
    x, axis = _flat(x, axis)
    return torch.logsumexp(x, dim=axis)


@dataclasses.dataclass(frozen=True)
class Semiring:
    """One path-combination algebra: ``combine`` is the binary ⊕,
    ``reduce``/``arg`` fold it over an axis (None = all elements), and
    ``selective`` says whether ⊕ returns one of its operands."""
    name: str
    combine: Callable[[Any, Any], Any]
    reduce: Callable[..., Any]
    arg: Callable[..., Any]
    selective: bool

    def __repr__(self):
        return f"Semiring({self.name})"


MAX_PLUS = Semiring("maxplus", torch.maximum, _max, _argmax, selective=True)
MIN_PLUS = Semiring("minplus", torch.minimum, _min, _argmin, selective=True)
LOG_SUM_EXP = Semiring("logsumexp", torch.logaddexp, _logsumexp, _argmax,
                       selective=False)

BY_OBJECTIVE = {"max": MAX_PLUS, "min": MIN_PLUS, "logsumexp": LOG_SUM_EXP}


def from_objective(objective: str) -> Semiring:
    sr = BY_OBJECTIVE.get(objective)
    if sr is None:
        raise ValueError(
            f"unknown objective {objective!r}; have {sorted(BY_OBJECTIVE)}")
    return sr
