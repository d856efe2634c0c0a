"""Host-side path re-scoring (counterpart of ``repro.core.rescore``):
recompute an alignment's score from its move string.  An engine's (score,
path) pair is valid iff rescore(path) == score; the check is tie-break
agnostic, so it validates float kernels whose pointers may differ at
near-ties.
"""
from __future__ import annotations

import numpy as np
import torch

from . import types as T


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _gap_runs(moves):
    """Split the start->end move list into ops with gap-run lengths."""
    runs = []
    for m in moves:
        if runs and runs[-1][0] == m and m in (T.MOVE_UP, T.MOVE_LEFT):
            runs[-1][1] += 1
        else:
            runs.append([m, 1])
    return runs


def rescore(spec, params, query, ref, alignment: T.Alignment) -> float:
    """Recompute the path score under the kernel's scoring model."""
    params = {k: _np(v) for k, v in params.items()}
    q = _np(query)
    r = _np(ref)
    n = int(alignment.n_moves)
    moves = [int(m) for m in _np(alignment.moves)[:n][::-1]]  # start->end
    i, j = int(alignment.start_i), int(alignment.start_j)

    def sub(qi, rj):
        name = spec.name
        if name in ("protein_local",):
            return int(params["sub"][q[qi], r[rj]])
        if name == "profile":
            return float(q[qi] @ params["sub_matrix"] @ r[rj])
        if name == "dtw":
            return float(abs(q[qi][0] - r[rj][0]) + abs(q[qi][1] - r[rj][1]))
        if name == "sdtw":
            return float(abs(int(q[qi]) - int(r[rj])))
        m = params["match"] if q[qi] == r[rj] else params["mismatch"]
        return int(m)

    def gap_cost(k):
        if "gap_open2" in params:   # two-piece
            c1 = params["gap_open"] + (k - 1) * params["gap_extend"]
            c2 = params["gap_open2"] + (k - 1) * params["gap_extend2"]
            return int(max(c1, c2))
        if "gap_open" in params:    # affine
            return int(params["gap_open"] + (k - 1) * params["gap_extend"])
        if "gap" in params:         # linear
            return k * params["gap"].item()
        return 0.0                  # DTW family: up/left carry the cell cost

    total = 0.0
    for m, k in _gap_runs(moves):
        if m == T.MOVE_DIAG:
            for _ in range(k):
                total += sub(i, j)  # consumes q[i], r[j]
                i, j = i + 1, j + 1
        elif m == T.MOVE_UP:
            if spec.name in ("dtw", "sdtw"):
                for _ in range(k):
                    total += sub(i, j - 1) if j > 0 else 0.0
                    i += 1
            else:
                total += gap_cost(k)
                i += k
        elif m == T.MOVE_LEFT:
            if spec.name in ("dtw", "sdtw"):
                for _ in range(k):
                    total += sub(i - 1, j) if i > 0 else 0.0
                    j += 1
            else:
                total += gap_cost(k)
                j += k
    if (i, j) != (int(alignment.end_i), int(alignment.end_j)):
        raise ValueError(
            f"path does not land on the reported end cell: ({i},{j}) vs "
            f"({int(alignment.end_i)},{int(alignment.end_j)})")
    return total
