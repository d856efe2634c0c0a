"""Helpers the PyTorch-port tests share: carrying a zoo kernel across both
packages and comparing their alignments field by field."""
from __future__ import annotations

import numpy as np
import torch

from repro.core import kernels_zoo as jzoo
from repro.core import traceback as jtb
from repro_torch.core import kernels_zoo as pzoo
from repro_torch.core import traceback as ptb

PORTED = [1, 2, 3, 4, 5, 6, 7, 11, 12, 13, 15]
FIELDS = ("score", "end_i", "end_j", "start_i", "start_j", "n_moves")


def kernel_pair(kid):
    """(jax spec, jax params, port spec, port params) with the port's
    parameters carried across from the JAX ones."""
    jspec, jparams = jzoo.make(kid)
    spec, _ = pzoo.make(kid)
    params = pzoo.from_reference_params(
        {k: np.asarray(v) for k, v in jparams.items()})
    return jspec, jparams, spec, params


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def random_codes(rng, spec, n):
    hi = 20 if spec.name == "protein_local" else 4
    return rng.integers(0, hi, n).astype(np.uint8)


def assert_same_alignment(want, got, fields=FIELDS, moves=True):
    """Exact equality of the named fields and, when both carry a path, of
    the moves and the CIGAR."""
    for f in fields:
        w, g = getattr(want, f), getattr(got, f)
        if w is None:
            assert g is None, f
            continue
        np.testing.assert_array_equal(to_np(g), to_np(w), err_msg=f)
    if moves and want.moves is not None:
        np.testing.assert_array_equal(to_np(got.moves), to_np(want.moves),
                                      err_msg="moves")
        assert ptb.moves_to_cigar(got.moves, got.n_moves) == \
            jtb.moves_to_cigar(want.moves, want.n_moves)
        assert ptb.path_cells(got) == jtb.path_cells(want)
