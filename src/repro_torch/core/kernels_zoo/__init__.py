"""The Table-1 DP kernels of the port, each a declarative spec (counterpart
of ``repro.core.kernels_zoo``): the 15 kernels of the paper, which kernel
K1 fills (int32 max-plus #1-7, #11-13, #15; f32 max-plus #8 and #10; f32
min-plus #9; int32 min-plus #14), and the unit-cost edit kernels #16/#17,
which the ``myers`` engine (kernel K2) runs.

Registry keys match the paper's '#' indices, as in ``repro.core.kernels_zoo``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import (dna_affine, dna_linear, dna_two_piece, dtw, edit, profile,
               protein, viterbi)

# kernel_id -> (name, make_spec(**kw), default_params())
KERNELS = {
    1:  ("global_linear",          dna_linear.global_linear,        dna_linear.default_params),
    2:  ("global_affine",          dna_affine.global_affine,        dna_affine.default_params),
    3:  ("local_linear",           dna_linear.local_linear,         dna_linear.default_params),
    4:  ("local_affine",           dna_affine.local_affine,         dna_affine.default_params),
    5:  ("global_two_piece",       dna_two_piece.global_two_piece,  dna_two_piece.default_params),
    6:  ("overlap",                dna_linear.overlap,              dna_linear.default_params),
    7:  ("semiglobal",             dna_linear.semiglobal,           dna_linear.default_params),
    8:  ("profile",                profile.profile,                 profile.default_params),
    9:  ("dtw",                    dtw.dtw,                         dtw.default_dtw_params),
    10: ("viterbi_pairhmm",        viterbi.viterbi,                 viterbi.default_params),
    11: ("banded_global_linear",   dna_linear.banded_global_linear, dna_linear.default_params),
    12: ("banded_local_affine",    dna_affine.banded_local_affine,  dna_affine.default_params),
    13: ("banded_global_two_piece", dna_two_piece.banded_global_two_piece, dna_two_piece.default_params),
    14: ("sdtw",                   dtw.sdtw,                        dtw.default_sdtw_params),
    15: ("protein_local",          protein.protein_local,           protein.default_params),
    16: ("edit_distance",          edit.edit_distance,              edit.default_params),
    17: ("edit_search",            edit.edit_search,                edit.default_params),
}

BY_NAME = {name: (mk, dp) for (name, mk, dp) in KERNELS.values()}


def make(kernel, **kw):
    """kernel: paper index or name -> (spec, default_params)."""
    if isinstance(kernel, (int, np.integer)):
        if int(kernel) not in KERNELS:
            raise KeyError(f"unknown zoo kernel #{int(kernel)}")
        _, mk, dp = KERNELS[int(kernel)]
    else:
        if kernel not in BY_NAME:
            raise KeyError(f"unknown zoo kernel {kernel!r}")
        mk, dp = BY_NAME[kernel]
    return mk(**kw), dp()


def from_reference_params(params) -> dict:
    """Carry a JAX parameter dict (a zoo kernel's, or the pair-HMM's of
    ``repro.prob``), given as numpy arrays (``{k: np.asarray(v)}``),
    across to the port: scalars become Python numbers (a float32 scalar
    keeps its value exactly), arrays become tensors of the same dtype."""
    out = {}
    for k, v in params.items():
        a = np.asarray(v)
        out[k] = a.item() if a.ndim == 0 else torch.as_tensor(a.copy())
    return out
