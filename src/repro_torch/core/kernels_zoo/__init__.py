"""The Table-1 DP kernels of the port: every int32 max-plus kernel of the
three ``common.py`` PE families (#1-7, #11-13, #15), which kernel K1 runs,
and the unit-cost edit kernels #16/#17, which the ``myers`` engine (kernel
K2) runs.

Registry keys match the paper's '#' indices, as in ``repro.core.kernels_zoo``.
The float kernels and sdtw are not ported yet; ``make`` names the ROADMAP
item that ports each of them.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dna_affine, dna_linear, dna_two_piece, edit, protein

# kernel_id -> (name, make_spec(**kw), default_params())
KERNELS = {
    1:  ("global_linear",          dna_linear.global_linear,        dna_linear.default_params),
    2:  ("global_affine",          dna_affine.global_affine,        dna_affine.default_params),
    3:  ("local_linear",           dna_linear.local_linear,         dna_linear.default_params),
    4:  ("local_affine",           dna_affine.local_affine,         dna_affine.default_params),
    5:  ("global_two_piece",       dna_two_piece.global_two_piece,  dna_two_piece.default_params),
    6:  ("overlap",                dna_linear.overlap,              dna_linear.default_params),
    7:  ("semiglobal",             dna_linear.semiglobal,           dna_linear.default_params),
    11: ("banded_global_linear",   dna_linear.banded_global_linear, dna_linear.default_params),
    12: ("banded_local_affine",    dna_affine.banded_local_affine,  dna_affine.default_params),
    13: ("banded_global_two_piece", dna_two_piece.banded_global_two_piece, dna_two_piece.default_params),
    15: ("protein_local",          protein.protein_local,           protein.default_params),
    16: ("edit_distance",          edit.edit_distance,              edit.default_params),
    17: ("edit_search",            edit.edit_search,                edit.default_params),
}

_FLOAT_ITEM = ("ROADMAP queue 1, 'K1 float families' (profile #8, dtw #9, "
               "viterbi #10)")
_MINPLUS_ITEM = "ROADMAP queue 1, 'K1 min-plus families' (sdtw #14)"
NOT_PORTED = {
    8: ("profile", _FLOAT_ITEM),
    9: ("dtw", _FLOAT_ITEM),
    10: ("viterbi_pairhmm", _FLOAT_ITEM),
    14: ("sdtw", _MINPLUS_ITEM),
}

BY_NAME = {name: (mk, dp) for (name, mk, dp) in KERNELS.values()}
_UNPORTED_BY_NAME = {name: (kid, item) for kid, (name, item)
                     in NOT_PORTED.items()}


def make(kernel, **kw):
    """kernel: paper index or name -> (spec, default_params).

    Raises NotImplementedError for a zoo kernel the port does not have yet,
    naming the ROADMAP item that ports it."""
    if isinstance(kernel, (int, np.integer)):
        kid = int(kernel)
        if kid in NOT_PORTED:
            name, item = NOT_PORTED[kid]
            raise NotImplementedError(
                f"zoo kernel #{kid} ({name}) is not ported yet: {item}")
        if kid not in KERNELS:
            raise KeyError(f"unknown zoo kernel #{kid}")
        _, mk, dp = KERNELS[kid]
    else:
        if kernel in _UNPORTED_BY_NAME:
            kid, item = _UNPORTED_BY_NAME[kernel]
            raise NotImplementedError(
                f"zoo kernel #{kid} ({kernel}) is not ported yet: {item}")
        if kernel not in BY_NAME:
            raise KeyError(f"unknown zoo kernel {kernel!r}")
        mk, dp = BY_NAME[kernel]
    return mk(**kw), dp()


def from_reference_params(params) -> dict:
    """Carry a JAX zoo parameter dict, given as numpy arrays
    (``{k: np.asarray(v)}``), across to the port: scalars become Python
    numbers, arrays become tensors of the same dtype."""
    out = {}
    for k, v in params.items():
        a = np.asarray(v)
        out[k] = a.item() if a.ndim == 0 else torch.as_tensor(a.copy())
    return out
