"""Kernels #1 (global), #3 (local), #6 (overlap), #7 (semi-global),
#11 (banded global) — DNA alignment with linear gap penalty."""
from __future__ import annotations

from .. import types as T
from . import common as C


def default_params(match=2, mismatch=-3, gap=-2):
    return {"match": int(match), "mismatch": int(mismatch), "gap": int(gap)}


def _spec(name, init_row, init_col, region, stop, local=False, **kw):
    return T.DPKernelSpec(
        name=name, n_layers=1, pe=C.linear_pe(C.dna_sub, local=local),
        init_row=init_row, init_col=init_col, region=region,
        traceback=C.linear_tb(stop), ptr_bits=C.LINEAR_PTR_BITS,
        family=T.PEFamily(T.FAMILY_LINEAR, T.SUB_DNA, local), **kw)


def global_linear(**kw) -> T.DPKernelSpec:
    """#1 Needleman-Wunsch."""
    return _spec("global_linear", C.linear_gap_init, C.linear_gap_init,
                 T.REGION_CORNER, T.STOP_ORIGIN, **kw)


def local_linear(**kw) -> T.DPKernelSpec:
    """#3 Smith-Waterman: zero-clamped scores, best anywhere."""
    return _spec("local_linear", C.zeros_init(1), C.zeros_init(1),
                 T.REGION_ALL, T.STOP_PTR_END, local=True, **kw)


def overlap(**kw) -> T.DPKernelSpec:
    """#6 Overlap (suffix-prefix) alignment."""
    return _spec("overlap", C.zeros_init(1), C.zeros_init(1),
                 T.REGION_LAST_ROW_COL, T.STOP_EDGE, **kw)


def semiglobal(**kw) -> T.DPKernelSpec:
    """#7 Semi-global: query end-to-end vs a reference substring."""
    return _spec("semiglobal", C.zeros_init(1), C.linear_gap_init,
                 T.REGION_LAST_ROW, T.STOP_TOP_ROW, **kw)


def banded_global_linear(band: int = 16, **kw) -> T.DPKernelSpec:
    """#11 Banded Needleman-Wunsch (fixed band |i-j| <= W)."""
    return _spec("banded_global_linear", C.linear_gap_init,
                 C.linear_gap_init, T.REGION_CORNER, T.STOP_ORIGIN,
                 band=band, **kw)
