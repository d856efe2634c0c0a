"""Kernels #2 (global affine / Gotoh), #4 (local affine / SWG), #12
(banded local affine, no traceback) and the mapper's semi-global Gotoh —
affine gap penalty, N_LAYERS=3."""
from __future__ import annotations

from .. import types as T
from . import common as C


def default_params(match=2, mismatch=-3, gap_open=-5, gap_extend=-1):
    return {"match": int(match), "mismatch": int(mismatch),
            "gap_open": int(gap_open), "gap_extend": int(gap_extend)}


def global_affine(**kw) -> T.DPKernelSpec:
    """#2 Gotoh."""
    return T.DPKernelSpec(
        name="global_affine", n_layers=3, pe=C.affine_pe(C.dna_sub),
        init_row=C.affine_init_row, init_col=C.affine_init_col,
        region=T.REGION_CORNER, traceback=C.affine_tb(T.STOP_ORIGIN),
        ptr_bits=C.AFFINE_PTR_BITS,
        family=T.PEFamily(T.FAMILY_AFFINE, T.SUB_DNA, False), **kw)


def local_affine(**kw) -> T.DPKernelSpec:
    """#4 Smith-Waterman-Gotoh."""
    return T.DPKernelSpec(
        name="local_affine", n_layers=3,
        pe=C.affine_pe(C.dna_sub, local=True),
        init_row=C.local_affine_init, init_col=C.local_affine_init,
        region=T.REGION_ALL, traceback=C.affine_tb(T.STOP_PTR_END),
        ptr_bits=C.AFFINE_PTR_BITS,
        family=T.PEFamily(T.FAMILY_AFFINE, T.SUB_DNA, True), **kw)


def semiglobal_affine(**kw) -> T.DPKernelSpec:
    """Semi-global Gotoh: the query end to end against a reference substring
    with affine gaps, the read mapper's extension under ``gap_mode='affine'``.
    Row 0 is the free start along the reference (zero H, dead gap layers)."""
    return T.DPKernelSpec(
        name="semiglobal_affine", n_layers=3, pe=C.affine_pe(C.dna_sub),
        init_row=C.local_affine_init, init_col=C.affine_init_col,
        region=T.REGION_LAST_ROW, traceback=C.affine_tb(T.STOP_TOP_ROW),
        ptr_bits=C.AFFINE_PTR_BITS,
        family=T.PEFamily(T.FAMILY_AFFINE, T.SUB_DNA, False), **kw)


def banded_local_affine(band: int = 16, **kw) -> T.DPKernelSpec:
    """#12 Banded SWG, score-only (no traceback)."""
    return T.DPKernelSpec(
        name="banded_local_affine", n_layers=3,
        pe=C.affine_pe(C.dna_sub, local=True),
        init_row=C.local_affine_init, init_col=C.local_affine_init,
        region=T.REGION_ALL, band=band, traceback=None,
        family=T.PEFamily(T.FAMILY_AFFINE, T.SUB_DNA, True), **kw)
