"""Kernels #5 (global two-piece affine) and #13 (banded global two-piece
affine) — minimap2's dual gap model, N_LAYERS=5."""
from __future__ import annotations

from .. import types as T
from . import common as C


def default_params(match=2, mismatch=-4, gap_open=-4, gap_extend=-2,
                   gap_open2=-24, gap_extend2=-1):
    return {"match": int(match), "mismatch": int(mismatch),
            "gap_open": int(gap_open), "gap_extend": int(gap_extend),
            "gap_open2": int(gap_open2), "gap_extend2": int(gap_extend2)}


def _spec(name, **kw):
    return T.DPKernelSpec(
        name=name, n_layers=5, pe=C.two_piece_pe(C.dna_sub),
        init_row=C.two_piece_init_row, init_col=C.two_piece_init_col,
        region=T.REGION_CORNER, traceback=C.two_piece_tb(T.STOP_ORIGIN),
        ptr_bits=C.TWO_PIECE_PTR_BITS,
        family=T.PEFamily(T.FAMILY_TWO_PIECE, T.SUB_DNA, False), **kw)


def global_two_piece(**kw) -> T.DPKernelSpec:
    """#5."""
    return _spec("global_two_piece", **kw)


def banded_global_two_piece(band: int = 16, **kw) -> T.DPKernelSpec:
    """#13."""
    return _spec("banded_global_two_piece", band=band, **kw)
