"""Kernel declarations, traceback and the public alignment API of the port
(counterpart of ``repro.core``).

Front end: ``DPKernelSpec`` (and the ``kernels_zoo`` registry of the
paper's kernels).  Back ends: the engines of ``repro_torch.runtime``
(``reference``, ``wavefront`` on kernel K1, ``banded``, ``myers`` on K2);
K1 takes any PE its lowering accepts (``kernels/wavefront/synth.py``).
Every public name of ``repro.core`` is here.
"""
from .types import (Alignment, DPKernelSpec, DPResult, TracebackSpec,
                    MOVE_DIAG, MOVE_END, MOVE_LEFT, MOVE_UP,
                    REGION_ALL, REGION_CORNER, REGION_LAST_ROW,
                    REGION_LAST_ROW_COL, STOP_EDGE, STOP_ORIGIN,
                    STOP_PTR_END, STOP_TOP_ROW)
from .api import align, fill, score_only
from .semiring import LOG_SUM_EXP, MAX_PLUS, MIN_PLUS, Semiring
from . import alphabets, kernels_zoo, semiring, traceback

__all__ = [
    "Alignment", "DPKernelSpec", "DPResult", "TracebackSpec",
    "MOVE_DIAG", "MOVE_END", "MOVE_LEFT", "MOVE_UP",
    "REGION_ALL", "REGION_CORNER", "REGION_LAST_ROW", "REGION_LAST_ROW_COL",
    "STOP_EDGE", "STOP_ORIGIN", "STOP_PTR_END", "STOP_TOP_ROW",
    "LOG_SUM_EXP", "MAX_PLUS", "MIN_PLUS", "Semiring",
    "align", "fill", "score_only", "alphabets", "kernels_zoo", "semiring",
    "traceback",
]
