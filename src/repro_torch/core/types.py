"""Core datatypes of the port (counterpart of ``repro.core.types``).

A DP kernel is declared as (alphabet, scoring layers, parameters, init, PE
function, traceback FSM, banding).  The PE, init and FSM callables here work
on tensors with a leading lane axis (PyTorch's idiom for the cells JAX
vmaps).  A hand-written kernel cannot call them, so each spec also carries a
``PEFamily`` tag that the CUDA dispatch keys on; the callables are then the
plain versions of what the kernel's functors compute.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from . import semiring as semiring_mod

# Traceback moves (the AL_* codes of the paper's Listing 7).
MOVE_END = 0   # traceback terminates at this cell
MOVE_DIAG = 1  # consume one query + one reference char (match/mismatch)
MOVE_UP = 2    # consume one query char (deletion w.r.t. reference)
MOVE_LEFT = 3  # consume one reference char (insertion w.r.t. reference)

MOVE_NAMES = {MOVE_END: "END", MOVE_DIAG: "M", MOVE_UP: "D", MOVE_LEFT: "I"}

# Objective-region selectors.
REGION_CORNER = "corner"              # global: score at (q_len, r_len)
REGION_ALL = "all"                    # local: best anywhere
REGION_LAST_ROW = "last_row"          # semi-global: best in the last row
REGION_LAST_ROW_COL = "last_row_col"  # overlap: best in last row or column
REGIONS = (REGION_CORNER, REGION_ALL, REGION_LAST_ROW, REGION_LAST_ROW_COL)

# Traceback stop conditions.
STOP_ORIGIN = "origin"      # stop at (0, 0)            (global)
STOP_TOP_ROW = "top_row"    # stop when i == 0          (semi-global)
STOP_EDGE = "edge"          # stop when i == 0 or j == 0 (overlap)
STOP_PTR_END = "ptr_end"    # stop only on an END pointer (local)

INT_SENTINEL = 1 << 30      # magnitude of the int 'unreachable' score
FLOAT_SENTINEL = 1e30       # magnitude of the float 'unreachable' score

# PE families a compiled kernel implements (see ``PEFamily``).
FAMILY_LINEAR = "linear"
FAMILY_AFFINE = "affine"
FAMILY_TWO_PIECE = "two_piece"
FAMILY_DTW = "dtw"                          # min objective, #9 and #14
FAMILY_PROFILE = "profile"                  # sum-of-pairs columns, #8
FAMILY_VITERBI = "viterbi"                  # 3-state M/I/D, #10
FAMILY_PAIRHMM_FORWARD = "pairhmm_forward"  # prob.kernels.pairhmm
FAMILY_PAIRHMM_BACKWARD = "pairhmm_backward"
SUB_DNA = "dna"              # match / mismatch scalars
SUB_MATRIX = "matrix"        # int substitution matrix
SUB_COMPLEX = "complex"      # |q0 - r0| + |q1 - r1| of (2,) f32 samples
SUB_ABS = "abs"              # |q - r| of int32 samples
SUB_SOP = "sop"              # q @ S @ r of (5,) f32 profile columns
SUB_EMISSION = "emission"    # 5 x 5 f32 log-emission table

# family -> (substitution kinds it takes, layers read from the diagonal,
# from the cell above, from the cell to the left)
_FAMILIES = {
    FAMILY_LINEAR: ((SUB_DNA, SUB_MATRIX), (0,), (0,), (0,)),
    FAMILY_AFFINE: ((SUB_DNA, SUB_MATRIX), (0,), (0, 2), (0, 1)),
    FAMILY_TWO_PIECE: ((SUB_DNA, SUB_MATRIX), (0,), (0, 2, 4), (0, 1, 3)),
    FAMILY_DTW: ((SUB_COMPLEX, SUB_ABS), (0,), (0,), (0,)),
    FAMILY_PROFILE: ((SUB_SOP,), (0,), (0,), (0,)),
    FAMILY_VITERBI: ((SUB_EMISSION,), (0, 1, 2), (0, 2), (0, 1)),
    FAMILY_PAIRHMM_FORWARD: ((SUB_EMISSION,), (0, 1, 2), (0, 1), (0, 2)),
    FAMILY_PAIRHMM_BACKWARD: ((SUB_EMISSION,), (0,), (1,), (2,)),
}


@dataclasses.dataclass(frozen=True)
class PEFamily:
    """Which compiled PE functor computes a spec's ``pe``: the recurrence
    (``family``), the substitution score (``sub``) and whether scores
    clamp at zero (``local``, linear and affine only).  The semiring, the
    score type and the primary layer come from the spec itself.

    ``diag_layers``, ``up_layers`` and ``left_layers`` are the score
    layers the PE reads from each neighbour; a compiled kernel carries
    ``ring_layers`` (up and diagonal) from one row to the next."""
    family: str
    sub: str
    local: bool = False

    def __post_init__(self):
        if self.family not in _FAMILIES:
            raise ValueError(f"unknown PE family {self.family!r}")
        if self.sub not in _FAMILIES[self.family][0]:
            raise ValueError(f"PE family {self.family!r} does not take "
                             f"substitution kind {self.sub!r}")
        if self.local and self.family not in (FAMILY_LINEAR, FAMILY_AFFINE):
            raise ValueError(f"the {self.family} PE has no local variant")

    @property
    def diag_layers(self) -> tuple:
        return _FAMILIES[self.family][1]

    @property
    def up_layers(self) -> tuple:
        return _FAMILIES[self.family][2]

    @property
    def left_layers(self) -> tuple:
        return _FAMILIES[self.family][3]

    @property
    def ring_layers(self) -> tuple:
        return tuple(sorted(set(self.up_layers) | set(self.diag_layers)))


@dataclasses.dataclass(frozen=True)
class TracebackSpec:
    """Traceback FSM declaration.  ``fsm(state, ptr) -> (move, next_state)``
    works elementwise on int tensors of one shape."""
    n_states: int
    fsm: Callable[[Any, Any], tuple]
    stop: str = STOP_ORIGIN
    initial_state: int = 0

    def stop_fn(self, i, j):
        if self.stop in (STOP_ORIGIN, STOP_PTR_END):
            # local kernels stop on an END pointer; the origin is a safety net
            return (i == 0) & (j == 0)
        if self.stop == STOP_TOP_ROW:
            return i == 0
        if self.stop == STOP_EDGE:
            return (i == 0) | (j == 0)
        raise ValueError(f"unknown stop condition {self.stop!r}")


@dataclasses.dataclass(frozen=True)
class DPKernelSpec:
    """A 2-D DP kernel declaration (see ``repro.core.types.DPKernelSpec``).

    ``pe(params, q, r, diag, up, left, i, j) -> (scores, ptr)`` takes ``(N,)``
    chars and indices and ``(N, n_layers)`` neighbour scores, and returns
    ``(N, n_layers)`` scores and ``(N,)`` pointers.  ``init_row(params, j)``
    returns ``(len(j), n_layers)``.  ``family`` names the compiled PE functor
    (None: no kernel implements this spec yet).
    """
    name: str
    n_layers: int
    pe: Callable
    init_row: Callable
    init_col: Callable
    objective: str = "max"
    region: str = REGION_CORNER
    score_dtype: Any = torch.int32
    char_shape: tuple = ()
    char_dtype: Any = torch.uint8
    traceback: Optional[TracebackSpec] = None
    band: Optional[int] = None
    primary_layer: int = 0
    ptr_bits: int = 8
    family: Optional[PEFamily] = None

    def __post_init__(self):
        if not 1 <= self.ptr_bits <= 8:
            raise ValueError(f"ptr_bits must be in [1, 8], got {self.ptr_bits}")
        if self.region not in REGIONS:
            raise ValueError(f"unknown region {self.region!r}")
        sr = semiring_mod.from_objective(self.objective)
        if not sr.selective:
            if not self.score_dtype.is_floating_point:
                raise ValueError(
                    f"kernel {self.name}: sum semiring ({self.objective}) "
                    f"requires a floating score_dtype, got {self.score_dtype}")
            if self.traceback is not None:
                raise ValueError(
                    f"kernel {self.name}: sum-semiring cells hold total "
                    "path mass — no single path exists to trace back")

    @property
    def semiring(self) -> semiring_mod.Semiring:
        return semiring_mod.from_objective(self.objective)

    @property
    def is_sum(self) -> bool:
        return not self.semiring.selective

    @property
    def tb_pack(self) -> int:
        """Pointers per traceback byte: the largest power of two whose slot
        width (8 // pack) still holds ``ptr_bits``."""
        pack = 1
        while pack * 2 <= 8 and 8 // (pack * 2) >= self.ptr_bits:
            pack *= 2
        return pack

    @property
    def is_min(self) -> bool:
        return self.objective == "min"

    def sentinel(self):
        """The 'invalid / unreachable' score, as a Python int or float."""
        mag = (FLOAT_SENTINEL if self.score_dtype.is_floating_point
               else INT_SENTINEL)
        return mag if self.is_min else -mag

    def better(self, a, b):
        """a strictly better than b under the objective."""
        return (a < b) if self.is_min else (a > b)

    def reduce_best(self, x, axis=None):
        return self.semiring.reduce(x, axis=axis)

    def arg_best(self, x, axis=None):
        return self.semiring.arg(x, axis=axis)

    def combine(self, a, b):
        return self.semiring.combine(a, b)


@dataclasses.dataclass
class DPResult:
    """Matrix-fill output: optimum, its end cell and the pointer store.

    Fields carry a leading batch axis where the engine ran a batch.
    ``tb_layout`` names the store's layout (``('chunk', n_pe[, pack])`` for
    the wavefront kernel); ``tb`` is None for score-only fills."""
    score: Any
    end_i: Any
    end_j: Any
    tb: Any = None
    tb_layout: Any = "diag"
    matrix: Any = None


@dataclasses.dataclass
class Alignment:
    """Final alignment: score, end/start cells and the move string
    (``moves`` in end -> start order, ``n_moves`` long).  ``truncated`` is
    True where the walk ran out of its step budget."""
    score: Any
    end_i: Any
    end_j: Any
    start_i: Any = None
    start_j: Any = None
    moves: Any = None
    n_moves: Any = None
    truncated: Any = None
