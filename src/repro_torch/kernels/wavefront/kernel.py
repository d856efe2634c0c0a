"""K1: the wavefront matrix-fill kernel for Hopper, its launcher and its
plain PyTorch version (port of ``repro/kernels/wavefront/kernel.py``).

``wavefront_fill`` takes a batch of pairs whose query is padded to the
32-row lane strip and whose boundary row and column are already masked by
effective length and band (``ops.run`` prepares them), and returns the
per-(pair, strip, lane) best score, its first column, and the
``('chunk', 32, pack)`` pointer store; under a sum semiring the best is the
lane's region mass folded with logaddexp.  A CUDA tensor goes to the CUDA
kernel (``csrc/wavefront_kernel.cuh``, instantiated on the gap-model
families by ``csrc/wavefront.cu``, on the others by
``csrc/wavefront_ext.cu``, and on every other PE the lowering accepts by a
translation unit ``synth.py`` generates from the spec's own torch PE,
built at the spec's first launch); a CPU tensor goes to
``wavefront_fill_plain``.  Nothing falls back from one to the other: a PE
the lowering refuses, a failed build and a failed launch raise.

The fill dispatches the operator ``repro_torch::wavefront_fill`` (see
``kernels/__init__.py``), counted by ``fill_work`` from shapes alone: the
PE operations of every padded cell (``tune/cost.py::pe_ops``) and
``k1_bytes``.  A ``DPKernelSpec`` is no type an operator's schema holds,
so the call's spec and parameters ride beside the operator in a
thread-local slot that the wrapper fills just before dispatching.
"""
from __future__ import annotations

import ctypes
import math
import numbers
import threading
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core import reference
from repro_torch.core import types as T
from repro_torch.core.spec_utils import region_mask
from repro_torch.core.traceback import pack_lanes
from repro_torch.kernels import Work, call, register_work
from repro_torch.kernels.wavefront import synth

N_PE = 32               # lanes per strip: one warp, one lane per PE
STRIP_WARPS = 8         # most warps per pair: strips in flight at once
WARPS_PER_SM = 32       # K1's resident warps per SM (64 registers a thread)
# Strip c + 1 uses column x of strip c's bottom row at wavefront x - 1,
# and strip c's lane 31 writes it at wavefront x + 30: the least number of
# wavefronts by which a strip may trail the one above it.  The CUDA code
# mirrors it (it signals a handoff chunk after wavefront
# RING_CHUNK (k + 1) + STRIP_LAG - 2) and the launch checks that the two
# agree.
STRIP_LAG = N_PE
RING_CHUNK = 16         # columns per handoff chunk (CH in the CUDA code)
TILE_STRIDE = 36        # bytes per wavefront of a warp's pointer tile
REF_PAD = 32            # slack characters each side of the staged reference
CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "wavefront.cu"          # the gap-model families
SOURCE_EXT = CSRC / "wavefront_ext.cu"  # DTW, profile, Viterbi, pair-HMM
SOURCES = (SOURCE, SOURCE_EXT)

GAP_FAMILIES = (T.FAMILY_LINEAR, T.FAMILY_AFFINE, T.FAMILY_TWO_PIECE)
FAMILY_IDS = {T.FAMILY_LINEAR: 0, T.FAMILY_AFFINE: 1, T.FAMILY_TWO_PIECE: 2}
EXT_FAMILY_IDS = {T.FAMILY_DTW: 0, T.FAMILY_PROFILE: 1, T.FAMILY_VITERBI: 2,
                  T.FAMILY_PAIRHMM_FORWARD: 3, T.FAMILY_PAIRHMM_BACKWARD: 4}
EXT_SUB_IDS = {T.SUB_COMPLEX: 0, T.SUB_ABS: 1}
OBJECTIVE_IDS = {"max": 0, "min": 1, "logsumexp": 2}
REGION_IDS = {T.REGION_CORNER: 0, T.REGION_ALL: 1, T.REGION_LAST_ROW: 2,
              T.REGION_LAST_ROW_COL: 3}
_PARAM_NAMES = ("match", "mismatch", "gap", "gap_open", "gap_extend",
                "gap_open2", "gap_extend2")
_FLOAT_PARAM_NAMES = ("log_lambda", "log_mu", "t_mm", "t_gm",
                      "gap_emission", "gap")
_F32, _I32, _U8 = torch.float32, torch.int32, torch.uint8

# What csrc/wavefront_ext.cu instantiates, per (family, sub): the score
# type, character shape and type, layer count and primary layer, and the
# (objective, region, banded) combinations.  The gap-model families
# (csrc/wavefront.cu) are int32 max-plus over byte codes at every region,
# banded or not.
_PAIRHMM = {(o, T.REGION_LAST_ROW, bd) for o in ("max", "logsumexp")
            for bd in (False, True)}
EXT_INSTANCES = {
    (T.FAMILY_DTW, T.SUB_COMPLEX): (_F32, (2,), _F32, 1, 0,
                                    {("min", T.REGION_CORNER, False)}),
    (T.FAMILY_DTW, T.SUB_ABS): (_I32, (), _I32, 1, 0,
                                {("min", T.REGION_LAST_ROW, False)}),
    (T.FAMILY_PROFILE, T.SUB_SOP): (_F32, (5,), _F32, 1, 0,
                                    {("max", T.REGION_CORNER, False)}),
    (T.FAMILY_VITERBI, T.SUB_EMISSION): (_F32, (), _U8, 3, 0,
                                         {("max", T.REGION_CORNER, False)}),
    (T.FAMILY_PAIRHMM_FORWARD, T.SUB_EMISSION): (_F32, (), _U8, 4, 3,
                                                 _PAIRHMM),
    (T.FAMILY_PAIRHMM_BACKWARD, T.SUB_EMISSION): (_F32, (), _U8, 4, 3,
                                                  _PAIRHMM),
}
_GAP_LAYERS = {T.FAMILY_LINEAR: 1, T.FAMILY_AFFINE: 3, T.FAMILY_TWO_PIECE: 5}
TABLE_SIDE = 5          # the f32 table of profile, Viterbi and pair-HMM
TABLE_PARAMS = {T.SUB_SOP: "sub_matrix", T.SUB_EMISSION: "emission"}

# CUDA kernel launches since import (or since a caller reset it to 0); the
# plain version does not count.  Service workers launch from several
# threads, so the count is taken under a lock.
launches = 0
_COUNT_LOCK = threading.Lock()


def supports(spec: T.DPKernelSpec):
    """None when K1 can fill ``spec``, else the reason it cannot: a
    hand-written functor fills it (``hand_written``), or one that
    ``synth.py`` generates from its PE (``synth.check``, cached per
    spec)."""
    if hand_written(spec) is None:
        return None
    return synth.check(spec)


def is_generated(spec: T.DPKernelSpec) -> bool:
    """Whether K1 runs ``spec`` through a functor generated from its PE
    (every spec no hand-written functor instantiates)."""
    return hand_written(spec) is not None


def hand_written(spec: T.DPKernelSpec):
    """None when a hand-written functor of ``csrc/wavefront.cu`` or
    ``csrc/wavefront_ext.cu`` fills ``spec``, else why none does."""
    fam = spec.family
    if fam is None:
        return f"kernel {spec.name} has no hand-written PE family"
    if fam.family in GAP_FAMILIES:
        if spec.objective != "max" or spec.score_dtype != _I32:
            return (f"kernel {spec.name}: K1's {fam.family} PE is int32 "
                    f"max-plus")
        want = (_GAP_LAYERS[fam.family], 0, (), _U8)
    else:
        dt, char, cdt, n_layers, primary, combos = \
            EXT_INSTANCES[(fam.family, fam.sub)]
        if spec.score_dtype != dt:
            return (f"kernel {spec.name}: K1's {fam.family} PE scores in "
                    f"{dt}, not {spec.score_dtype}")
        combo = (spec.objective, spec.region, spec.band is not None)
        if combo not in combos:
            have = ", ".join(f"{o} over {r}{' banded' if bd else ''}"
                             for o, r, bd in sorted(combos))
            return (f"kernel {spec.name}: K1 instantiates the {fam.family} "
                    f"PE as {have} only, not {combo[0]} over {combo[1]}"
                    f"{' banded' if combo[2] else ''}")
        want = (n_layers, primary, char, cdt)
    got = (spec.n_layers, spec.primary_layer, tuple(spec.char_shape),
           spec.char_dtype)
    if got != want:
        return (f"kernel {spec.name}: K1's {fam.family} PE takes (layers, "
                f"primary layer, char shape, char dtype) {want}, the spec "
                f"declares {got}")
    return None


def char_bytes(spec: T.DPKernelSpec) -> int:
    """Bytes of one staged character."""
    return math.prod(spec.char_shape) * spec.char_dtype.itemsize


def strip_warps(q_bucket: int, batch: int, sms: int) -> int:
    """Warps per pair (per thread block): up to STRIP_WARPS, halved while
    the batch's warps would exceed what ``sms`` SMs hold at once (a strip
    pipeline idles its warps for a few chunks at each end, so fewer warps
    a pair and more pairs resident fill the card better), never below 2
    where the pair has two strips."""
    c = max(1, int(q_bucket) // N_PE)
    g = min(c, STRIP_WARPS)
    while g > 2 and int(batch) * g > sms * WARPS_PER_SM:
        g //= 2
    return g


def warps_range(q_bucket: int) -> tuple:
    """The warps per pair K1 can launch at a query bucket (padded to the
    lane strip): 1 to min(STRIP_WARPS, strips), as
    ``csrc/wavefront_kernel.cuh::bad_geometry`` checks."""
    return 1, min(STRIP_WARPS, max(1, -(-int(q_bucket) // N_PE)))


def check_warps(warps, q_bucket: int) -> int:
    """An explicit ``strip_warps`` count, checked against ``warps_range``;
    raises a ValueError that names the option."""
    if isinstance(warps, bool) or not isinstance(warps, numbers.Integral):
        raise ValueError(f"option 'strip_warps' must be an integer, got "
                         f"{warps!r}")
    warps = int(warps)
    lo, hi = warps_range(q_bucket)
    if not lo <= warps <= hi:
        raise ValueError(
            f"option 'strip_warps'={warps} is outside [{lo}, {hi}] for a "
            f"query bucket of {q_bucket} ({N_PE}-row strips, at most "
            f"{STRIP_WARPS} warps a pair)")
    return warps


def ring_chunks(r_bucket: int, warps: int) -> int:
    """Slots of each handoff ring, a power of two.

    A warp runs its strips in order, so when the lowest unfinished strip
    m runs, the warp of strip m + G (G warps) is still busy with it, and
    strip m + G - 1 can hand over at most NCH chunks before it waits.  Each
    strip above m then runs at most NCH chunks ahead of the one below it
    (a strip blocked on chunk p has released the p chunks it read), so
    strip m can write G * NCH chunks: with NCH >= ceil(chunks / G) + 1 it
    never waits on a strip that cannot start.  Four slots otherwise keep
    a producer clear of its consumer."""
    chunks = -(-int(r_bucket) // RING_CHUNK)
    need = max(4, -(-chunks // warps) + 1)
    return 1 << (need - 1).bit_length()


def ring_layers(spec: T.DPKernelSpec, syn=None) -> tuple:
    """The score layers K1 carries from the row above: those the PE reads
    from the cell above or the diagonal (``PEFamily.ring_layers``, or a
    generated functor's ``UP | DIAG``; SH in csrc/wavefront_kernel.cuh).
    K1 shuffles them between lanes and holds them in the handoff rings and
    the staged init row.  ``syn``: the generated functor of the launch
    (default: the one ``synth.check`` lowered)."""
    if is_generated(spec):
        return (syn or synth.probe(spec)).ring_layers
    return spec.family.ring_layers


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def smem_bytes(spec: T.DPKernelSpec, q_bucket: int, r_bucket: int,
               warps: int, with_tb: bool = True, syn=None) -> int:
    """Dynamic shared memory of one K1 thread block (one pair), laid out
    as ``csrc/wavefront_kernel.cuh::layout``: the rings' mbarriers (full
    and empty per slot), the table (an int substitution matrix of at most
    24 x 24, the 5 x 5 f32 table of profile, Viterbi and pair-HMM, or a
    generated functor's tables and captured constants), the
    handoff rings (warps x slots x RING_CHUNK columns x ring layers, 4
    bytes each), the init row's ring layers, a 32-wavefront pointer tile
    per warp, and the pair's query and reference characters (the latter
    with REF_PAD characters each side) at ``char_bytes`` each."""
    q, r, g = int(q_bucket), int(r_bucket), int(warps)
    nch = ring_chunks(r, g)
    nu = len(ring_layers(spec, syn))
    if is_generated(spec):
        tab = (syn or synth.probe(spec)).table_words * 4
    else:
        sub = spec.family.sub
        tab = (24 * 24 * 4 if sub == T.SUB_MATRIX else
               TABLE_SIDE * TABLE_SIDE * 4
               if sub in (T.SUB_SOP, T.SUB_EMISSION) else 0)
    cb = char_bytes(spec)
    return (_align16(g * nch * 2 * 8) + _align16(tab)
            + _align16(g * nch * RING_CHUNK * nu * 4)
            + _align16((r + 1) * nu * 4)
            + (g * N_PE * TILE_STRIDE if with_tb else 0)
            + _align16(q * cb) + _align16((r + 2 * REF_PAD) * cb))


def _check_inputs(spec, query, ref, init_row, init_col, lens, tb_pack):
    reason = supports(spec)
    if reason:
        raise ValueError(reason)
    if tb_pack not in (1, 2, 4, 8):
        raise ValueError(f"tb_pack must be 1, 2, 4 or 8, got {tb_pack}")
    char = tuple(spec.char_shape)
    if query.dim() != 2 + len(char) or ref.dim() != 2 + len(char):
        raise ValueError(f"query and ref must be (batch, length) + {char}")
    B, Q = query.shape[:2]
    R = ref.shape[1]
    L = spec.n_layers
    if Q % N_PE:
        raise ValueError(f"query length {Q} is not a multiple of {N_PE}")
    if R < 1:
        raise ValueError("reference bucket must be at least 1")
    dt = spec.score_dtype
    want = {"query": (query, spec.char_dtype, (B, Q) + char),
            "ref": (ref, spec.char_dtype, (B, R) + char),
            "init_row": (init_row, dt, (B, R + 1, L)),
            "init_col": (init_col, dt, (B, Q + 1, L)),
            "lens": (lens, torch.int32, (B, 2))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != query.device:
            raise ValueError(f"{name} is on {t.device}, query on "
                             f"{query.device}")


def wavefront_fill(spec: T.DPKernelSpec, params, query, ref, init_row,
                   init_col, lens, tb_pack: int = 1, with_tb: bool = True,
                   warps=None):
    """Fill a batch of pairs.

    query (B, Q) + char_shape with Q a multiple of 32 and ref (B, R) +
    char_shape, of the spec's char dtype; init_row (B, R + 1, L) and
    init_col (B, Q + 1, L) of its score dtype, masked; lens (B, 2) int32
    effective lengths.  ``warps`` is the warps per pair (the engine's
    ``strip_warps`` option; None = the ``strip_warps`` heuristic): it only
    regroups the strips, so every count gives the same bits, and the plain
    version ignores it once it is checked.  Returns ``(tb, best,
    best_j)``: tb (B, Q/32, 32/tb_pack, 32 + R - 1) uint8 (None when
    ``with_tb`` is False), best (B, Q/32, 32) of the score dtype and best_j
    (B, Q/32, 32) int32.
    """
    _check_inputs(spec, query, ref, init_row, init_col, lens, tb_pack)
    if warps is not None:
        check_warps(warps, query.shape[1])
    if query.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not "
                         f"{query.device}")
    _CALL.spec, _CALL.params = spec, params
    try:
        tensors = (query, ref, init_row, init_col, lens)
        tb, best, best_j = call(
            torch.ops.repro_torch.wavefront_fill, _FILL, tensors, *tensors,
            int(tb_pack), bool(with_tb), None if warps is None else int(warps))
    finally:
        _CALL.spec = _CALL.params = None
    return (tb if with_tb else None), best, best_j


# the spec and parameters of the fill in flight on this thread
_CALL = threading.local()


@torch.library.custom_op("repro_torch::wavefront_fill", mutates_args=())
def _fill_op(query: torch.Tensor, ref: torch.Tensor, init_row: torch.Tensor,
             init_col: torch.Tensor, lens: torch.Tensor, tb_pack: int,
             with_tb: bool, warps: Optional[int]
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``wavefront_fill``'s operator: (tb, best, best_j), tb empty without
    ``with_tb``; the spec and parameters in ``_CALL``."""
    raise ValueError(f"K1 runs on CUDA or CPU tensors, not {query.device}")


def _fill_cpu(query, ref, init_row, init_col, lens, tb_pack, with_tb, warps):
    return wavefront_fill_plain(
        _CALL.spec, _CALL.params, query, ref, init_row, init_col, lens,
        tb_pack, with_tb)


def _fill_cuda(query, ref, init_row, init_col, lens, tb_pack, with_tb,
               warps):
    return _launch(
        _CALL.spec, _CALL.params, query.contiguous(), ref.contiguous(),
        init_row.contiguous(), init_col.contiguous(), lens.contiguous(),
        tb_pack, with_tb, warps)


def _tb_or_empty(fn):
    """``fn`` (tb None without ``with_tb``) as the operator's kernel, whose
    schema returns a tensor: an empty one for a missing store."""
    def kernel(query, *args):
        tb, best, best_j = fn(query, *args)
        return (tb if tb is not None else query.new_empty((0,), dtype=_U8),
                best, best_j)
    return kernel


_FILL = {"cpu": _fill_cpu, "cuda": _fill_cuda}
for _dev, _fn in _FILL.items():
    _fill_op.register_kernel(_dev, _tb_or_empty(_fn))


@_fill_op.register_fake
def _fill_fake(query, ref, init_row, init_col, lens, tb_pack, with_tb,
               warps):
    B, Q = query.shape[:2]
    R, C = ref.shape[1], Q // N_PE
    tb = (query.new_empty((B, C, N_PE // tb_pack, N_PE + R - 1), dtype=_U8)
          if with_tb else query.new_empty((0,), dtype=_U8))
    return (tb, query.new_empty((B, C, N_PE), dtype=_CALL.spec.score_dtype),
            query.new_empty((B, C, N_PE), dtype=_I32))


def fill_work(query, ref, init_row, init_col, lens, tb_pack, with_tb,
              warps) -> Work:
    """K1: the spec's PE operations (``tune/cost.py::pe_ops``) for every
    padded cell of the batch, int32 lanes for integer scores and the CUDA
    cores' f32 otherwise, and the bytes of ``tune/cost.py::k1_bytes``.
    Cells past a pair's lengths or outside its band count too, so for a
    ragged or banded batch the count is an upper bound."""
    from repro_torch.tune.cost import k1_bytes, pe_ops
    spec = _CALL.spec
    B, Q, R = query.shape[0], query.shape[1], ref.shape[1]
    key = "int32" if spec.score_dtype == _I32 else "f32"
    return Work({key: pe_ops(spec, _CALL.params) * B * Q * R},
                k1_bytes(spec, B, Q, R, tb_pack, with_tb))


register_work(_fill_op, fill_work)


_LIBS: dict = {}


def _lib(source=SOURCE):
    """The loaded library of one K1 source, built at its first use."""
    lib = _LIBS.get(source)
    if lib is None:
        from repro_torch.kernels import build
        lib = build.load(source).lib
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if source == SOURCE:
            lib.wavefront_fill_launch.argtypes = (
                [i] * 5 + [p] * 6 + [i] + [i] * 7 + [p] * 3 + [i] * 9 + [p])
            lib.wavefront_fill_launch.restype = i
        else:
            lib.wavefront_ext_fill_launch.argtypes = (
                [i] * 5 + [p] * 6 + [i] + [f] * 6 + [p] * 3 + [i] * 9 + [p])
            lib.wavefront_ext_fill_launch.restype = i
        lib.wavefront_max_smem.argtypes = [i]
        lib.wavefront_max_smem.restype = i
        _LIBS[source] = lib
    return lib


def _table(params, name, dev):
    tab = params[name].to(device=dev, dtype=torch.float32).contiguous()
    if tuple(tab.shape) != (TABLE_SIDE, TABLE_SIDE):
        raise ValueError(f"{name} must be {TABLE_SIDE} x {TABLE_SIDE}, got "
                         f"{tuple(tab.shape)}")
    return tab


_GEN_LIBS: dict = {}
_GEN_LOCK = threading.Lock()


def generated_lib(syn):
    """``(library, build)`` of a generated functor, built at its first use
    in this process (nvcc, or the content-keyed library a build left)."""
    with _GEN_LOCK:
        hit = _GEN_LIBS.get(syn.digest)
    if hit is None:
        from repro_torch.kernels import build
        built = build.load(syn.write(), include_dirs=(CSRC,))
        lib = built.lib
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wavefront_gen_fill_launch.argtypes = (
            [i] + [p] * 6 + [i] + [p, i] + [p] * 3 + [i] * 9 + [p])
        lib.wavefront_gen_fill_launch.restype = i
        lib.wavefront_max_smem.argtypes = [i]
        lib.wavefront_max_smem.restype = i
        hit = (lib, built)
        with _GEN_LOCK:
            _GEN_LIBS[syn.digest] = hit
    return hit


def source_of(spec: T.DPKernelSpec, params=None):
    """The CUDA source K1 builds for ``spec``: ``SOURCE`` or
    ``SOURCE_EXT`` for a hand-written functor, else the generated
    translation unit of ``params``' signature (None without ``params`` or
    where the lowering refuses)."""
    if not is_generated(spec):
        return SOURCE if spec.family.family in GAP_FAMILIES else SOURCE_EXT
    if params is None:
        return None
    try:
        return synth.lower(spec, params).path()
    except synth.Refused:
        return None


def _launch(spec, params, query, ref, init_row, init_col, lens, tb_pack,
            with_tb, warps=None):
    global launches
    fam = spec.family
    gen = synth.lower(spec, params) if is_generated(spec) else None
    if gen is not None:
        lib = generated_lib(gen)[0]
    else:
        lib = _lib(SOURCE if fam.family in GAP_FAMILIES else SOURCE_EXT)
    dev = query.device
    B, Q = query.shape[:2]
    R = ref.shape[1]
    C = Q // N_PE
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    limit = lib.wavefront_max_smem(index)
    explicit = warps is not None
    if not explicit:
        warps = strip_warps(Q, B, torch.cuda.get_device_properties(
            index).multi_processor_count)
    need = smem_bytes(spec, Q, R, warps, with_tb, gen)
    if need > limit:
        raise ValueError(
            f"kernel {spec.name}: reference bucket {R} at "
            f"{'option ' if explicit else ''}'strip_warps'={warps} needs "
            f"{need} bytes of shared memory per block; this device allows "
            f"{limit}")
    # the kernel writes every byte of the store, zeros included
    tb = (torch.empty((B, C, N_PE // tb_pack, N_PE + R - 1),
                      dtype=torch.uint8, device=dev) if with_tb else None)
    best = torch.empty((B, C, N_PE), dtype=spec.score_dtype, device=dev)
    best_j = torch.empty((B, C, N_PE), dtype=torch.int32, device=dev)
    band = -1 if spec.band is None else int(spec.band)
    data = (query.data_ptr(), ref.data_ptr(), init_row.data_ptr(),
            init_col.data_ptr(), lens.data_ptr())
    outs = (tb.data_ptr() if with_tb else None, best.data_ptr(),
            best_j.data_ptr())
    geometry = (B, Q, R, tb_pack, int(with_tb), warps,
                ring_chunks(R, warps).bit_length() - 1, STRIP_LAG,
                RING_CHUNK)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if gen is not None:
            slots, table = gen.pack(params, dev)
            arr = (ctypes.c_longlong * max(1, len(slots)))(*slots)
            err = lib.wavefront_gen_fill_launch(
                band, *data, table.data_ptr() if table is not None else None,
                gen.table_words, arr, len(slots), *outs, *geometry, stream)
        elif fam.family in GAP_FAMILIES:
            matrix = fam.sub == T.SUB_MATRIX
            sub = (params["sub"].to(device=dev, dtype=torch.int32)
                   .contiguous() if matrix else None)
            n_sub = sub.shape[0] if matrix else 0
            if matrix and (sub.dim() != 2 or sub.shape != (n_sub, n_sub)
                           or n_sub > 24):
                raise ValueError("substitution matrix must be square, at "
                                 "most 24")
            vals = [int(params.get(k, 0)) for k in _PARAM_NAMES]
            err = lib.wavefront_fill_launch(
                FAMILY_IDS[fam.family], int(matrix), int(fam.local),
                REGION_IDS[spec.region], band, *data,
                sub.data_ptr() if matrix else None, n_sub, *vals, *outs,
                *geometry, stream)
        else:
            name = TABLE_PARAMS.get(fam.sub)
            tab = _table(params, name, dev) if name else None
            vals = [float(params.get(k, 0.0)) for k in _FLOAT_PARAM_NAMES]
            err = lib.wavefront_ext_fill_launch(
                EXT_FAMILY_IDS[fam.family], EXT_SUB_IDS.get(fam.sub, 0),
                OBJECTIVE_IDS[spec.objective], REGION_IDS[spec.region],
                band, *data, tab.data_ptr() if name else None,
                TABLE_SIDE if name else 0, *vals, *outs, *geometry, stream)
    if err:
        raise RuntimeError(f"K1 wavefront_fill launch failed: CUDA error "
                           f"{err} (kernel {spec.name}, Q={Q}, R={R}, "
                           f"batch {B})")
    with _COUNT_LOCK:
        launches += 1
    return tb, best, best_j


def wavefront_fill_plain(spec: T.DPKernelSpec, params, query, ref, init_row,
                         init_col, lens, tb_pack: int = 1,
                         with_tb: bool = True, warps=None):
    """Plain PyTorch version of ``wavefront_fill``: same arguments (``warps``
    ignored: it only regroups the kernel's strips), same
    outputs (bit for bit where the PE's arithmetic is exact: integer
    scores, and the max/min float families, whose plain PEs round as the
    functors do; the logsumexp fold uses torch.logaddexp).

    It fills the matrix with the reference engine's sweep
    (``core/reference.py::sweep``), reduces each row over the objective
    region and rearranges the pointers into the ``('chunk', 32, pack)``
    store.  A row's best is its first optimum in j order, as the kernel's
    strict better-than keeps it: column 0, outside every region, holds
    the sentinel, so a row with nothing better keeps the sentinel and
    column 0.  Under a sum semiring a row folds its region mass with
    ``spec.combine``, j ascending, as each lane of the kernel does.
    """
    B, Q = query.shape[:2]
    R = ref.shape[1]
    dev = query.device
    sent = spec.sentinel()
    q_len, r_len = lens[:, 0], lens[:, 1]
    mat, ptrs = reference.sweep(spec, params, query, ref, init_row,
                                init_col, q_len, r_len)
    ii = torch.arange(1, Q + 1, dtype=torch.int32, device=dev)[:, None]
    jj = torch.arange(R + 1, dtype=torch.int32, device=dev)[None, :]
    region = region_mask(spec, ii, jj, q_len[:, None, None],
                         r_len[:, None, None])                 # (B, Q, R+1)
    cand = torch.where(region, mat[:, 1:, :, spec.primary_layer], sent)
    if spec.is_sum:
        best = cand[..., 0]
        for j in range(1, R + 1):
            best = torch.where(region[..., j],
                               spec.combine(best, cand[..., j]), best)
        best_j = torch.zeros((B, Q), dtype=torch.int32, device=dev)
    else:
        k = spec.arg_best(cand, axis=2)
        best = cand.gather(2, k[..., None])[..., 0]
        best_j = k.to(torch.int32)

    C = Q // N_PE
    tb = None
    if with_tb:
        WT = N_PE + R - 1
        lanes = ptrs[:, 1:, 1:].reshape(B, C, N_PE, R)
        store = torch.zeros((B, C, N_PE, WT), dtype=torch.uint8, device=dev)
        for lane in range(N_PE):
            store[:, :, lane, lane:lane + R] = lanes[:, :, lane]
        tb = pack_store(store, tb_pack)
    return tb, best.reshape(B, C, N_PE), best_j.reshape(B, C, N_PE)


def pack_store(store, tb_pack: int):
    """A ``('chunk', 32)`` pointer store (B, C, 32, 32 + R - 1) uint8 with
    ``tb_pack`` lanes packed into each byte, as ``wavefront_fill`` writes it
    at that ``tb_pack``: (B, C, 32 // tb_pack, 32 + R - 1)."""
    return pack_lanes(store.transpose(2, 3), tb_pack).transpose(2, 3) \
        .contiguous()


def unpack_store(tb, tb_pack: int):
    """The inverse of ``pack_store``: a ``('chunk', 32, tb_pack)`` store
    (B, C, 32 // tb_pack, W) -> the unpacked (B, C, 32, W), one pointer a
    byte."""
    if tb_pack == 1:
        return tb
    width = 8 // tb_pack
    slots = [(tb >> (s * width)) & ((1 << width) - 1) for s in range(tb_pack)]
    B, C, n, W = tb.shape
    return torch.stack(slots, dim=3).reshape(B, C, n * tb_pack, W)
