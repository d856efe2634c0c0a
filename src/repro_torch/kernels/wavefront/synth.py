"""K1's PE synthesis: a spec's PyTorch PE, lowered to the PE functor of
K1's CUDA template (``csrc/wavefront_kernel.cuh``).

The Pallas kernel takes any PE: it vmaps ``spec.pe`` and traces it into the
TPU kernel (``repro/kernels/wavefront/kernel.py``).  Its counterpart here
traces the PE with ``make_fx`` on fake CPU tensors and writes the aten
graph out as a C++ functor to the template's contract, so that a kernel a
user declares in a few lines of torch runs on the card through a K1
instantiation generated from its own PE.  The hand-written functors of
``csrc/wavefront.cu`` and ``csrc/wavefront_ext.cu`` stay for the specs
they instantiate; ``kernel.py`` routes every other spec here.

Tracing.  Numeric parameters enter as 0-d tensors (a Python int as int64,
a float as float32, a bool as bool), so that their values are launch
arguments (the functor's ``Slots``) and not constants of the build;
parameters of one or more dimensions are tables of at most 24 x 24 entries
that the kernel stages in shared memory beside any constant tensor the PE
captures.  ``q`` and ``r`` are ``(N,)`` tensors of the spec's character
type, ``diag``, ``up`` and ``left`` three distinct ``(N, n_layers)``
tensors of its score type, ``i`` and ``j`` int32 ``(N,)``.  The PE is
traced at two lane counts and must give the same graph both times, so
that dim 0 is the lane of every value.  A branch on data fails the trace;
the refusal carries the trace's error.  Every aten op the graph holds must
be one the lowering knows (``OPS``); a refusal names the op and the PE's
source line.

Semantics.  Each value keeps the dtype the trace recorded for it
(``node.meta["val"]``), and the emitted C follows torch's CPU semantics op
by op: an explicit cast after each op (uint8 wraps at 256, ``.long()`` is
64-bit), int32 and int64 add, sub, mul and neg through unsigned arithmetic
(a wrap, as torch's, not undefined behaviour), integer ``floor_divide``
and ``remainder`` with floor semantics (by a positive power of two, a
shift and a mask), ``maximum``/``minimum``/``clamp`` that propagate NaN,
f32 ``+``, ``-``, ``*`` as ``__f*_rn`` (nvcc contracts no FMA),
``logaddexp`` as the template's ``log_add_exp`` with torch's guard for
two equal infinities, shifts by torch's rules.  A table
index wraps once below zero and clamps into the table, where torch would
raise.  Dead values are dropped (the functor computes only what its
outputs need), and the layers of ``up`` and ``diag`` left standing are
its ``UP`` and ``DIAG`` masks: the layers K1 carries from row to row.

Scope.  Scalar characters (uint8 or int32 codes, f32 samples), int32 or
f32 scores, the max, min and logsumexp objectives, values of bool, uint8,
int32, int64 or f32 (float64 and 8- or 16-bit signed values are refused,
as are division on floats and reshapes other than ``unsqueeze``).  A PE
over vector characters (zoo #8 and #9) is refused by name.

Operation count.  ``Synth.ops`` counts what one cell needs: one for each
live statement, except a cast within ints or within floats (none), an
integer division or remainder by a literal power of two (one: a shift or
a mask), by another literal (``CONST_DIV_OPS``: a multiply-high by a
magic number, a shift and the floor fix-up) or by a value known only at
run time (``DIV_OPS``: the CUDA C++ Programming Guide puts an integer
division or modulo at up to 20 instructions), an exp or log
(``TRANSCENDENTAL_OPS``) and a logaddexp (``LAE_OPS``).

``lower(spec, params)`` gives the ``Synth`` of one parameter signature
(keys, kinds, table shapes and dtypes; never values), cached;
``check(spec)`` lowers with probe parameters (keys found by running the
PE, a key the PE indexes taken as a table) and gives None or the reason
K1 cannot run the spec, cached per spec.  Importing this module builds
nothing; ``Synth.write`` puts the translation unit under
``build/repro_torch/gen/`` and ``kernel.py`` builds it at the spec's first
launch on the card.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import struct
import threading
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.core import types as T

MAX_SLOTS = 32          # scalar parameters a functor reads (Slots in C)
MAX_TABLE = 24 * 24     # entries of one table
MAX_TABLES = 4          # tables (parameters and captured constants)
MAX_LAYERS = 16
LANES = (37, 41)        # the two lane counts the PE is traced at
PROBE_SIDE = 24         # side of a probe table (see ``check``)

DIV_OPS = 20            # an integer division by a run-time value
CONST_DIV_OPS = 4       # ... by a literal other than a power of two
TRANSCENDENTAL_OPS = 4  # an exp, log or log1p
LAE_OPS = 5             # a logaddexp

_CTYPE = {torch.bool: "bool", torch.uint8: "uint8_t", torch.int32: "int",
          torch.int64: "long long", torch.float32: "float"}
_WRAP = {torch.int32: "unsigned", torch.int64: "unsigned long long"}
_BITS = {torch.bool: 1, torch.uint8: 8, torch.int32: 32, torch.int64: 64}
CHAR_DTYPES = (torch.uint8, torch.int32, torch.float32)
SCORE_DTYPES = (torch.int32, torch.float32)
OBJECTIVES = {"max": "OBJ_MAX", "min": "OBJ_MIN", "logsumexp": "OBJ_LSE"}
REGION_IDS = {T.REGION_CORNER: 0, T.REGION_ALL: 1, T.REGION_LAST_ROW: 2,
              T.REGION_LAST_ROW_COL: 3}
GEN_DIR_NAME = "gen"
_TORCH_DIR = str(Path(torch.__file__).resolve().parent)


class Refused(ValueError):
    """K1 cannot lower this spec's PE; the message says why."""


# ---------------------------------------------------------------------------
# C expressions
class Cx:
    """One C value of the functor: a leaf (an input, a slot, a literal) or
    a statement ``const <type> v<id> = <code>;`` over earlier values."""
    __slots__ = ("id", "dtype", "code", "deps", "leaf", "weight", "tag",
                 "const")

    def __init__(self, id_, dtype, code, deps=(), leaf=False, weight=1,
                 tag=None, const=None):
        self.id, self.dtype, self.code = id_, dtype, code
        self.deps, self.leaf, self.weight, self.tag = tuple(deps), leaf, \
            weight, tag
        self.const = const      # a literal's value, else None

    @property
    def ref(self) -> str:
        return self.code if self.leaf else f"v{self.id}"


def _as_dtype(v, dtype):
    """Python value ``v`` as ``dtype`` holds it: an int wrapped to its
    width, a float rounded to float32 (a Python float, a weak scalar of
    torch's, stays a double)."""
    if dtype == torch.bool:
        return bool(v)
    if dtype.is_floating_point:
        return float(np.float32(v)) if dtype == torch.float32 else float(v)
    if dtype == torch.uint8:
        return int(v) & 0xFF
    bits = _BITS[dtype]
    return (int(v) + (1 << (bits - 1))) % (1 << bits) - (1 << (bits - 1))


def _literal(v, dtype) -> str:
    """C literal of ``v`` as ``dtype``; float64 only for torch's weak
    Python-float scalars, which are cast before any op reads them."""
    v = _as_dtype(v, dtype)
    if dtype == torch.bool:
        return "true" if v else "false"
    if dtype.is_floating_point:
        f32 = dtype == torch.float32
        if math.isnan(v):
            return ("__int_as_float(0x7fc00000)" if f32 else
                    "__longlong_as_double(0x7ff8000000000000LL)")
        if math.isinf(v):
            pos = ("__int_as_float(0x7f800000)" if f32 else
                   "__longlong_as_double(0x7ff0000000000000LL)")
            return pos if v > 0 else f"(-{pos})"
        return f"({v.hex()}f)" if f32 else f"({v.hex()})"
    if dtype == torch.int64 and v == -(1 << 63):
        return "(-9223372036854775807LL - 1)"
    return f"(({_CTYPE[dtype]}){v}LL)" if dtype == torch.int64 \
        else f"(({_CTYPE[dtype]}){v})"


class V:
    """A graph value: ``lane`` values carry dim 0 as the lane and ``el``
    over their inner shape; others ``el`` over their whole shape.  A table
    (a parameter or captured constant of 1+ dims, or elementwise over one
    and scalars) also has ``lazy(k)``: its element at a flat index value
    ``k``, for indexing by lane values."""

    def __init__(self, dtype, lane, shape, el=None, lazy=None, weak=None,
                 lo=None):
        self.dtype, self.lane, self.shape = dtype, lane, tuple(shape)
        self._el, self.lazy, self.weak, self.lo = el, lazy, weak, lo

    @property
    def el(self):
        if self._el is None:
            n = int(np.prod(self.shape)) if self.shape else 1
            flat = np.empty(n, dtype=object)
            for k in range(n):
                flat[k] = self.lazy(self.lo.lit(k, torch.int32))
            self._el = flat.reshape(self.shape)
        return self._el


def _arr(x):
    """``x`` as an object array (a lone value as a 0-d one)."""
    if isinstance(x, np.ndarray):
        return x
    a = np.empty((), dtype=object)
    a[()] = x
    return a


def _frame_of(tb_or_stack) -> Optional[str]:
    """``file:line`` of the innermost frame outside torch and this
    module."""
    for fr in reversed(tb_or_stack):
        f = str(fr.filename)
        if f.startswith(_TORCH_DIR) or f == __file__ or "<" in f:
            continue
        return f"{f}:{fr.lineno}"
    return None


# ---------------------------------------------------------------------------
# parameters
def _kind(v):
    if isinstance(v, bool):
        return ("bool",)
    if isinstance(v, int):
        return ("int",)
    if isinstance(v, float):
        return ("float",)
    if isinstance(v, torch.Tensor):
        return ("tensor", str(v.dtype), tuple(v.shape))
    if isinstance(v, np.ndarray) or isinstance(v, np.generic):
        return ("array", str(v.dtype), tuple(np.shape(v)))
    return ("const", repr(v))


def signature(params) -> tuple:
    """What a ``Synth`` depends on in ``params``: keys, kinds and table
    shapes and dtypes, never values."""
    return tuple(sorted((str(k), _kind(v)) for k, v in params.items()))


def _as_tensor(v):
    """A numeric parameter as the tensor the PE is traced with, or None
    for a value that stays a Python constant."""
    if isinstance(v, bool):
        return torch.tensor(v)
    if isinstance(v, int):
        return torch.tensor(v, dtype=torch.int64)
    if isinstance(v, float):
        return torch.tensor(v, dtype=torch.float32)
    if isinstance(v, (np.ndarray, np.generic)):
        v = torch.as_tensor(np.asarray(v))
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu")
    return None


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Synth:
    """One generated PE functor and what its launch needs.

    ``slots``: (key, dtype) of each scalar parameter the functor reads, in
    slot order; ``tables``: (key or None, dtype, shape, offset, words) of
    each table in the shared-memory block, ``words`` the constant's
    32-bit words (None for a parameter, packed at launch)."""
    name: str
    functor: str
    source: str
    digest: str
    n_layers: int
    up_mask: int
    diag_mask: int
    uses_ij: bool
    slots: tuple
    tables: tuple
    table_words: int
    ops: int
    score_ctype: str
    char_ctype: str
    region: int
    banded: bool

    @property
    def ring_layers(self) -> tuple:
        m = self.up_mask | self.diag_mask
        return tuple(k for k in range(self.n_layers) if (m >> k) & 1)

    def path(self) -> Path:
        from repro_torch.kernels import build
        return (build.BUILD_DIR / GEN_DIR_NAME
                / f"wavefront_gen_{self.digest}.cu")

    def write(self) -> Path:
        """The translation unit on disk (written once, atomically)."""
        out = self.path()
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            tmp.write_text(self.source)
            os.replace(tmp, out)
        return out

    def pack(self, params, device="cpu"):
        """``(slots, table)``: each slot's 64-bit pattern (an int as its
        value, a float32 as its bits) and the tables as one
        int32 tensor of 32-bit words on ``device`` (None without a
        table)."""
        slots = []
        for key, dtype in self.slots:
            v = params[key]
            if isinstance(v, (torch.Tensor, np.ndarray, np.generic)):
                v = v.item()
            slots.append(_bits("<f", "<i", v) if dtype == torch.float32
                         else int(v))
        if not self.table_words:
            return slots, None
        words = []
        for k, (key, dtype, shape, _, const) in enumerate(self.tables):
            if const is not None:
                ck = (self.digest, k, str(torch.device(device)))
                w = _CONSTS.get(ck)
                if w is None:
                    w = _CONSTS[ck] = torch.tensor(const, dtype=torch.int32,
                                                   device=device)
                words.append(w)
                continue
            t = torch.as_tensor(params[key]).detach()
            if t.dtype != dtype or tuple(t.shape) != shape:
                raise ValueError(f"kernel {self.name}: parameter {key!r} is "
                                 f"{t.dtype} {tuple(t.shape)}, the PE was "
                                 f"lowered for {dtype} {shape}")
            words.append(_table_words(t.to(device), f"parameter {key!r}",
                                      self.name))
        return slots, torch.cat(words).contiguous()


def _bits(fmt, as_int, v):
    """The bits of float ``v`` packed as ``fmt``, read back as an int."""
    return struct.unpack(as_int, struct.pack(fmt, float(v)))[0]


# the captured constants' words, per (functor, table, device)
_CONSTS: dict = {}


def _table_words(t, what, name):
    t = t.contiguous().reshape(-1)
    if t.dtype == torch.float32:
        return t.view(torch.int32).clone()
    if t.dtype == torch.int64 and t.numel() and (
            int(t.min()) < -(1 << 31) or int(t.max()) >= (1 << 31)):
        raise ValueError(f"kernel {name}: {what} holds values outside int32, "
                         f"which K1's table words do not hold")
    return t.to(torch.int32)


# ---------------------------------------------------------------------------
# tracing
class _OpFrames(torch.utils._python_dispatch.TorchDispatchMode):
    """Records, per aten op, the PE's source line of its first call."""

    def __init__(self):
        super().__init__()
        self.frames = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in self.frames:
            self.frames[func] = _frame_of(traceback.extract_stack())
        return func(*args, **(kwargs or {}))


def _trace(spec, params, n):
    """(graph module, op frames) of ``spec.pe`` at ``n`` lanes."""
    from torch.fx.experimental.proxy_tensor import make_fx
    keys = [k for k, v in params.items() if _as_tensor(v) is not None]
    vals = [_as_tensor(params[k]) for k in keys]
    fixed = {k: v for k, v in params.items() if k not in keys}
    L, dt, cdt = spec.n_layers, spec.score_dtype, spec.char_dtype
    frames = _OpFrames()

    def pe(vals, q, r, diag, up, left, i, j):
        p = dict(fixed)
        p.update(zip(keys, vals))
        with frames:
            return spec.pe(p, q, r, diag, up, left, i, j)

    args = (vals, torch.zeros(n, dtype=cdt), torch.zeros(n, dtype=cdt),
            torch.zeros(n, L, dtype=dt), torch.zeros(n, L, dtype=dt),
            torch.zeros(n, L, dtype=dt), torch.zeros(n, dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32))
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        gm = make_fx(pe, tracing_mode="fake")(*args)
    return gm, frames.frames, keys


def _same_graph(g1, g2, n1, n2) -> Optional[str]:
    """None when the traces at n1 and n2 lanes are one graph with the lane
    as dim 0 of every value, else what differs."""
    a, b = list(g1.graph.nodes), list(g2.graph.nodes)
    if len(a) != len(b):
        return f"the graph has {len(a)} nodes at {n1} lanes, {len(b)} at {n2}"
    names = {}
    for x, y in zip(a, b):
        names[x.name] = y.name
        if x.op != y.op or x.target != y.target:
            return f"{x.target} at {n1} lanes is {y.target} at {n2}"
        fx_, _ = torch.utils._pytree.tree_flatten((x.args, x.kwargs))
        fy_, _ = torch.utils._pytree.tree_flatten((y.args, y.kwargs))
        if len(fx_) != len(fy_):
            return f"{x.target}'s arguments differ with the lane count"
        for u, w in zip(fx_, fy_):
            if isinstance(u, torch.fx.Node):
                if not isinstance(w, torch.fx.Node) or \
                        names.get(u.name) != w.name:
                    return f"{x.target}'s inputs differ with the lane count"
            elif isinstance(u, (int, float)) and not isinstance(u, bool):
                if not (u == w or (u == n1 and w == n2)):
                    return f"{x.target}'s arguments differ with the lane count"
            elif u != w and not (isinstance(u, torch.Tensor)):
                return f"{x.target}'s arguments differ with the lane count"
        vx, vy = x.meta.get("val"), y.meta.get("val")
        if isinstance(vx, torch.Tensor):
            if not isinstance(vy, torch.Tensor) or vx.dim() != vy.dim():
                return f"{x.target}'s value differs with the lane count"
            for d, (p, q) in enumerate(zip(vx.shape, vy.shape)):
                if p != q and not (d == 0 and (p, q) == (n1, n2)):
                    return (f"{x.target} moves the lane off dim 0 (shape "
                            f"{tuple(vx.shape)} at {n1} lanes)")
    return None


# ---------------------------------------------------------------------------
# lowering
class _Lower:
    def __init__(self, spec, gm, frames, keys, params, n):
        self.spec, self.gm, self.frames, self.n = spec, gm, frames, n
        self.keys, self.params = keys, params
        self.nodes = []
        self.slots = []           # (key, dtype)
        self.tables = []          # (key, dtype, shape, offset, const)
        self.words = 0
        self.cache = {}

    # -- C values
    def new(self, dtype, code, deps=(), weight=1, tag=None):
        c = Cx(len(self.nodes), dtype, code, deps, weight=weight, tag=tag)
        self.nodes.append(c)
        return c

    def leaf(self, dtype, code, tag=None, const=None):
        key = ("leaf", code, dtype)
        c = self.cache.get(key)
        if c is None:
            c = Cx(len(self.nodes), dtype, code, leaf=True, tag=tag,
                   const=const)
            self.nodes.append(c)
            self.cache[key] = c
        return c

    def lit(self, v, dtype):
        return self.leaf(dtype, _literal(v, dtype),
                         const=_as_dtype(v, dtype))

    def op(self, dtype, fmt, *deps, weight=1, tag=None):
        return self.new(dtype, fmt.format(*(d.ref for d in deps)), deps,
                        weight, tag)

    def cast(self, x, to):
        if x.dtype == to:
            return x
        frm = x.dtype
        if x.const is not None and to != torch.bool and \
                frm.is_floating_point == to.is_floating_point:
            return self.lit(x.const, to)
        if to == torch.bool:
            return self.op(to, "({0} != 0)", x)
        w = 1 if frm.is_floating_point != to.is_floating_point else 0
        if frm.is_floating_point and to == torch.uint8:
            return self.op(to, "(uint8_t)(long long)({0})", x, weight=w)
        return self.op(to, f"({_CTYPE[to]})({{0}})", x, weight=w)

    # -- operands
    def value(self, a, node):
        if isinstance(a, torch.fx.Node):
            return self.env[a.name]
        if isinstance(a, bool):
            return V(torch.bool, False, (), _arr(self.lit(a, torch.bool)),
                     weak=a)
        if isinstance(a, int):
            return V(torch.int64, False, (), _arr(self.lit(a, torch.int64)),
                     weak=a)
        if isinstance(a, float):       # a weak double, cast before use
            return V(torch.float64, False, (),
                     _arr(self.lit(a, torch.float64)), weak=a)
        self.refuse(node, f"takes an argument {a!r} the lowering does not "
                          f"read")

    def stand_in(self, v):
        if v.weak is not None:
            return v.weak
        nd = len(v.shape) + (1 if v.lane else 0)
        return torch.empty((1,) * nd, dtype=v.dtype)

    def common(self, a, b):
        """The dtype torch compares ``a`` and ``b`` in."""
        return torch.result_type(self.stand_in(a), self.stand_in(b))

    def refuse(self, node, why):
        where = self.frames.get(node.target) if node is not None else None
        at = f" ({where})" if where else ""
        what = node.target if node is not None else "the PE"
        raise Refused(f"kernel {self.spec.name}: {what}{at} {why}")

    # -- broadcasting elementwise
    def ew(self, node, vs, fn, out_dtype):
        lane = any(v.lane for v in vs)
        if not lane and any(v.lazy is not None for v in vs) and all(
                v.lazy is not None or v.shape == () for v in vs):
            tabs = [v for v in vs if v.lazy is not None]
            if len({v.shape for v in tabs}) == 1 and len(tabs) == 1:
                t = tabs[0]

                def lazy(k, vs=vs, t=t):
                    return fn(*(v.lazy(k) if v is t else v.el[()]
                                for v in vs))
                return V(out_dtype, False, t.shape, lazy=lazy, lo=self)
        if lane:
            nd = max([1 + len(v.shape) for v in vs if v.lane] +
                     [len(v.shape) for v in vs if not v.lane])
            inners, arrs = [], []
            for v in vs:
                if v.lane:
                    full = (1,) * (nd - 1 - len(v.shape)) + v.shape
                    arrs.append(v.el.reshape(full))
                    inners.append(full)
                else:
                    full = (1,) * (nd - len(v.shape)) + v.shape
                    if full[0] != 1:
                        self.refuse(node, f"broadcasts a tensor of shape "
                                          f"{v.shape} over the lane axis")
                    arrs.append(v.el.reshape(full)[0])
                    inners.append(full[1:])
            try:
                shape = np.broadcast_shapes(*inners)
            except ValueError:
                self.refuse(node, "broadcasts shapes that do not match")
        else:
            arrs = [v.el for v in vs]
            shape = np.broadcast_shapes(*[v.shape for v in vs])
        arrs = [np.broadcast_to(a, shape) for a in arrs]
        out = np.empty(shape, dtype=object)
        for idx in np.ndindex(*shape) if shape else [()]:
            out[idx] = fn(*(a[idx] for a in arrs))
        return V(out_dtype, lane, shape, out)

    # -- arithmetic of one dtype
    def arith(self, sym, a, b, t):
        if t.is_floating_point:
            f = {"+": "add", "-": "sub", "*": "mul"}[sym]
            return self.op(t, f"__f{f}_rn({{0}}, {{1}})", a, b)
        if t in _WRAP:
            u = _WRAP[t]
            return self.op(t, f"({_CTYPE[t]})(({u}){{0}} {sym} ({u}){{1}})",
                           a, b)
        if t == torch.bool:
            return self.cast(self.op(torch.int32, f"((int){{0}} {sym} "
                                                  f"(int){{1}})", a, b), t)
        return self.op(t, f"({_CTYPE[t]})({{0}} {sym} {{1}})", a, b)

    def division(self, a, b, t, floor):
        """Integer ``a // b`` (``floor``) or ``a % b`` with torch's floor
        semantics, in ``t``: by a positive power of two an arithmetic shift
        or a mask (what floor division and remainder are in two's
        complement), else the ``syn_*`` helper."""
        if t == torch.bool:
            return self.cast(self.division(self.cast(a, torch.int32),
                                           self.cast(b, torch.int32),
                                           torch.int32, floor), t)
        c, d = _CTYPE[t], b.const
        if d is not None and 0 < d < (1 << (_BITS[t] - 1)) and \
                d & (d - 1) == 0:
            if floor:
                return self.op(t, f"({c})({{0}} >> {d.bit_length() - 1})", a)
            mask = f"{d - 1}LL" if t == torch.int64 else f"{d - 1}"
            return self.op(t, f"({c})({{0}} & {mask})", a)
        w = "long long" if t == torch.int64 else "int"
        fn = "syn_floordiv" if floor else "syn_rem"
        return self.op(t, f"({c}){fn}(({w}){{0}}, ({w}){{1}})", a, b,
                       weight=DIV_OPS if d is None else CONST_DIV_OPS)

    def maxmin(self, a, b, t, sym):
        if t.is_floating_point:
            return self.op(t, f"(({{0}} != {{0}}) ? {{0}} : ({{1}} != {{1}})"
                              f" ? {{1}} : ({{0}} {sym} {{1}} ? {{0}} : "
                              f"{{1}}))", a, b)
        return self.op(t, f"({{0}} {sym} {{1}} ? {{0}} : {{1}})", a, b)

    def shift(self, a, b, t, left):
        bits = _BITS[t]
        c = _CTYPE[t]
        u = "unsigned long long" if t == torch.int64 else "unsigned"
        bad = f"((long long){{1}} < 0 || (long long){{1}} >= {bits})"
        if left:
            return self.op(t, f"({bad} ? ({c})0 : ({c})(({u}){{0}} << "
                              f"{{1}}))", a, b)
        return self.op(t, f"({bad} ? ({c})({{0}} >> {bits - 1}) : "
                          f"({c})({{0}} >> {{1}}))", a, b)

    # -- the walk
    def run(self):
        spec = self.spec
        L, dt, cdt = spec.n_layers, spec.score_dtype, spec.char_dtype
        self.env = {}
        ph = [n for n in self.gm.graph.nodes if n.op == "placeholder"]
        nk = len(self.keys)
        for k, node in enumerate(ph):
            if k < nk:
                self.env[node.name] = self.param(self.keys[k], node)
                continue
            which = ("q", "r", "diag", "up", "left", "i", "j")[k - nk]
            if which in ("q", "r"):
                self.env[node.name] = V(cdt, True, (), _arr(
                    self.leaf(cdt, which, tag=(which,))))
            elif which in ("i", "j"):
                self.env[node.name] = V(torch.int32, True, (), _arr(
                    self.leaf(torch.int32, which, tag=("ij",))))
            else:
                el = np.empty(L, dtype=object)
                for l in range(L):
                    el[l] = self.leaf(dt, f"{which}[{l}]", tag=(which, l))
                self.env[node.name] = V(dt, True, (L,), el)
        out = None
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                continue
            if node.op == "get_attr":
                self.env[node.name] = self.constant(
                    getattr(self.gm, node.target), node)
            elif node.op == "call_function":
                self.env[node.name] = self.call(node)
            elif node.op == "output":
                out = node.args[0]
            else:
                self.refuse(node, f"is a graph node of kind {node.op}")
        return self.outputs(out)

    def param(self, key, node):
        val = node.meta["val"]
        if val.dim() == 0:
            if val.dtype not in _CTYPE:
                raise Refused(f"kernel {self.spec.name}: parameter {key!r} "
                              f"is {val.dtype}, which K1 does not lower")
            if len(self.slots) >= MAX_SLOTS:
                raise Refused(f"kernel {self.spec.name}: the PE reads more "
                              f"than {MAX_SLOTS} scalar parameters")
            k = len(self.slots)
            self.slots.append((key, val.dtype))
            code = (f"__int_as_float((int)g.s[{k}])"
                    if val.dtype == torch.float32 else
                    f"(({_CTYPE[val.dtype]})g.s[{k}])")
            return V(val.dtype, False, (), _arr(
                self.leaf(val.dtype, code, tag=("slot", k))))
        return self.table(key, val.dtype, tuple(val.shape), None,
                          f"parameter {key!r}")

    def table(self, key, dtype, shape, const, what):
        n = int(np.prod(shape))
        if dtype not in _CTYPE:
            raise Refused(f"kernel {self.spec.name}: {what} is {dtype}; "
                          f"K1's tables hold int and float32 entries")
        if n > MAX_TABLE or len(self.tables) >= MAX_TABLES:
            raise Refused(f"kernel {self.spec.name}: {what} has {n} entries; "
                          f"K1 stages at most {MAX_TABLES} tables of at most "
                          f"{MAX_TABLE} (24 x 24)")
        off = self.words
        self.tables.append((key, dtype, shape, off, const))
        self.words += n
        t = len(self.tables) - 1
        read = (f"__int_as_float((int)tab[{off} + {{0}}])"
                if dtype == torch.float32 else
                f"(({_CTYPE[dtype]})(int)tab[{off} + {{0}}])")
        if dtype == torch.bool:
            read = f"(tab[{off} + {{0}}] != 0u)"

        def lazy(k):
            return self.op(dtype, read, k, tag=("tab", t))
        return V(dtype, False, shape, lazy=lazy, lo=self)

    def constant(self, t, node):
        t = t.detach().to("cpu")
        if t.dim() == 0:
            if t.dtype not in _CTYPE:
                self.refuse(node, f"captures a {t.dtype} constant")
            return V(t.dtype, False, (), _arr(self.lit(t.item(), t.dtype)))
        if t.dtype not in _CTYPE:
            self.refuse(node, f"captures a {t.dtype} tensor")
        words = tuple(int(w) for w in _table_words(
            t, "a captured constant", self.spec.name).tolist())
        v = self.table(None, t.dtype, tuple(t.shape), words,
                       f"a captured constant of shape {tuple(t.shape)}")
        flat = t.reshape(-1).tolist()
        v._el = np.array([self.lit(x, t.dtype) for x in flat],
                         dtype=object).reshape(tuple(t.shape))
        return v

    def outputs(self, out):
        spec = self.spec
        if not isinstance(out, (list, tuple)) or len(out) != 2:
            raise Refused(f"kernel {spec.name}: the PE must return (scores, "
                          f"ptr)")
        scores, ptr = (self.env[o.name] if isinstance(o, torch.fx.Node)
                       else None for o in out)
        if scores is None or not scores.lane or \
                int(np.prod(scores.shape)) != spec.n_layers:
            raise Refused(f"kernel {spec.name}: the PE's scores must be "
                          f"(N, {spec.n_layers}) over the lanes")
        if ptr is None or ptr.dtype.is_floating_point or \
                int(np.prod(ptr.shape)) != 1:
            raise Refused(f"kernel {spec.name}: the PE's pointers must be "
                          f"(N,) integers")
        outs = [self.cast(c, spec.score_dtype)
                for c in scores.el.reshape(-1)]
        p = ptr.el.reshape(-1)[0]
        return outs, (self.cast(p, torch.int32)
                      if p.dtype != torch.int64 else
                      self.op(torch.int32, "(int)(unsigned long long)({0})",
                              p, weight=0))

    # -- ops
    def call(self, node):
        target = node.target
        name = getattr(getattr(target, "overloadpacket", None), "__name__",
                       None)
        h = OPS.get(name)
        if h is None:
            self.refuse(node, "is outside K1's PE lowering (see "
                              "repro_torch/kernels/wavefront/synth.py OPS)")
        val = node.meta.get("val")
        if not isinstance(val, torch.Tensor):
            self.refuse(node, "does not give one tensor")
        if val.dtype not in _CTYPE:
            self.refuse(node, f"makes a {val.dtype} value, which K1 does not "
                              f"lower")
        out = h(self, node, val.dtype)
        lane = val.dim() >= 1 and val.shape[0] == self.n
        want = tuple(val.shape[1:]) if lane else tuple(val.shape)
        if out.lane != lane or out.shape != want:
            self.refuse(node, f"gives shape {tuple(val.shape)}, which the "
                              f"lowering cannot place over the lanes")
        if out.dtype != val.dtype:
            out = self.ew(node, [out], lambda x: self.cast(x, val.dtype),
                          val.dtype)
        return out


def _dim(node, d, nd):
    d = int(d)
    return d + nd if d < 0 else d


# each handler: (lowering, node, result dtype) -> V
def _binary(kind):
    def h(lo, node, t):
        a = lo.value(node.args[0], node)
        b = lo.value(node.args[1], node)
        if kind == "rsub":
            a, b = b, a
        alpha = node.kwargs.get("alpha", node.args[2] if len(node.args) > 2
                                else 1)
        if alpha != 1:
            lo.refuse(node, "scales by alpha, which the lowering does not")
        sym = {"add": "+", "sub": "-", "rsub": "-", "mul": "*"}[kind]
        return lo.ew(node, [a, b], lambda x, y: lo.arith(
            sym, lo.cast(x, t), lo.cast(y, t), t), t)
    return h


def _division(floor):
    def h(lo, node, t):
        if t.is_floating_point:
            lo.refuse(node, "divides floats, which the lowering does not")
        a, b = (lo.value(x, node) for x in node.args[:2])
        return lo.ew(node, [a, b], lambda x, y: lo.division(
            lo.cast(x, t), lo.cast(y, t), t, floor), t)
    return h


def _maxmin(sym):
    def h(lo, node, t):
        a, b = (lo.value(x, node) for x in node.args[:2])
        return lo.ew(node, [a, b], lambda x, y: lo.maxmin(
            lo.cast(x, t), lo.cast(y, t), t, sym), t)
    return h


def _compare(sym):
    def h(lo, node, t):
        a, b = (lo.value(x, node) for x in node.args[:2])
        c = lo.common(a, b)
        return lo.ew(node, [a, b], lambda x, y: lo.op(
            torch.bool, f"({{0}} {sym} {{1}})", lo.cast(x, c), lo.cast(y, c)),
            torch.bool)
    return h


def _logical(sym):
    def h(lo, node, t):
        vs = [lo.value(x, node) for x in node.args[:2]]
        if sym == "!":
            return lo.ew(node, vs[:1], lambda x: lo.op(
                torch.bool, "(!{0})", lo.cast(x, torch.bool)), torch.bool)
        return lo.ew(node, vs, lambda x, y: lo.op(
            torch.bool, f"({{0}} {sym} {{1}})", lo.cast(x, torch.bool),
            lo.cast(y, torch.bool)), torch.bool)
    return h


def _bitwise(sym):
    def h(lo, node, t):
        if t.is_floating_point:
            lo.refuse(node, "is a bitwise op on floats")
        if sym == "~":
            a = lo.value(node.args[0], node)
            if t == torch.bool:
                return lo.ew(node, [a], lambda x: lo.op(
                    t, "(!{0})", lo.cast(x, t)), t)
            return lo.ew(node, [a], lambda x: lo.op(
                t, f"({_CTYPE[t]})(~{{0}})", lo.cast(x, t)), t)
        a, b = (lo.value(x, node) for x in node.args[:2])
        if sym in ("<<", ">>"):
            return lo.ew(node, [a, b], lambda x, y: lo.shift(
                lo.cast(x, t), lo.cast(y, t), t, sym == "<<"), t)
        return lo.ew(node, [a, b], lambda x, y: lo.op(
            t, f"({_CTYPE[t]})({{0}} {sym} {{1}})", lo.cast(x, t),
            lo.cast(y, t)), t)
    return h


def _unary(kind):
    def h(lo, node, t):
        a = lo.value(node.args[0], node)
        if kind in ("exp", "log", "log1p"):
            if not t.is_floating_point:
                lo.refuse(node, "is a transcendental op on integers")
            return lo.ew(node, [a], lambda x: lo.op(
                t, f"{kind}f({{0}})", lo.cast(x, t),
                weight=TRANSCENDENTAL_OPS), t)
        if kind == "neg":
            if t.is_floating_point:
                return lo.ew(node, [a], lambda x: lo.op(
                    t, "(-{0})", lo.cast(x, t)), t)
            u = _WRAP.get(t, "int")
            return lo.ew(node, [a], lambda x: lo.op(
                t, f"({_CTYPE[t]})(({u})0 - ({u}){{0}})", lo.cast(x, t)), t)
        if t.is_floating_point:
            return lo.ew(node, [a], lambda x: lo.op(
                t, "fabsf({0})", lo.cast(x, t)), t)
        if t in (torch.bool, torch.uint8):
            return lo.ew(node, [a], lambda x: lo.cast(x, t), t)
        u = _WRAP.get(t, "int")
        return lo.ew(node, [a], lambda x: lo.op(
            t, f"({{0}} < 0 ? ({_CTYPE[t]})(({u})0 - ({u}){{0}}) : {{0}})",
            lo.cast(x, t)), t)
    return h


def _logaddexp(lo, node, t):
    a, b = (lo.value(x, node) for x in node.args[:2])
    if not t.is_floating_point:
        lo.refuse(node, "is logaddexp on integers")
    return lo.ew(node, [a, b], lambda x, y: lo.op(
        t, "syn_lae({0}, {1})", lo.cast(x, t), lo.cast(y, t),
        weight=LAE_OPS), t)


def _clamp(kind):
    def h(lo, node, t):
        x = lo.value(node.args[0], node)
        args = list(node.args[1:]) + [None] * 2
        if kind == "min":
            lo_b, hi_b = node.args[1], None
        elif kind == "max":
            lo_b, hi_b = None, node.args[1]
        else:
            lo_b = node.kwargs.get("min", args[0])
            hi_b = node.kwargs.get("max", args[1])
        vs = [x] + [lo.value(b, node) for b in (lo_b, hi_b) if b is not None]

        def fn(*es):
            es = [lo.cast(e, t) for e in es]
            v, k = es[0], 1
            if lo_b is not None:
                v = lo.maxmin(v, es[k], t, ">")
                k += 1
            if hi_b is not None:
                v = lo.maxmin(v, es[k], t, "<")
            return v
        return lo.ew(node, vs, fn, t)
    return h


def _where(lo, node, t):
    c, a, b = (lo.value(x, node) for x in node.args[:3])
    return lo.ew(node, [c, a, b], lambda x, y, z: lo.op(
        t, "({0} ? {1} : {2})", lo.cast(x, torch.bool), lo.cast(y, t),
        lo.cast(z, t)), t)


def _to(lo, node, t):
    a = lo.value(node.args[0], node)
    return lo.ew(node, [a], lambda x: lo.cast(x, t), t)


def _same(lo, node, t):
    return lo.value(node.args[0], node)


def _full(lo, node, t):
    name = node.target.overloadpacket.__name__
    val = node.meta["val"]
    fill = {"full": 1, "full_like": 1, "scalar_tensor": 0}
    fill = node.args[fill[name]] if name in fill else 0
    if isinstance(fill, torch.fx.Node):
        lo.refuse(node, "fills with a traced value")
    lane = val.dim() >= 1 and val.shape[0] == lo.n
    shape = tuple(val.shape[1:]) if lane else tuple(val.shape)
    c = lo.lit(fill, t)
    el = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape) if shape else [()]:
        el[idx] = c
    return V(t, lane, shape, el)


def _select(lo, node, t):
    x = lo.value(node.args[0], node)
    nd = len(x.shape) + (1 if x.lane else 0)
    d, i = _dim(node, node.args[1], nd), int(node.args[2])
    if x.lane:
        if d == 0:
            lo.refuse(node, "selects one lane")
        d -= 1
    size = x.shape[d]
    i = i + size if i < 0 else i
    return V(x.dtype, x.lane, x.shape[:d] + x.shape[d + 1:],
             _arr(np.take(x.el, i, axis=d)))


def _slice(lo, node, t):
    x = lo.value(node.args[0], node)
    nd = len(x.shape) + (1 if x.lane else 0)
    args = list(node.args[1:]) + [0, None, None, 1][len(node.args) - 1:]
    d = _dim(node, args[0], nd)
    start, end, step = args[1], args[2], args[3]
    if x.lane and d == 0:
        if (start in (None, 0)) and (end is None or end >= lo.n) and step == 1:
            return x
        lo.refuse(node, "slices the lane axis")
    if x.lane:
        d -= 1
    size = x.shape[d]
    sl = slice(start, None if end is None or end >= size else end, step)
    idx = [slice(None)] * len(x.shape)
    idx[d] = sl
    el = x.el[tuple(idx)]
    return V(x.dtype, x.lane, el.shape, el)


def _unsqueeze(lo, node, t):
    x = lo.value(node.args[0], node)
    nd = len(x.shape) + (1 if x.lane else 0)
    d = _dim(node, node.args[1], nd + 1)
    if x.lane:
        if d == 0:
            lo.refuse(node, "moves the lane axis")
        d -= 1
    el = np.expand_dims(x.el, d)
    return V(x.dtype, x.lane, el.shape, el)


def _stack(lo, node, t):
    vs = [lo.value(x, node) for x in node.args[0]]
    d = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim", 0)
    name = node.target.overloadpacket.__name__
    lane = vs[0].lane
    if any(v.lane != lane for v in vs):
        lo.refuse(node, "joins lane and non-lane values")
    nd = len(vs[0].shape) + (1 if lane else 0)
    d = _dim(node, d, nd + (1 if name == "stack" else 0))
    if lane:
        if d == 0:
            lo.refuse(node, "joins along the lane axis")
        d -= 1
    els = [np.asarray(lo.ew(node, [v], lambda x: lo.cast(x, t), t).el)
           for v in vs]
    el = np.stack(els, axis=d) if name == "stack" else \
        np.concatenate(els, axis=d)
    return V(t, lane, el.shape, el)


def _index(lo, node, t):
    x = lo.value(node.args[0], node)
    idx = node.args[1]
    if x.lane:
        lo.refuse(node, "indexes a lane value; only tables (parameters and "
                        "captured constants) are indexed")
    if x.lazy is None or any(i is None for i in idx) or \
            len(idx) > len(x.shape):
        lo.refuse(node, "indexes in a way the lowering does not place")
    ivs = [lo.value(i, node) for i in idx]
    if any(v.dtype not in (torch.int32, torch.int64) for v in ivs):
        lo.refuse(node, "indexes with a mask or a non-integer tensor")
    shape, rest = x.shape, x.shape[len(idx):]
    stride = [int(np.prod(shape[k + 1:])) for k in range(len(shape))]

    def flat(*ks):
        f = None
        for k, (e, size) in enumerate(zip(ks, shape)):
            w = lo.op(torch.int64, f"((long long){{0}} < 0 ? (long long){{0}} "
                                   f"+ {size} : (long long){{0}})", e)
            c = lo.op(torch.int32, f"(int)({{0}} < 0 ? 0 : {{0}} > {size - 1} "
                                   f"? {size - 1} : {{0}})", w)
            term = c if stride[k] == 1 else lo.op(
                torch.int32, f"({{0}} * {stride[k]})", c)
            f = term if f is None else lo.op(torch.int32, "({0} + {1})", f,
                                             term)
        return f
    base = lo.ew(node, ivs, flat, torch.int32)
    if not rest:
        return lo.ew(node, [base], lambda k: x.lazy(k), x.dtype)
    n_rest = int(np.prod(rest))

    def expand(k):
        return np.array([x.lazy(lo.op(torch.int32, f"({{0}} + {r})", k))
                         for r in range(n_rest)], dtype=object).reshape(rest)
    el = np.empty(base.shape + rest, dtype=object)
    for pos in np.ndindex(*base.shape) if base.shape else [()]:
        el[pos] = expand(base.el[pos])
    return V(x.dtype, base.lane, el.shape, el)


OPS = {
    "add": _binary("add"), "sub": _binary("sub"), "rsub": _binary("rsub"),
    "mul": _binary("mul"),
    "floor_divide": _division(True), "remainder": _division(False),
    "maximum": _maxmin(">"), "minimum": _maxmin("<"),
    "eq": _compare("=="), "ne": _compare("!="), "lt": _compare("<"),
    "le": _compare("<="), "gt": _compare(">"), "ge": _compare(">="),
    "logical_and": _logical("&&"), "logical_or": _logical("||"),
    "logical_xor": _logical("!="), "logical_not": _logical("!"),
    "bitwise_and": _bitwise("&"), "bitwise_or": _bitwise("|"),
    "bitwise_xor": _bitwise("^"), "bitwise_not": _bitwise("~"),
    "__lshift__": _bitwise("<<"),
    "__rshift__": _bitwise(">>"), "bitwise_left_shift": _bitwise("<<"),
    "bitwise_right_shift": _bitwise(">>"),
    "neg": _unary("neg"), "abs": _unary("abs"), "exp": _unary("exp"),
    "log": _unary("log"), "log1p": _unary("log1p"),
    "logaddexp": _logaddexp,
    "clamp": _clamp("both"), "clamp_min": _clamp("min"),
    "clamp_max": _clamp("max"),
    "where": _where,
    "_to_copy": _to, "lift_fresh_copy": _same,
    "full": _full, "full_like": _full, "zeros": _full, "zeros_like": _full,
    "scalar_tensor": _full,
    "select": _select, "slice": _slice, "unsqueeze": _unsqueeze,
    "stack": _stack, "cat": _stack,
    "index": _index,
}


# ---------------------------------------------------------------------------
# emission
_HELPERS = {
    "syn_floordiv(": """\
template <class I>
__device__ __forceinline__ I syn_floordiv(I a, I b) {
  if (b == 0) return 0;
  if (b == -1) return (I)((I)0 - a);
  const I q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}""",
    "syn_rem(": """\
template <class I>
__device__ __forceinline__ I syn_rem(I a, I b) {
  if (b == 0 || b == -1) return 0;
  const I r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}""",
    "syn_lae(": """\
// torch.logaddexp: two equal infinities give themselves, else the
// template's log_add_exp (max + log1p(exp(-|a - b|)))
__device__ __forceinline__ float syn_lae(float a, float b) {
  return (a == b && fabsf(a) == __int_as_float(0x7f800000))
             ? a : log_add_exp(a, b);
}""",
}


def _emit(lo, outs, ptr):
    """(body lines, used leaves' tags, op count) of the live values."""
    live, stack = set(), [*outs, ptr]
    while stack:
        c = stack.pop()
        if c.id in live:
            continue
        live.add(c.id)
        stack.extend(c.deps)
    body, tags, ops = [], [], 0
    for c in lo.nodes:
        if c.id not in live:
            continue
        if c.tag is not None:
            tags.append(c.tag)
        if c.leaf:
            continue
        ops += c.weight
        body.append(f"    const {_CTYPE[c.dtype]} v{c.id} = {c.code};")
    for l, c in enumerate(outs):
        body.append(f"    out[{l}] = {c.ref};")
    body.append(f"    return {ptr.ref};")
    return body, tags, ops


def _functor(spec, body, up, dg, uses_ij, kTable):
    S, C = _CTYPE[spec.score_dtype], _CTYPE[spec.char_dtype]
    ij = ", int i, int j" if uses_ij else ""
    return "\n".join([
        f"// the PE of kernel {spec.name}, lowered from its torch graph",
        f"struct GenPE : Scores<{S}, {OBJECTIVES[spec.objective]}> {{",
        f"  using Char = {C};",
        f"  static constexpr int L = {spec.n_layers};",
        f"  static constexpr unsigned UP = 0x{up:x}u, DIAG = 0x{dg:x}u;",
        f"  static constexpr int PRIMARY = {spec.primary_layer};",
        f"  static constexpr bool kTable = {'true' if kTable else 'false'};",
        f"  static constexpr bool kSlots = true;",
        f"  static constexpr bool kIJ = {'true' if uses_ij else 'false'};",
        f"  __device__ __forceinline__ static int cell(",
        f"      const Slots& g, const unsigned* tab, {C} q, {C} r,",
        f"      const {S}* diag, const {S}* up, const {S}* left, {S}* out"
        f"{ij}) {{",
        "    (void)g; (void)tab; (void)q; (void)r; (void)diag; (void)up;",
        "    (void)left;",
        *body,
        "  }",
        "};"])


_ENTRY = """\
// K1 on this PE: (region, banded) = ({region}, {banded}); the other
// arguments are those of wavefront_fill_launch in wavefront.cu, the scalar
// parameters as n_slots 64-bit slots, the tables as n_words 32-bit words.
extern "C" int wavefront_gen_fill_launch(
    int band, const void* query, const void* ref, const void* init_row,
    const void* init_col, const void* lens, const void* table, int n_words,
    const long long* slots, int n_slots, void* tb, void* best, void* best_j,
    int B, int Q, int R, int pack, int with_tb, int warps, int ring_log2,
    int strip_lag, int ring_chunk, void* stream) {{
  if (B <= 0) return 0;
  if (bad_geometry(Q, warps, ring_log2, strip_lag, ring_chunk) ||
      n_slots < 0 || n_slots > MAX_SLOTS || (band >= 0) != {banded})
    return (int)cudaErrorInvalidValue;
  const Params p{{}};
  KArgs a = make_args(query, ref, init_row, init_col, lens, table, p, band,
                      tb, best, best_j, B, Q, R, pack, with_tb, warps,
                      ring_log2);
  for (int k = 0; k < n_slots; ++k) a.g.s[k] = slots[k];
  a.g.n_words = table ? n_words : 0;
  return launch<GenPE, {region}, {banded}>(a,
                                           static_cast<cudaStream_t>(stream));
}}
"""


def _scope(spec) -> Optional[str]:
    if tuple(spec.char_shape) != ():
        return (f"kernel {spec.name}: its PE reads vector characters "
                f"(char_shape {tuple(spec.char_shape)}); K1 lowers PEs over "
                f"scalar characters only (vector characters are not lowered "
                f"yet)")
    if spec.char_dtype not in CHAR_DTYPES:
        return (f"kernel {spec.name}: characters of {spec.char_dtype}; K1 "
                f"lowers uint8 or int32 codes and float32 samples")
    if spec.score_dtype not in SCORE_DTYPES:
        return (f"kernel {spec.name}: scores of {spec.score_dtype}; K1 "
                f"lowers int32 and float32 scores, not 64-bit scores")
    if spec.objective not in OBJECTIVES:
        return (f"kernel {spec.name}: objective {spec.objective!r}; K1 "
                f"lowers max, min and logsumexp")
    if not 1 <= spec.n_layers <= MAX_LAYERS:
        return (f"kernel {spec.name}: {spec.n_layers} layers; K1 lowers 1 "
                f"to {MAX_LAYERS}")
    return None


def _lower(spec, params) -> Synth:
    why = _scope(spec)
    if why:
        raise Refused(why)
    graphs = []
    for n in LANES:
        try:
            graphs.append(_trace(spec, params, n))
        except Refused:
            raise
        except Exception as e:     # the trace's own error is the reason
            where = _frame_of(traceback.extract_tb(e.__traceback__))
            msg = str(e).strip().splitlines()[0] if str(e).strip() else \
                type(e).__name__
            raise Refused(f"kernel {spec.name}: its PE does not trace on "
                          f"fake tensors{f' ({where})' if where else ''}: "
                          f"{type(e).__name__}: {msg}") from None
    (g1, frames, keys), (g2, _, _) = graphs
    diff = _same_graph(g1, g2, *LANES)
    if diff:
        raise Refused(f"kernel {spec.name}: its PE's graph depends on the "
                      f"lane count: {diff}")
    lo = _Lower(spec, g1, frames, keys, params, LANES[0])
    outs, ptr = lo.run()
    body, tags, ops = _emit(lo, outs, ptr)
    up = sum(1 << t[1] for t in set(tags) if t[0] == "up")
    dg = sum(1 << t[1] for t in set(tags) if t[0] == "diag")
    uses_ij = any(t == ("ij",) for t in tags)
    # every slot and table keeps its place (the offsets are baked into the
    # body); an unread one costs a few bytes of the launch
    used_tabs = {t[1] for t in tags if t[0] == "tab"}
    functor = _functor(spec, body, up, dg, uses_ij, bool(used_tabs))
    text = "\n".join(body)
    helpers = [h for key, h in _HELPERS.items() if key in text]
    functor = "\n\n".join(helpers + [functor]) if helpers else functor
    region = REGION_IDS[spec.region]
    banded = spec.band is not None
    source = "\n".join([
        f"// K1 with a PE generated from the torch PE of kernel "
        f"{spec.name} by",
        "// repro_torch/kernels/wavefront/synth.py; see "
        "wavefront_kernel.cuh for the",
        "// kernel itself.",
        "",
        '#include "wavefront_kernel.cuh"',
        "",
        "namespace {",
        "",
        functor,
        "",
        "}  // namespace",
        "",
        _ENTRY.format(region=region, banded="true" if banded else "false")])
    digest = hashlib.sha256(source.encode()).hexdigest()[:16]
    return Synth(
        name=spec.name, functor=functor, source=source, digest=digest,
        n_layers=spec.n_layers, up_mask=up, diag_mask=dg, uses_ij=uses_ij,
        slots=tuple(lo.slots), tables=tuple(lo.tables),
        table_words=lo.words if used_tabs else 0, ops=ops,
        score_ctype=_CTYPE[spec.score_dtype],
        char_ctype=_CTYPE[spec.char_dtype], region=region, banded=banded)


_CACHE: dict = {}
_CHECKED: dict = {}
_LOCK = threading.Lock()


def lower(spec: T.DPKernelSpec, params) -> Synth:
    """The ``Synth`` of ``spec`` at the signature of ``params``; raises
    ``Refused``.  Cached per (spec, signature)."""
    key = (spec, signature(params))
    with _LOCK:
        hit = _CACHE.get(key)
    if hit is None:
        try:
            hit = _lower(spec, params)
        except Refused as e:
            hit = e
        with _LOCK:
            _CACHE[key] = hit
    if isinstance(hit, Refused):
        raise hit
    return hit


class _Probe(dict):
    """Parameters discovered as the PE reads them: each key a 0-d tensor
    of the score type's kind, or, once it is known to be one, a table."""

    def __init__(self, spec, tables):
        super().__init__()
        self.spec, self.tables, self.read = spec, tables, []

    def __missing__(self, key):
        self.read.append(key)
        v = self.make(key)
        self[key] = v
        return v

    def make(self, key):
        floating = self.spec.score_dtype.is_floating_point
        shape = self.tables.get(key)
        if shape is not None:
            n = int(np.prod(shape))
            t = (torch.arange(n, dtype=torch.float32) * -0.25 if floating
                 else torch.arange(n, dtype=torch.int32) % 7 - 3)
            return t.reshape(shape)
        return 0.5 if floating else 1


def _probe_params(spec):
    """A parameter dict the PE runs on, found by running it eagerly on a
    few lanes: every key it reads is a scalar until the PE only runs with
    that key as a table of PROBE_SIDE x PROBE_SIDE (or PROBE_SIDE) entries."""
    L, n = spec.n_layers, 4
    args = (torch.zeros(n, dtype=spec.char_dtype),
            torch.ones(n, dtype=spec.char_dtype),
            torch.zeros(n, L, dtype=spec.score_dtype),
            torch.ones(n, L, dtype=spec.score_dtype),
            torch.zeros(n, L, dtype=spec.score_dtype),
            torch.ones(n, dtype=torch.int32), torch.ones(n, dtype=torch.int32))

    def attempt(tables):
        p = _Probe(spec, tables)
        try:
            spec.pe(p, *args)
            return p, None
        except Exception as e:     # noqa: BLE001 - any failure: try tables
            return p, e
    p, err = attempt({})
    if err is None:
        return dict(p)
    for key in list(p.read):
        for shape in ((PROBE_SIDE, PROBE_SIDE), (PROBE_SIDE,)):
            q, e = attempt({key: shape})
            if e is None:
                return dict(q)
    return dict(p)     # the trace reports what fails


def check(spec: T.DPKernelSpec) -> Optional[str]:
    """None when K1 can lower ``spec``'s PE, else why not.  Lowers with
    probe parameters (``_probe_params``); cached per spec."""
    with _LOCK:
        if spec in _CHECKED:
            hit = _CHECKED[spec]
            return None if isinstance(hit, Synth) else hit
    why = _scope(spec)
    if why is None:
        try:
            hit = _lower(spec, _probe_params(spec))
        except Refused as e:
            hit = str(e)
    else:
        hit = why
    with _LOCK:
        _CHECKED[spec] = hit
    return None if isinstance(hit, Synth) else hit


def probe(spec: T.DPKernelSpec) -> Synth:
    """The ``Synth`` ``check`` lowered (probe parameters): the ring layers,
    table size and operation count the planners use before the spec's
    parameters are known.  Raises ``Refused`` where ``check`` refuses."""
    why = check(spec)
    if why:
        raise Refused(why)
    with _LOCK:
        return _CHECKED[spec]
