"""K1 on any PE a user declares: ``kernels/wavefront/synth.py`` lowers a
spec's torch PE to a CUDA PE functor, and the port's ``wavefront`` engine
runs every spec the lowering accepts.

(a) every zoo spec, lowered with its ``family`` set to None, the
quickstart's ti/tv kernel and the user PEs below, over scalar and vector
characters: the emitted ``cell``, compiled as host C++ (``g++
-ffp-contract=off``, with ``__device__`` and ``__forceinline__`` empty and
host versions of the ``__f*_rn`` intrinsics and ``log_add_exp``) and
called through ctypes on 4096 random lanes that include the sentinels,
equals the PE: int and the f32 PEs that spell their order out (#8, #9 and
their variants) bit-equal, the sum/mm/sqrt PEs within 1e-6 of their terms'
magnitudes, other f32 within the parity contract (rtol 2e-5).  The C cell
gets the sentinel in every layer of ``up`` and ``diag`` its masks leave
out, as K1 passes them.  (b) the derived UP/DIAG masks of the family specs
equal ``core/types.py``'s table.  (c) ``align`` and ``run_pairs`` on the
CPU through the port's ``wavefront`` engine equal the JAX package's
``wavefront`` and ``reference`` engines on the same specs written in
``jnp``: the ti/tv kernel, a PE that reads ``i`` and ``j``, a float
max-plus PE with a user table, the specs K1 refused before it took any PE
(the edit kernels, #1 at objective min, the pair-HMM forward over the
whole matrix), and the vector-character cases (#9 with a Sakoe-Chiba
band, #8 over the last row, Euclidean and Chebyshev DTW over 3-channel
samples, local profile alignment through a matrix product,
quality-aware alignment over (base, phred) bytes); int exact, float rtol
1e-5.  (d) refusals: an op outside the lowering, a branch on data, a
character of 25 entries, ``pow`` by 3, ``mm`` of two lane values.  (e) on
the card (gpu marker): generated twins of #2, #15, the pair-HMM forward,
#8 and #9 equal their hand-written functors.  JAX is imported inside the
CPU tests only.
"""
from __future__ import annotations

import ctypes
import dataclasses
import shutil
import subprocess
import zlib

import numpy as np
import pytest
import torch

from repro_torch import prob
from repro_torch.core import DPKernelSpec, REGION_CORNER, STOP_ORIGIN
from repro_torch.core import api
from repro_torch.core import kernels_zoo as pzoo
from repro_torch.core import types as T
from repro_torch.core.kernels_zoo import common as C
from repro_torch.core.kernels_zoo import user_vector as UV
from repro_torch.kernels.wavefront import kernel as K
from repro_torch.kernels.wavefront import synth
from repro_torch.runtime import dispatch, get_plan

LANES = 4096
SCALAR_ZOO = [1, 2, 3, 4, 5, 6, 7, 10, 11, 12, 13, 14, 15]
PAIRHMM = [("forward", "max"), ("forward", "logsumexp"),
           ("backward", "max"), ("backward", "logsumexp")]
F32_RTOL = 2e-5      # the ROADMAP's parity contract for f32 PEs


# ---------------------------------------------------------------------------
# user PEs: the quickstart's ti/tv kernel, one that reads (i, j), one over
# a float table (torch here; their jnp twins in _jax_specs)
def _titv_sub(params, q, r):
    """Transition (A<->G, C<->T) scores milder than transversion
    (examples/quickstart.py)."""
    is_transition = (q // 2 == r // 2) & (q != r)
    return torch.where(q == r, params["match"],
                       torch.where(is_transition, params["transition"],
                                   params["transversion"]))


def _best3(m, d, ins):
    best, ptr = m, torch.full(m.shape, C.P_DIAG, dtype=torch.int32)
    ptr = torch.where(d > best, C.P_UP, ptr)
    best = torch.maximum(best, d)
    ptr = torch.where(ins > best, C.P_LEFT, ptr)
    return torch.maximum(best, ins), ptr


def _ij_pe(params, q, r, diag, up, left, i, j):
    """Linear gaps that cost one more on every third row and in odd blocks
    of 16 columns."""
    sub = torch.where(q == r, params["match"], params["mismatch"])
    m = diag[:, 0] + sub
    d = up[:, 0] + params["gap"] - (i % 3 == 0).to(torch.int32)
    ins = left[:, 0] + params["gap"] - (j // 16) % 2
    best, ptr = _best3(m, d, ins)
    return best[:, None], ptr


def _ftab_pe(params, q, r, diag, up, left, i, j):
    """f32 max-plus with a user 4 x 4 substitution table."""
    s = params["S"][q.long().clamp(0, 3), r.long().clamp(0, 3)]
    m = diag[:, 0] + s
    d = up[:, 0] + params["gap"]
    ins = left[:, 0] + params["gap"]
    best, ptr = _best3(m, d, ins)
    return best[:, None], ptr


def _ftab_init(params, k):
    return (params["gap"] * k.to(torch.float32))[..., None]


_CODE = [[0, 3, 1, 3], [3, 0, 3, 1], [1, 3, 0, 3], [3, 1, 3, 0]]


def _int_ops_pe(params, q, r, diag, up, left, i, j):
    """The integer ops no zoo PE reaches: mul, neg, rsub, ge, the logical
    and bitwise ops, both shifts in both spellings, clamp_min and
    clamp_max, cat and slice on the layer axis, a captured constant table,
    and floor division and remainder of negative values by a power of two,
    by another literal and by a parameter."""
    qi, ri = q.long(), r.long()
    cost = torch.tensor(_CODE)[qi % 4, ri % 4].to(torch.int32)
    bits = (qi ^ ri) | (~qi & 3)
    bits = torch.bitwise_right_shift(torch.bitwise_left_shift(bits, 3),
                                     1) + ((bits << 2) >> 1)
    same = torch.logical_and(q == r, i >= j)
    odd = torch.logical_xor(torch.logical_or(i % 2 == 1, j // 4 > 300),
                            torch.logical_not(same))
    a = diag[:, 0] * params["scale"] - cost
    b = 3 - (-up[:, 1])
    c = ((left[:, 0] - 5) // 4 + (left[:, 1] - 5) % 8
         + left[:, 0] // params["div"] - left[:, 1] % params["div"]
         + left[:, 0] // -3 + left[:, 1] % 7)
    pair = torch.cat([a[:, None], b[:, None]], 1).clamp_min(-(1 << 20))
    pair = pair.clamp_max(1 << 20) + torch.where(
        same, bits.to(torch.int32), torch.where(odd, c, -c))[:, None]
    out = torch.cat([pair[:, 1:], pair[:, :1]], 1)
    return out, torch.where(same, 1, 2).to(torch.int32)


def _float_ops_pe(params, q, r, diag, up, left, i, j):
    """The float ops no zoo PE reaches: mul, neg, rsub, exp, log, log1p,
    clamp_min, clamp_max, ge, cat and slice on the layer axis; every output
    a sum of non-negative terms, so that the parity contract is relative."""
    m = torch.abs(diag[:, 0] * params["scale"])
    soft = torch.log1p(torch.exp(-torch.abs(up[:, 0] - left[:, 0])))
    lg = torch.log(torch.abs(left[:, 1]) + 1.0)
    e = (0.5 - up[:, 1]).clamp_min(0.0).clamp_max(1e4)
    both = torch.cat([torch.maximum(m + soft, lg + e)[:, None],
                      (lg + soft)[:, None]], 1)
    out = torch.cat([both[:, :1], both[:, 1:]], 1)
    return out, (m >= lg).to(torch.int32)


_S = np.array([[2.0, -1.5, -0.5, -1.5], [-1.5, 2.0, -1.5, -0.5],
               [-0.5, -1.5, 2.0, -1.5], [-1.5, -0.5, -1.5, 2.0]], np.float32)
TITV_PARAMS = {"match": 2, "transition": -1, "transversion": -4, "gap": -2}
IJ_PARAMS = {"match": 2, "mismatch": -3, "gap": -2}
FTAB_PARAMS = {"S": torch.as_tensor(_S), "gap": -1.25}
INT_OPS_PARAMS = {"scale": 3, "div": 5}
FLOAT_OPS_PARAMS = {"scale": 0.75}


def titv_spec():
    return DPKernelSpec(name="titv_global", n_layers=1,
                        pe=C.linear_pe(_titv_sub),
                        init_row=C.linear_gap_init,
                        init_col=C.linear_gap_init, region=REGION_CORNER,
                        traceback=C.linear_tb(STOP_ORIGIN))


def ij_spec():
    return DPKernelSpec(name="ij_linear", n_layers=1, pe=_ij_pe,
                        init_row=C.linear_gap_init,
                        init_col=C.linear_gap_init, region=REGION_CORNER,
                        traceback=C.linear_tb(STOP_ORIGIN))


def ftab_spec():
    return DPKernelSpec(name="ftab_linear", n_layers=1, pe=_ftab_pe,
                        init_row=_ftab_init, init_col=_ftab_init,
                        region=REGION_CORNER, score_dtype=torch.float32,
                        traceback=C.linear_tb(STOP_ORIGIN))


def ops_spec(score_dtype):
    pe = _float_ops_pe if score_dtype.is_floating_point else _int_ops_pe
    return DPKernelSpec(name=f"ops_{str(score_dtype)[6:]}", n_layers=2,
                        pe=pe, init_row=C.zeros_init(2),
                        init_col=C.zeros_init(2), score_dtype=score_dtype)


USER = {"titv": (titv_spec, TITV_PARAMS), "ij": (ij_spec, IJ_PARAMS),
        "ftab": (ftab_spec, FTAB_PARAMS),
        "int_ops": (lambda: ops_spec(torch.int32), INT_OPS_PARAMS),
        "float_ops": (lambda: ops_spec(torch.float32), FLOAT_OPS_PARAMS)}


# ---------------------------------------------------------------------------
# PEs over vector characters (``kernels_zoo/user_vector.py``): (a) #9 with a
# Sakoe-Chiba band, (b) #8 over the last row, (c) Euclidean DTW over
# 3-channel samples, (d) subsequence Chebyshev DTW, (e) local
# profile-to-profile alignment through a matrix product, (f) quality-aware
# global alignment over (base, phred) bytes
VECTOR = {name: ((lambda name=name: UV.make(name)[0]), UV.make(name)[1])
          for name in UV.NAMES}
USER.update(VECTOR)
# the cases whose PE reaches sum, mm or sqrt: torch's CPU kernels keep no
# fixed order, so the cell agrees within a tolerance, not bit for bit
ROUNDED = {"euclid", "profile_local"}


def _zoo_case(name):
    """(spec with family None, params) of a zoo kernel, a pair-HMM case or
    a user PE."""
    if isinstance(name, int):
        spec, params = pzoo.make(name)
    elif isinstance(name, tuple):
        direction, objective = name
        mk = prob.pairhmm if direction == "forward" else \
            prob.pairhmm_backward
        spec, params = mk(objective), prob.default_params()
    else:
        mk, params = USER[name]
        spec = mk()
    return dataclasses.replace(spec, family=None), params


CELL_CASES = SCALAR_ZOO + PAIRHMM + [16, 17, "titv", "ij", "ftab",
                                     "int_ops", "float_ops", 8, 9,
                                     *VECTOR]


# ---------------------------------------------------------------------------
# (a) the emitted cell, compiled for the host
PRELUDE = r"""
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <algorithm>
#include <cmath>
#define __device__
#define __host__
#define __forceinline__ inline
using std::max;
using std::min;
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fsqrt_rn(float a) { return sqrtf(a); }
static inline double __dadd_rn(double a, double b) { return a + b; }
static inline double __dsub_rn(double a, double b) { return a - b; }
static inline double __dmul_rn(double a, double b) { return a * b; }
static inline double __ddiv_rn(double a, double b) { return a / b; }
static inline float __int_as_float(int x) {
  float f;
  memcpy(&f, &x, 4);
  return f;
}
static inline double __longlong_as_double(long long x) {
  double d;
  memcpy(&d, &x, 8);
  return d;
}
constexpr int OBJ_MAX = 0, OBJ_MIN = 1, OBJ_LSE = 2;
template <class S> struct Far;
template <> struct Far<int> {
  static constexpr int value() { return 1 << 30; }
};
template <> struct Far<float> {
  static constexpr float value() { return 1e30f; }
};
template <class S, int OBJ>
struct Scores {
  using Score = S;
  static constexpr int kObj = OBJ;
  static constexpr S sent() {
    return OBJ == OBJ_MIN ? Far<S>::value() : -Far<S>::value();
  }
};
constexpr int MAX_SLOTS = 32;
struct Slots {
  long long s[MAX_SLOTS];
  int n_words;
};
static inline float log_add_exp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}
"""


def _shim(k, syn):
    S, Ch, L = syn.score_ctype, "GenPE::Char", syn.n_layers
    ij = ", i[t], j[t]" if syn.uses_ij else ""
    return f"""
namespace s{k} {{
{syn.functor}
extern "C" void run_s{k}(int n, const long long* slots, const unsigned* tab,
                         const {Ch}* q, const {Ch}* r, const {S}* diag,
                         const {S}* up, const {S}* left, const int* i,
                         const int* j, {S}* out, int* ptr) {{
  Slots g{{}};
  for (int k = 0; k < MAX_SLOTS; ++k) g.s[k] = slots[k];
  for (int t = 0; t < n; ++t)
    ptr[t] = GenPE::cell(g, tab, q[t], r[t], diag + t * {L}, up + t * {L},
                         left + t * {L}, out + t * {L}{ij});
}}
}}  // namespace s{k}
"""


@pytest.fixture(scope="module")
def host_cells(tmp_path_factory):
    """{case: (spec, params, Synth, C function)}: every CELL_CASES functor
    in one host library."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on PATH: the generated cells are "
                    "compiled for the host with g++")
    cases = {}
    parts = [PRELUDE]
    for k, name in enumerate(CELL_CASES):
        spec, params = _zoo_case(name)
        syn = synth.lower(spec, params)
        cases[name] = (k, spec, params, syn)
        parts.append(_shim(k, syn))
    d = tmp_path_factory.mktemp("synth_cells")
    src, lib = d / "cells.cpp", d / "cells.so"
    src.write_text("\n".join(parts))
    proc = subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off",
                           "-shared", "-fPIC", "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    so = ctypes.CDLL(str(lib))
    out = {}
    for name, (k, spec, params, syn) in cases.items():
        fn = getattr(so, f"run_s{k}")
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 11
        fn.restype = None
        out[name] = (spec, params, syn, fn)
    return out


def _chars(rng, spec, n):
    """``n`` random characters of a vector-character spec: profile columns
    for (5,) f32, normal samples for other f32 shapes, (base, phred) bytes
    (bases past the alphabet included) for (2,) uint8."""
    cs = tuple(spec.char_shape)
    if spec.char_dtype == torch.uint8:
        base = rng.integers(0, 6, n)
        return np.stack([base, rng.integers(0, 42, n)], 1).astype(np.uint8)
    if cs == (5,):
        return pzoo.profile.make_profile(rng, n)
    return rng.normal(size=(n,) + cs).astype(np.float32)


def _lanes(rng, spec, n):
    """Random lanes: characters of the spec's alphabet and some past it,
    neighbour scores with both sentinels mixed in, i and j in [1, 3000]."""
    if spec.char_shape:
        q, r = _chars(rng, spec, n), _chars(rng, spec, n)
    elif spec.char_dtype == torch.uint8:
        q = rng.integers(0, 25, n).astype(np.uint8)
        r = rng.integers(0, 25, n).astype(np.uint8)
        q[::97], r[::89] = 255, 30
    else:
        q = rng.integers(-64, 128, n).astype(np.int32)
        r = rng.integers(-64, 128, n).astype(np.int32)
    L = spec.n_layers
    sent = T.INT_SENTINEL if not spec.score_dtype.is_floating_point else \
        T.FLOAT_SENTINEL

    def scores():
        if spec.score_dtype.is_floating_point:
            x = (rng.normal(size=(n, L)) * 20).astype(np.float32)
        else:
            x = rng.integers(-2000, 2000, (n, L)).astype(np.int32)
        pick = rng.random((n, L))
        x[pick < 0.12] = -sent
        x[pick > 0.95] = sent
        return x
    ij = rng.integers(1, 3000, (2, n)).astype(np.int32)
    return q, r, scores(), scores(), scores(), ij[0], ij[1]


def _masked(x, mask, sent):
    """``x`` with every layer outside ``mask`` set to the sentinel (what K1
    passes for a layer it does not carry)."""
    x = x.copy()
    for l in range(x.shape[1]):
        if not (mask >> l) & 1:
            x[:, l] = sent
    return x


def _magnitude(name, q, r, params, diag, up, left):
    """Per lane, the sum of the magnitudes of the terms the cell adds
    (f64): the cost's terms and its result, and the finite neighbour
    scores."""
    q, r = q.astype(np.float64), r.astype(np.float64)
    if name == "euclid":
        sq = ((q - r) ** 2).sum(-1)
        terms = sq + np.sqrt(sq)
    else:
        s = np.asarray(params["S"], np.float64)
        terms = np.abs(q[:, :, None] * s[None] * r[:, None, :]).sum((1, 2))
    for x in (diag, up, left):
        a = np.abs(x.astype(np.float64))
        terms = terms + np.where(a < 1e29, a, 0.0).max(1)
    return terms


@pytest.mark.parametrize("name", CELL_CASES, ids=str)
def test_host_compiled_cell_equals_the_pe(name, host_cells):
    """Integer cells and #8, #9 and the PEs that spell their order out
    (the band and last-row variants, the Chebyshev PE's max and division)
    bit-equal; the sum, mm and sqrt cases (``ROUNDED``) within 1e-6 of the
    sum of the magnitudes of the terms each lane adds, since torch's CPU
    sum and mm keep no left-to-right order and its sqrt is 1 ulp off on
    some inputs (a few f32 roundings of those terms); the other f32 PEs
    within the parity contract's rtol 2e-5."""
    spec, params, syn, fn = host_cells[name]
    rng = np.random.default_rng(zlib.crc32(str(name).encode()))
    q, r, diag, up, left, i, j = _lanes(rng, spec, LANES)
    want_s, want_p = spec.pe(params, *(torch.as_tensor(x) for x in (
        q, r, diag, up, left, i, j)))
    want_s = want_s.to(spec.score_dtype).reshape(LANES, -1).numpy()
    want_p = (want_p.to(torch.int64) & 0xFF).numpy()
    slots, table = syn.pack(params)
    sl = np.zeros(synth.MAX_SLOTS, np.int64)
    sl[:len(slots)] = slots
    tab = (table.numpy().view(np.uint32) if table is not None
           else np.zeros(1, np.uint32))
    sent = spec.sentinel()
    sdt = want_s.dtype
    carried = syn.up_mask | syn.diag_mask
    args = [q, r, _masked(diag, syn.diag_mask, sent),
            _masked(up, carried, sent), left, i, j]
    args = [np.ascontiguousarray(a) for a in args]
    out = np.zeros((LANES, spec.n_layers), sdt)
    ptr = np.zeros(LANES, np.int32)
    ptrs = [sl, tab, *args, out, ptr]
    fn(LANES, *(a.ctypes.data_as(ctypes.c_void_p) for a in ptrs))
    np.testing.assert_array_equal(ptr.astype(np.int64) & 0xFF, want_p)
    if name in ROUNDED:
        mag = _magnitude(name, q, r, params, diag, up, left)
        err = np.abs(out.astype(np.float64) - want_s)[:, 0]
        assert (err <= 1e-6 * mag).all(), float((err / mag).max())
    elif spec.score_dtype.is_floating_point and not spec.char_shape:
        np.testing.assert_allclose(out, want_s, rtol=F32_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(out, want_s)


# ---------------------------------------------------------------------------
# (b) masks
FAMILY_CASES = [1, 2, 3, 4, 5, 10, 14, 15] + PAIRHMM


@pytest.mark.parametrize("name", FAMILY_CASES, ids=str)
def test_derived_masks_equal_the_family_table(name):
    if isinstance(name, int):
        spec, params = pzoo.make(name)
    else:
        mk = prob.pairhmm if name[0] == "forward" else prob.pairhmm_backward
        spec, params = mk(name[1]), prob.default_params()
    fam = spec.family
    syn = synth.lower(dataclasses.replace(spec, family=None), params)
    assert syn.up_mask == sum(1 << k for k in fam.up_layers)
    assert syn.diag_mask == sum(1 << k for k in fam.diag_layers)
    assert syn.ring_layers == fam.ring_layers
    probed = synth.probe(dataclasses.replace(spec, family=None))
    assert probed.ring_layers == fam.ring_layers


def test_probe_finds_tables_and_the_wrapper_routes():
    """``check`` lowers without parameters (the PE's table keys found by
    running it); the wrapper routes hand-written specs to their functors,
    everything else to a generated one, and sizes its shared memory."""
    spec, params = pzoo.make(15)
    twin = dataclasses.replace(spec, family=None)
    assert K.supports(twin) is None and K.is_generated(twin)
    assert not K.is_generated(spec)
    probed = synth.probe(twin)
    assert [t[2] for t in probed.tables] == [(synth.PROBE_SIDE,) * 2]
    real = synth.lower(twin, params)
    assert real.table_words == 24 * 24 and real.slots == (("gap",
                                                           torch.int64),)
    assert K.smem_bytes(twin, 64, 64, 2, syn=real) == \
        K.smem_bytes(spec, 64, 64, 2)
    assert K.source_of(spec) == K.SOURCE
    assert K.source_of(twin) is None
    assert K.source_of(twin, params).name.startswith("wavefront_gen_")
    # a second parameter set of one signature is one functor
    other = dict(params, gap=-7)
    assert synth.lower(twin, other) is real
    slots, _ = real.pack(other)
    assert slots == [-7]
    from repro_torch.tune.cost import pe_ops
    assert pe_ops(twin, params) == real.ops > 0


# ---------------------------------------------------------------------------
# (c) against the JAX package
def _jax_specs():
    """jnp twins of the user PEs, as JAX's quickstart writes them."""
    import jax.numpy as jnp
    from repro.core import DPKernelSpec as JSpec
    from repro.core.kernels_zoo import common as JC

    def titv_sub(params, q, r):
        is_transition = (q // 2 == r // 2) & (q != r)
        return jnp.where(q == r, params["match"],
                         jnp.where(is_transition, params["transition"],
                                   params["transversion"]))

    def best3(m, d, ins):
        best, ptr = m, jnp.int32(JC.P_DIAG)
        ptr = jnp.where(d > best, JC.P_UP, ptr)
        best = jnp.maximum(best, d)
        ptr = jnp.where(ins > best, JC.P_LEFT, ptr)
        return jnp.maximum(best, ins), ptr

    def ij_pe(params, q, r, diag, up, left, i, j):
        m = diag[0] + jnp.where(q == r, params["match"], params["mismatch"])
        d = up[0] + params["gap"] - (i % 3 == 0).astype(jnp.int32)
        ins = left[0] + params["gap"] - (j // 16) % 2
        best, ptr = best3(m, d, ins)
        return jnp.stack([best]), ptr

    def ftab_pe(params, q, r, diag, up, left, i, j):
        s = params["S"][jnp.clip(q.astype(jnp.int32), 0, 3),
                        jnp.clip(r.astype(jnp.int32), 0, 3)]
        m = diag[0] + s
        best, ptr = best3(m, up[0] + params["gap"], left[0] + params["gap"])
        return jnp.stack([best]), ptr

    def ftab_init(params, k):
        return (params["gap"] * k.astype(jnp.float32))[..., None]

    i32, f32 = jnp.int32, jnp.float32
    return {
        "titv": (JSpec(name="titv_global", n_layers=1,
                       pe=JC.linear_pe(titv_sub),
                       init_row=JC.linear_gap_init,
                       init_col=JC.linear_gap_init, region=REGION_CORNER,
                       traceback=JC.linear_tb(STOP_ORIGIN)),
                 {k: i32(v) for k, v in TITV_PARAMS.items()}),
        "ij": (JSpec(name="ij_linear", n_layers=1, pe=ij_pe,
                     init_row=JC.linear_gap_init,
                     init_col=JC.linear_gap_init, region=REGION_CORNER,
                     traceback=JC.linear_tb(STOP_ORIGIN)),
               {k: i32(v) for k, v in IJ_PARAMS.items()}),
        "ftab": (JSpec(name="ftab_linear", n_layers=1, pe=ftab_pe,
                       init_row=ftab_init, init_col=ftab_init,
                       region=REGION_CORNER, score_dtype=f32,
                       traceback=JC.linear_tb(STOP_ORIGIN)),
                 {"S": jnp.asarray(_S), "gap": f32(FTAB_PARAMS["gap"])}),
    }


def _jax_vector_specs():
    """(JAX spec, JAX params, port spec, port params) of the vector-
    character cases: the zoo's #9 and #8 as JAX's zoo makes them (#8 over
    the last row by ``dataclasses.replace`` on both sides, since
    ``profile()`` sets its region itself), the user PEs written in ``jnp``
    per cell, as JAX's engines vmap them."""
    import jax.numpy as jnp
    from repro.core import DPKernelSpec as JSpec
    from repro.core import kernels_zoo as jzoo
    from repro.core.kernels_zoo import common as JC

    def step(c, diag, up, left):
        best, ptr = diag[0], jnp.int32(JC.P_DIAG)
        ptr = jnp.where(up[0] < best, JC.P_UP, ptr)
        best = jnp.minimum(best, up[0])
        ptr = jnp.where(left[0] < best, JC.P_LEFT, ptr)
        best = jnp.minimum(best, left[0])
        return (c + best)[None], ptr

    def euclid_pe(params, q, r, diag, up, left, i, j):
        return step(jnp.sqrt(jnp.sum((q - r) ** 2)), diag, up, left)

    def cheb_pe(params, q, r, diag, up, left, i, j):
        return step(jnp.max(jnp.abs(q - r)) / params["scale"], diag, up,
                    left)

    def prof_sub(params, q, r):
        return jnp.sum((q @ params["S"]) * r)

    def qual_sub(params, q, r):
        mis = 1 + jnp.minimum(q[1], r[1]).astype(jnp.int32) // 10
        return jnp.where(q[0] == r[0], params["match"], -mis)

    def far(params, k):
        return jnp.where(k == 0, 0.0, 1e30).astype(jnp.float32)[..., None]

    def free(params, k):
        return jnp.zeros(jnp.shape(k) + (1,), jnp.float32)

    f32, i32 = jnp.float32, jnp.int32
    lin = dict(n_layers=1, ptr_bits=JC.LINEAR_PTR_BITS)
    dtw_f = dict(lin, objective="min", score_dtype=f32, char_shape=(3,),
                 char_dtype=f32)
    jspecs = {
        "dtw_band": jzoo.make(9, band=8),
        "profile_last_row": (dataclasses.replace(
            jzoo.make(8)[0], region=T.REGION_LAST_ROW), jzoo.make(8)[1]),
        "euclid": (JSpec(name="euclid_dtw", pe=euclid_pe, init_row=far,
                         init_col=far, region=REGION_CORNER, band=16,
                         traceback=JC.linear_tb(STOP_ORIGIN), **dtw_f),
                   {}),
        "chebyshev": (JSpec(name="chebyshev_sdtw", pe=cheb_pe,
                            init_row=free, init_col=far,
                            region=T.REGION_LAST_ROW,
                            traceback=JC.linear_tb(T.STOP_TOP_ROW),
                            **dtw_f), {"scale": f32(0.5)}),
        "profile_local": (JSpec(name="profile_local",
                                pe=JC.linear_pe(prof_sub, local=True),
                                init_row=free, init_col=free,
                                region=T.REGION_ALL, score_dtype=f32,
                                char_shape=(5,), char_dtype=f32,
                                traceback=JC.linear_tb(T.STOP_PTR_END),
                                **lin),
                          {"S": jnp.asarray(UV.PROFILE_S.numpy()),
                           "gap": f32(-1.0)}),
        "quality": (JSpec(name="quality_global", pe=JC.linear_pe(qual_sub),
                          init_row=JC.linear_gap_init,
                          init_col=JC.linear_gap_init, region=REGION_CORNER,
                          char_shape=(2,), char_dtype=jnp.uint8,
                          traceback=JC.linear_tb(STOP_ORIGIN), **lin),
                    {"match": i32(2), "gap": i32(-3)}),
    }
    out = {}
    for name, (jspec, jparams) in jspecs.items():
        mk, params = VECTOR[name]
        if name in ("dtw_band", "profile_last_row"):
            params = pzoo.from_reference_params(
                {k: np.asarray(v) for k, v in jparams.items()})
        out[name] = (jspec, jparams, mk(), params)
    return out


def _vector_pairs(rng, spec, n, lo, hi):
    """``n`` pairs of the spec's characters, query lengths in [lo, hi):
    the reference is the query with a quarter of its characters drawn
    anew, cut or extended at its end by up to 8 (so a banded corner stays
    in band and a local alignment has something to find)."""
    out = []
    for _ in range(n):
        nq = int(rng.integers(lo, hi))
        q = _chars(rng, spec, nq)
        r = q.copy()
        redraw = rng.random(nq) < 0.25
        r[redraw] = _chars(rng, spec, int(redraw.sum()))
        nr = max(1, nq + int(rng.integers(-8, 9)))
        r = np.concatenate([r, _chars(rng, spec, max(0, nr - nq))])[:nr]
        out.append((q, r))
    return out


def _flipped(name):
    """(JAX spec, JAX params, port spec, port params) of the specs K1
    refused before it took any PE."""
    from repro import prob as jprob
    from repro.core import kernels_zoo as jzoo
    if name == "min1":
        jspec, jparams = jzoo.make(1, objective="min")
        spec = pzoo.make(1, objective="min")[0]
    elif name == "hmm_all":
        jspec = dataclasses.replace(jprob.pairhmm(), region="all")
        spec = dataclasses.replace(prob.pairhmm(), region="all")
        jparams = jprob.default_params()
    else:
        jspec, jparams = jzoo.make(name)
        spec = pzoo.make(name)[0]
    params = pzoo.from_reference_params(
        {k: np.asarray(v) for k, v in jparams.items()})
    return jspec, jparams, spec, params


def _pairs(rng, n, lo, hi, hi_code=4):
    from repro_torch.core import alphabets
    out = []
    for _ in range(n):
        ref = rng.integers(0, hi_code, int(rng.integers(lo, hi))).astype(
            np.uint8)
        read = alphabets.mutate(rng, ref, 0.15) if hi_code == 4 else \
            rng.integers(0, hi_code, int(rng.integers(lo, hi))).astype(
                np.uint8)
        out.append((read, ref))
    return out


def _hold(want, got, floating):
    from torch_parity import to_np
    if floating:
        np.testing.assert_allclose(float(to_np(got.score)),
                                   float(to_np(want.score)), rtol=1e-5)
    else:
        assert int(to_np(got.score)) == int(to_np(want.score))
    for f in ("end_i", "end_j"):
        assert int(to_np(getattr(got, f))) == int(to_np(getattr(want, f))), f
    if want.moves is not None:
        from repro.core import traceback as jtb
        from repro_torch.core import traceback as ptb
        assert ptb.moves_to_cigar(got.moves, got.n_moves) == \
            jtb.moves_to_cigar(want.moves, want.n_moves)


@pytest.mark.parametrize("name", ["titv", "ij", "ftab"])
def test_user_pes_match_jax_engines(name):
    """``from repro_torch.core import DPKernelSpec, align``: the user PE on
    the port's ``wavefront`` engine (K1's plain version here; a functor
    generated from the PE on the card) equals JAX's ``wavefront`` and
    ``reference`` engines, pair by pair through ``align`` and as a batch
    through ``run_pairs``."""
    from repro.core import align as jalign
    from repro.core import alphabets as jalpha
    jspec, jparams = _jax_specs()[name]
    mk, params = USER[name]
    spec = mk()
    assert K.supports(spec) is None and K.is_generated(spec)
    rng = np.random.default_rng(0)
    ref = jalpha.random_dna(rng, 80)
    read = jalpha.mutate(rng, ref, 0.15)
    pairs = [(read, ref)] + _pairs(np.random.default_rng(3), 5, 20, 70)
    floating = spec.score_dtype.is_floating_point
    got_all = dispatch.run_pairs(spec, params, pairs, block=4, device="cpu")
    for (q, r), batched in zip(pairs, got_all):
        got = api.align(spec, params, q, r, device="cpu")
        for engine in ("wavefront", "reference"):
            want = jalign(jspec, jparams, q, r, engine_name=engine)
            _hold(want, got, floating)
            _hold(want, batched, floating)
    if name == "titv":        # the quickstart's read pair, as it prints
        assert int(api.align(spec, params, read, ref, device="cpu").score) \
            == 96


@pytest.mark.parametrize("name", list(VECTOR))
def test_vector_pes_match_jax_engines(name):
    """The vector-character cases on the port's ``wavefront`` engine (K1's
    plain version here; a functor generated from the PE on the card)
    equal JAX's ``wavefront`` and ``reference`` engines pair by pair
    through ``align`` and as a batch through ``run_pairs``: the quality PE
    exactly (scores, end cells, moves), the f32 ones to the parity
    contract (scores to rtol 1e-5, exact end cells, the same path)."""
    from repro.core import align as jalign
    jspec, jparams, spec, params = _jax_vector_specs()[name]
    assert K.supports(spec) is None and K.is_generated(spec)
    pairs = _vector_pairs(np.random.default_rng(zlib.crc32(name.encode())),
                          spec, 4, 20, 60)
    floating = spec.score_dtype.is_floating_point
    got_all = dispatch.run_pairs(spec, params, pairs, block=4, device="cpu")
    for (q, r), batched in zip(pairs, got_all):
        got = api.align(spec, params, q, r, device="cpu")
        for engine in ("wavefront", "reference"):
            want = jalign(jspec, jparams, q, r, engine_name=engine)
            _hold(want, got, floating)
            _hold(want, batched, floating)


def test_banded_dtw_scores_as_jax_on_the_default_engine():
    """``align(*make(9, band=8), q, r)`` on two seeded 2-channel signals
    of 40 and 44 samples: the port's default engine scores what JAX's
    ``wavefront`` and ``reference`` engines score (73.928)."""
    from repro.core import align as jalign
    from repro.core import kernels_zoo as jzoo
    rng = np.random.default_rng(0)
    q = rng.normal(size=(40, 2)).astype(np.float32)
    r = rng.normal(size=(44, 2)).astype(np.float32)
    got = api.align(*pzoo.make(9, band=8), q, r, device="cpu")
    for engine in ("wavefront", "reference"):
        want = jalign(*jzoo.make(9, band=8), q, r, engine_name=engine)
        _hold(want, got, True)
    assert abs(float(got.score) - 73.928) < 1e-3


@pytest.mark.parametrize("name", [16, 17, "min1", "hmm_all"], ids=str)
def test_specs_k1_refused_before_run_on_its_engine(name):
    """The edit kernels (no PE family), #1 at objective min and the
    pair-HMM forward over the whole matrix (family combinations K1 never
    instantiated) now run on the port's ``wavefront`` engine through a
    generated functor; results equal JAX's ``wavefront`` engine."""
    from repro.core import align as jalign
    jspec, jparams, spec, params = _flipped(name)
    assert K.supports(spec) is None and K.is_generated(spec)
    hmm = name == "hmm_all"
    pairs = _pairs(np.random.default_rng(7), 4, 20, 60,
                   hi_code=4 if not hmm else 5)
    got_all = dispatch.run_pairs(spec, params, pairs, block=4, device="cpu",
                                 with_traceback=spec.traceback is not None)
    for (q, r), got in zip(pairs, got_all):
        want = jalign(jspec, jparams, q, r, engine_name="wavefront",
                      with_traceback=spec.traceback is not None)
        if hmm:
            np.testing.assert_allclose(float(got.score), float(want.score),
                                       rtol=2e-5)
        else:
            _hold(want, got, False)


# ---------------------------------------------------------------------------
# (d) refusals
def _sin_pe(params, q, r, diag, up, left, i, j):
    wobble = torch.sin(diag[:, 0])
    return (diag[:, 0] + wobble)[:, None], torch.zeros_like(q,
                                                            dtype=torch.int32)


def _branchy_pe(params, q, r, diag, up, left, i, j):
    if bool((diag[:, 0] > 0).any()):
        return diag, torch.zeros_like(q, dtype=torch.int32)
    return up, torch.zeros_like(q, dtype=torch.int32)


@pytest.mark.parametrize("which", ["op", "branch"])
def test_refused_pes_name_why_and_never_run(which):
    pe = _sin_pe if which == "op" else _branchy_pe
    dt = torch.float32 if which == "op" else torch.int32
    spec = DPKernelSpec(name=f"bad_{which}", n_layers=1, pe=pe,
                        init_row=C.zeros_init(1), init_col=C.zeros_init(1),
                        score_dtype=dt)
    why = K.supports(spec)
    assert why is not None and spec.name in why
    if which == "op":
        assert "aten.sin" in why and "test_torch_synth.py:" in why
    else:
        assert "does not trace" in why and "test_torch_synth.py:" in why
    with pytest.raises(ValueError, match="cannot run kernel bad_"):
        get_plan(spec, "wavefront", (32,), (32,), device="cpu")
    with pytest.raises(ValueError, match="cannot run kernel bad_"):
        api.align(spec, {}, np.zeros(8, np.uint8), np.zeros(8, np.uint8),
                  device="cpu")
    with pytest.raises(ValueError, match="bad_"):
        K.wavefront_fill(spec, {}, torch.zeros(1, 32, dtype=torch.uint8),
                         torch.zeros(1, 8, dtype=torch.uint8),
                         torch.zeros(1, 9, 1, dtype=dt),
                         torch.zeros(1, 33, 1, dtype=dt),
                         torch.tensor([[32, 8]], dtype=torch.int32))


def test_scope_refusals():
    """What K1 still refuses: 64-bit scores.  A PE over vector characters
    (#8 with its family set to None) is supported, through a generated
    functor."""
    profile = dataclasses.replace(pzoo.make(8)[0], family=None)
    assert K.supports(profile) is None and K.is_generated(profile)
    wide = dataclasses.replace(pzoo.make(1)[0], family=None,
                               score_dtype=torch.int64)
    assert "64-bit scores" in K.supports(wide)


def _wide_pe(params, q, r, diag, up, left, i, j):
    return UV.dtw_step((q - r).abs().sum(-1), diag, up, left)


def _cube_pe(params, q, r, diag, up, left, i, j):
    return UV.dtw_step(((q - r) ** 3).abs().sum(-1), diag, up, left)


def _lanes_mm_pe(params, q, r, diag, up, left, i, j):
    return UV.dtw_step((q @ r.T).sum(-1), diag, up, left)


@pytest.mark.parametrize("which", ["char25", "pow3", "mm_lanes"])
def test_vector_refusals_name_why_and_never_run(which):
    """The vector-character lowering's limits: a character of 25 entries
    (over ``MAX_CHAR``), ``pow`` by 3, and ``mm`` of two lane values (the
    reference transposed moves the lane off dim 0, into ``aten.mm``).
    Each refusal names the kernel and its cause (the op and the PE's
    source line where an op is at fault) and raises before any launch."""
    pe = {"char25": _wide_pe, "pow3": _cube_pe, "mm_lanes": _lanes_mm_pe}
    n = 25 if which == "char25" else 3
    spec = DPKernelSpec(name=f"vec_{which}", n_layers=1, pe=pe[which],
                        init_row=UV.far_init, init_col=UV.far_init,
                        objective="min", score_dtype=torch.float32,
                        char_shape=(n,), char_dtype=torch.float32)
    why = K.supports(spec)
    assert why is not None and spec.name in why
    if which == "char25":
        assert "25 entries" in why and str(synth.MAX_CHAR) in why
    else:
        op = "aten.pow" if which == "pow3" else "aten.mm"
        assert op in why and "test_torch_synth.py:" in why, why
    before = K.launches
    with pytest.raises(ValueError, match=f"cannot run kernel {spec.name}"):
        get_plan(spec, "wavefront", (32,), (32,), device="cpu")
    with pytest.raises(ValueError, match=spec.name):
        K.wavefront_fill(spec, {}, torch.zeros(1, 32, n),
                         torch.zeros(1, 8, n), torch.zeros(1, 9, 1),
                         torch.zeros(1, 33, 1),
                         torch.tensor([[32, 8]], dtype=torch.int32))
    assert K.launches == before


@pytest.mark.parametrize("name", list(VECTOR))
def test_vector_specs_route_to_generated_functors(name):
    """Each vector-character case runs on K1 through a functor generated
    from its PE; #8 and #9 as the zoo makes them keep their hand-written
    functors; the probe lowers each with vector probe inputs, finding the
    profile tables' 5 x 5 shape, and the planners read it."""
    from repro_torch.tune.cost import pe_ops
    mk, params = VECTOR[name]
    spec = mk()
    assert K.supports(spec) is None and K.is_generated(spec)
    probed = synth.probe(spec)
    real = synth.lower(spec, params)
    assert probed.char_shape == real.char_shape == tuple(spec.char_shape)
    assert real.char_struct.startswith("// a character") and \
        real.char_struct in real.functor
    assert "using Char = GenChar;" in real.functor
    if name in ("profile_last_row", "profile_local"):
        assert [t[2] for t in probed.tables] == [(5, 5)]
        assert probed.ops == real.ops
    assert pe_ops(spec, params) == real.ops > 0
    assert K.smem_bytes(spec, 64, 64, 2, syn=real) > 0
    from repro_torch.analyze import lint_point, point_for
    report = lint_point(point_for(spec, params, "wavefront", (64, 64), 4),
                        rules=["R4"])
    assert not [f for f in report.findings if f.severity == "error"]
    assert any(f.rule == "R401" for f in report.findings)
    for kid in (8, 9):
        hand = pzoo.make(kid)[0]
        assert K.supports(hand) is None and not K.is_generated(hand)


def test_lowering_from_threads():
    """Service workers lower their first specs from several threads at
    once: make_fx patches process-wide state, so concurrent traces must
    not break each other (each would be refused, and the refusal cached).
    Sixteen fresh specs lowered from eight threads all give the functor a
    lowering in this thread gives."""
    from concurrent.futures import ThreadPoolExecutor
    cases = []
    for k in range(16):
        spec, params = _zoo_case([2, 4, 8, 9, 15, "titv", "euclid",
                                  "quality"][k % 8])
        cases.append((dataclasses.replace(spec, name=f"threads_{k}"),
                      params))
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda c: synth.lower(*c), cases))
    for (spec, params), syn in zip(cases, got):
        again = synth._lower(spec, params)
        assert syn.digest == again.digest


# ---------------------------------------------------------------------------
# (e) on the card
TWINS = [2, 15, ("forward", "logsumexp"), 8, 9]


@pytest.mark.gpu
@pytest.mark.parametrize("name", TWINS, ids=str)
def test_cuda_generated_twin_equals_hand_written(name):
    """A functor generated from a zoo PE gives the bits of the hand-written
    functor on the same inputs (int32 scores, pointers, end columns
    bit-equal; #8 and #9, whose PEs spell their f32 order out, bit-equal
    too; the logsumexp twin within 2e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is CUDA C++ with no CPU mode)")
    from repro_torch.kernels.wavefront import ops
    hand, params = (pzoo.make(name) if isinstance(name, int) else
                    (prob.pairhmm(name[1]), prob.default_params()))
    twin = dataclasses.replace(hand, family=None)
    rng = np.random.default_rng(5)
    hi = 20 if name == 15 else 4
    for B, Q, R in [(16, 64, 64), (8, 256, 256), (3, 1024, 1024)]:
        if hand.char_shape:
            qs = torch.as_tensor(_chars(rng, hand, B * Q).reshape(
                (B, Q) + hand.char_shape))
            rs = torch.as_tensor(_chars(rng, hand, B * R).reshape(
                (B, R) + hand.char_shape))
        else:
            qs = torch.as_tensor(rng.integers(0, hi, (B, Q)).astype(
                np.uint8))
            rs = torch.as_tensor(rng.integers(0, hi, (B, R)).astype(
                np.uint8))
        ql = torch.as_tensor(rng.integers(Q // 2, Q + 1, B).astype(np.int32))
        rl = torch.as_tensor(rng.integers(R // 2, R + 1, B).astype(np.int32))
        q_l, r_l = ql.cuda(), rl.cuda()
        row, col = ops.boundaries(hand, params, Q, R, q_l, r_l)
        args = (qs.cuda(), rs.cuda(), row, col,
                torch.stack([q_l, r_l], 1).contiguous())
        before = K.launches
        a = K.wavefront_fill(hand, params, *args)
        b = K.wavefront_fill(twin, params, *args)
        torch.cuda.synchronize()
        assert K.launches == before + 2
        if hand.is_sum:
            torch.testing.assert_close(b[1], a[1], rtol=2e-5, atol=0)
        else:
            for x, y in zip(a, b):
                assert torch.equal(x, y)
