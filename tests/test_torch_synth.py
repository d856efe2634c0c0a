"""K1 on any PE a user declares: ``kernels/wavefront/synth.py`` lowers a
spec's torch PE to a CUDA PE functor, and the port's ``wavefront`` engine
runs every spec the lowering accepts.

(a) every zoo spec with scalar characters, lowered with its ``family``
set to None, and the quickstart's ti/tv kernel: the emitted ``cell``,
compiled as host C++ (``g++ -ffp-contract=off``, with ``__device__`` and
``__forceinline__`` empty and host versions of the ``__f*_rn``
intrinsics and ``log_add_exp``) and called through ctypes on 4096 random
lanes that include the sentinels, equals the PE: int bit-equal, f32
within the parity contract (rtol 2e-5).  The C cell gets the sentinel in
every layer of ``up`` and ``diag`` its masks leave out, as K1 passes them.
(b) the derived UP/DIAG masks of the family specs equal
``core/types.py``'s table.  (c) ``align`` and ``run_pairs`` on the CPU
through the port's ``wavefront`` engine equal the JAX package's
``wavefront`` and ``reference`` engines on the same specs written in
``jnp``: the ti/tv kernel, a PE that reads ``i`` and ``j``, a float
max-plus PE with a user table, and the specs K1 refused before it took
any PE (the edit kernels, #1 at objective min, the pair-HMM forward over
the whole matrix); int exact, float rtol 1e-5.  (d) refusals: an op
outside the lowering and a branch on data.  (e) on the card (gpu
marker): generated twins of #2, #15 and the pair-HMM forward equal their
hand-written functors.  JAX is imported inside the CPU tests only.
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
                                     "int_ops", "float_ops"]


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
    S, Ch, L = syn.score_ctype, syn.char_ctype, syn.n_layers
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


def _lanes(rng, spec, n):
    """Random lanes: characters of the spec's alphabet and some past it,
    neighbour scores with both sentinels mixed in, i and j in [1, 3000]."""
    if spec.char_dtype == torch.uint8:
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


@pytest.mark.parametrize("name", CELL_CASES, ids=str)
def test_host_compiled_cell_equals_the_pe(name, host_cells):
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
    if spec.score_dtype.is_floating_point:
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
    """What K1 still refuses: vector characters, 64-bit scores."""
    profile = dataclasses.replace(pzoo.make(8)[0], family=None)
    assert "vector characters" in K.supports(profile)
    wide = dataclasses.replace(pzoo.make(1)[0], family=None,
                               score_dtype=torch.int64)
    assert "64-bit scores" in K.supports(wide)


# ---------------------------------------------------------------------------
# (e) on the card
TWINS = [2, 15, ("forward", "logsumexp")]


@pytest.mark.gpu
@pytest.mark.parametrize("name", TWINS, ids=str)
def test_cuda_generated_twin_equals_hand_written(name):
    """A functor generated from a zoo PE gives the bits of the hand-written
    functor on the same inputs (int32 scores, pointers, end columns
    bit-equal; the logsumexp twin within 2e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is CUDA C++ with no CPU mode)")
    from repro_torch.kernels.wavefront import ops
    hand, params = (pzoo.make(name) if isinstance(name, int) else
                    (prob.pairhmm(name[1]), prob.default_params()))
    twin = dataclasses.replace(hand, family=None)
    rng = np.random.default_rng(5)
    hi = 20 if name == 15 else 4
    for B, Q, R in [(16, 64, 64), (8, 256, 256), (3, 1024, 1024)]:
        qs = torch.as_tensor(rng.integers(0, hi, (B, Q)).astype(np.uint8))
        rs = torch.as_tensor(rng.integers(0, hi, (B, R)).astype(np.uint8))
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
