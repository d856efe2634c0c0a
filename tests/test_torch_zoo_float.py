"""The zoo's float and min-plus kernels in the PyTorch port — profile #8,
DTW #9, Viterbi #10, sDTW #14 — and the pair-HMM forward/backward PEs,
against the JAX package: declarations and boundary inits, PE cell by cell,
and fills on K1's plain version against JAX's ``reference`` engine.

Tolerances: sDTW (int32) is exact; the f32 max/min kernels match scores
to rtol 1e-5 with exact end cells, and their paths rescore to the score
within rtol 1e-5 (float near-ties may pick another pointer); logsumexp
cells match to rtol 2e-5.  Float cells also carry an absolute slack of
1e-4 for values that cancel to about zero (a profile score summed in
another order)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import prob as jprob
from repro.core import align as jalign
from repro.core import kernels_zoo as jzoo
from repro.core.kernels_zoo.profile import make_profile
from repro_torch import prob
from repro_torch.core import api, rescore
from repro_torch.core import kernels_zoo as pzoo
from repro_torch.kernels.wavefront import kernel as K

FLOAT_ZOO = [8, 9, 10, 14]
SHAPES = [(32, 32), (48, 31), (17, 63)]
PAIRHMM = [("forward", "logsumexp"), ("forward", "max"),
           ("backward", "logsumexp"), ("backward", "max")]


def _zoo_pair(kid):
    jspec, jparams = jzoo.make(kid)
    spec = pzoo.make(kid)[0]
    params = pzoo.from_reference_params(
        {k: np.asarray(v) for k, v in jparams.items()})
    return jspec, jparams, spec, params


def _hmm_pair(direction, objective):
    if direction == "forward":
        jspec, spec = jprob.pairhmm(objective), prob.pairhmm(objective)
    else:
        jspec = jprob.pairhmm_backward(objective)
        spec = prob.pairhmm_backward(objective)
    jparams = jprob.default_params()
    params = pzoo.from_reference_params(
        {k: np.asarray(v) for k, v in jparams.items()})
    return jspec, jparams, spec, params


def _inputs(rng, spec, nq, nr):
    """Random characters of the kernel's alphabet (as tests/conftest.py's
    make_kernel_inputs draws them), as numpy arrays."""
    if spec.char_shape == (5,):
        return make_profile(rng, nq), make_profile(rng, nr)
    if spec.char_shape == (2,):
        return (rng.normal(size=(nq, 2)).astype(np.float32),
                rng.normal(size=(nr, 2)).astype(np.float32))
    if spec.char_dtype == torch.int32:
        return (rng.integers(0, 128, nq).astype(np.int32),
                rng.integers(0, 128, nr).astype(np.int32))
    return (rng.integers(0, 4, nq).astype(np.uint8),
            rng.integers(0, 4, nr).astype(np.uint8))


def _rtol(spec):
    return 2e-5 if spec.is_sum else 1e-5


@pytest.mark.parametrize("kid", FLOAT_ZOO)
def test_declaration_and_inits_match(kid):
    jspec, jparams, spec, params = _zoo_pair(kid)
    assert spec.name == jspec.name
    assert (spec.n_layers, spec.region, spec.band, spec.objective,
            spec.primary_layer, spec.char_shape, spec.ptr_bits) == \
        (jspec.n_layers, jspec.region, jspec.band, jspec.objective,
         jspec.primary_layer, jspec.char_shape, jspec.ptr_bits)
    assert str(spec.score_dtype).split(".")[-1] == \
        np.dtype(jspec.score_dtype).name
    assert str(spec.char_dtype).split(".")[-1] == \
        np.dtype(jspec.char_dtype).name
    assert spec.sentinel() == pytest.approx(float(jspec.sentinel()))
    assert (spec.traceback is None) == (jspec.traceback is None)
    assert K.supports(spec) is None
    k = np.arange(70, dtype=np.int32)
    for jfn, pfn in ((jspec.init_row, spec.init_row),
                     (jspec.init_col, spec.init_col)):
        want = np.asarray(jfn(jparams, jnp.asarray(k))).reshape(70, -1)
        got = pfn(params, torch.as_tensor(k)).reshape(70, -1)
        np.testing.assert_array_equal(got.numpy(), want)


def _random_cells(rng, spec, n):
    L = spec.n_layers
    q, r = _inputs(rng, spec, n, n)
    cells = []
    for _ in range(3):
        if spec.score_dtype == torch.int32:
            c = rng.integers(-400, 400, (n, L)).astype(np.int32)
        else:
            c = (rng.normal(size=(n, L)) * 20).astype(np.float32)
        c[rng.random((n, L)) < 0.1] = spec.sentinel()
        cells.append(c)
    i = rng.integers(1, 64, n).astype(np.int32)
    j = rng.integers(1, 64, n).astype(np.int32)
    return q, r, cells, i, j


def _check_cells(jspec, jparams, spec, params, rng):
    n = 512
    q, r, (diag, up, left), i, j = _random_cells(rng, spec, n)
    vpe = jax.vmap(jspec.pe, in_axes=(None, 0, 0, 0, 0, 0, 0, 0))
    js, jptr = vpe(jparams, q, r, diag, up, left, i, j)
    js = np.asarray(js).reshape(n, spec.n_layers)
    jptr = np.broadcast_to(np.asarray(jptr), (n,))
    t = torch.as_tensor
    ps, pptr = spec.pe(params, t(q), t(r), t(diag), t(up), t(left), t(i),
                       t(j))
    assert ps.dtype == spec.score_dtype and pptr.dtype == torch.int32
    if spec.score_dtype == torch.int32:
        np.testing.assert_array_equal(ps.numpy(), js)
        np.testing.assert_array_equal(pptr.numpy(), jptr)
        return
    np.testing.assert_allclose(ps.numpy(), js, rtol=_rtol(spec), atol=1e-4)
    same = (ps.numpy() == js).all(axis=1)
    assert same.mean() > 0.5
    np.testing.assert_array_equal(pptr.numpy()[same], jptr[same])


@pytest.mark.parametrize("kid", FLOAT_ZOO)
def test_pe_cells_match(kid, rng):
    _check_cells(*_zoo_pair(kid), rng)


@pytest.mark.parametrize("direction,objective", PAIRHMM)
def test_pairhmm_pe_cells_match(direction, objective, rng):
    jspec, jparams, spec, params = _hmm_pair(direction, objective)
    assert spec.name == jspec.name and K.supports(spec) is None
    _check_cells(jspec, jparams, spec, params, rng)
    k = np.arange(40, dtype=np.int32)
    for jfn, pfn in ((jspec.init_row, spec.init_row),
                     (jspec.init_col, spec.init_col)):
        np.testing.assert_array_equal(
            pfn(params, torch.as_tensor(k)).reshape(40, 4).numpy(),
            np.asarray(jfn(jparams, jnp.asarray(k))).reshape(40, 4))


@pytest.mark.parametrize("kid", FLOAT_ZOO)
@pytest.mark.parametrize("nq,nr", SHAPES)
def test_fill_matches_jax_reference(kid, nq, nr, rng):
    """K1's plain version through ``align`` on the CPU against JAX's
    reference engine: scores (exact for sDTW), end cells exact, and the
    path rescored to the score."""
    jspec, jparams, spec, params = _zoo_pair(kid)
    q, r = _inputs(rng, spec, nq, nr)
    tb = spec.traceback is not None
    want = jalign(jspec, jparams, q, r, engine_name="reference",
                  with_traceback=tb)
    got = api.align(spec, params, q, r, with_traceback=tb, device="cpu")
    if spec.score_dtype == torch.int32:
        assert int(got.score) == int(want.score)
    else:
        np.testing.assert_allclose(float(got.score), float(want.score),
                                   rtol=1e-5)
    assert (int(got.end_i), int(got.end_j)) == \
        (int(want.end_i), int(want.end_j))
    if tb:
        np.testing.assert_allclose(rescore.rescore(spec, params, q, r, got),
                                   float(got.score), rtol=1e-5)


@pytest.mark.parametrize("kid", FLOAT_ZOO)
def test_effective_lengths(kid, rng):
    """Padded inputs with explicit lengths give the exact-size score."""
    _, _, spec, params = _zoo_pair(kid)
    q, r = _inputs(rng, spec, 24, 28)
    qp, rp = _inputs(rng, spec, 40, 40)
    qp[:24], rp[:28] = q, r
    a = api.align(spec, params, q, r, with_traceback=False, device="cpu")
    b = api.align(spec, params, qp, rp, q_len=24, r_len=28,
                  with_traceback=False, device="cpu")
    np.testing.assert_allclose(float(b.score), float(a.score), rtol=1e-5)


def test_make_knows_every_kernel():
    assert sorted(pzoo.KERNELS) == sorted(jzoo.KERNELS) == list(range(1, 18))
    for kid, (name, _, _) in jzoo.KERNELS.items():
        spec, _ = pzoo.make(kid)
        assert spec.name == name == pzoo.make(name)[0].name
    with pytest.raises(KeyError, match="#18"):
        pzoo.make(18)
    with pytest.raises(KeyError, match="nope"):
        pzoo.make("nope")


def test_supports_refuses_what_k1_does_not_instantiate():
    """What K1 refuses now that it lowers any PE its lowering accepts
    (``kernels/wavefront/synth.py``): an op outside the lowering, 64-bit
    scores.  The specs it refused before for want of a hand-written
    functor (the edit kernels, #1 at objective min, the pair-HMM over the
    whole matrix, and #9 banded, over vector characters) run on a
    generated one; they are held to JAX's wavefront engine in
    tests/test_torch_synth.py."""
    banded_dtw = pzoo.make(9, band=8)[0]
    assert K.supports(banded_dtw) is None and K.is_generated(banded_dtw)
    assert "dtw" in K.hand_written(banded_dtw)
    assert "int32 max-plus" in K.hand_written(
        pzoo.make(1, objective="min")[0])
    assert K.supports(prob.pairhmm(band=16)) is None
    assert not K.is_generated(prob.pairhmm(band=16))
    spec = dataclasses.replace(prob.pairhmm(), region="all")
    assert "last_row" in K.hand_written(spec)
    from repro_torch.core.kernels_zoo import edit
    assert "no hand-written PE family" in K.hand_written(
        edit.edit_distance())
    for flipped in (pzoo.make(1, objective="min")[0], spec,
                    edit.edit_distance()):
        assert K.supports(flipped) is None and K.is_generated(flipped)

    def sinh_pe(params, q, r, diag, up, left, i, j):
        return torch.sinh(diag), torch.zeros_like(q, dtype=torch.int32)
    odd = dataclasses.replace(prob.pairhmm(), name="sinh_hmm", pe=sinh_pe,
                              family=None)
    assert "aten.sinh" in K.supports(odd)
    wide = dataclasses.replace(pzoo.make(1)[0], family=None,
                               score_dtype=torch.int64)
    assert "64-bit scores" in K.supports(wide)


@pytest.mark.parametrize("which", ["pairhmm", "profile"])
def test_from_reference_params_carries_the_defaults(which):
    """JAX's pair-HMM and profile (#8) default dicts, carried across, are
    the port's defaults: the same keys, scalars as Python floats of the
    same value, tables as tensors of the same dtype and values."""
    jparams, want = ((jprob.default_params(), prob.default_params())
                     if which == "pairhmm" else
                     (jzoo.make(8)[1], pzoo.make(8)[1]))
    got = pzoo.from_reference_params(
        {k: np.asarray(v) for k, v in jparams.items()})
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert got[k].dtype == v.dtype and torch.equal(got[k], v)
        else:
            assert isinstance(got[k], float) and got[k] == v
