"""The port's reference engine, its ``'row'`` traceback store and the
rescorer against the JAX package, and the end cell of pairs with no live
cell (an empty query or reference, a banded corner outside the band) on
every engine of the port.

The reference engine's full (Q+1, R+1, L) matrix equals JAX's reference on
the 15 Table-1 kernels and the pair-HMM: integer kernels exactly, f32
max/min kernels to rtol 1e-5 and logsumexp to rtol 2e-5 (both with an
absolute slack of 1e-4 for values that cancel to about zero), and the
pointer store exactly (integers) or wherever the cell's scores are
bit-equal (floats; a sum semiring stores only zeros)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro import prob as jprob
from repro.core import api as japi
from repro.core import kernels_zoo as jzoo
from repro.core import traceback as jtb
from repro_torch import prob
from repro_torch.core import api, rescore
from repro_torch.core import kernels_zoo as pzoo
from repro_torch.core import traceback as ptb
from repro_torch.runtime import dispatch

from test_torch_zoo_float import _inputs

ALL15 = list(range(1, 16))
TRACEBACK = [k for k in ALL15 if jzoo.make(k)[0].traceback is not None]
SHAPES = [(32, 32), (48, 31), (17, 63)]
# pairs without a live cell: empty sequences, and corners outside the band
# of the banded kernels (band 16)
EMPTY = [(0, 5), (5, 0), (0, 0)]
OUT_OF_BAND = [(32, 1), (1, 32), (2, 64)]


def _case(name):
    """(jax spec, jax params, port spec, port params) of a zoo kernel or
    the pair-HMM forward / backward."""
    if isinstance(name, int):
        jspec, jparams = jzoo.make(name)
        spec = pzoo.make(name)[0]
    else:
        direction = name.split("_")[1]
        jspec = {"forward": jprob.pairhmm,
                 "backward": jprob.pairhmm_backward}[direction]()
        spec = {"forward": prob.pairhmm,
                "backward": prob.pairhmm_backward}[direction]()
        jparams = jprob.default_params()
    params = pzoo.from_reference_params(
        {k: np.asarray(v) for k, v in jparams.items()})
    return jspec, jparams, spec, params


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("name", ALL15 + ["pairhmm_forward",
                                          "pairhmm_backward"])
@pytest.mark.parametrize("nq,nr", SHAPES)
def test_matrix_and_row_store_match_jax(name, nq, nr, rng):
    jspec, jparams, spec, params = _case(name)
    q, r = _inputs(rng, spec, nq, nr)
    if spec.name == "protein_local":
        q, r = (rng.integers(0, 20, n).astype(np.uint8) for n in (nq, nr))
    want = japi.fill(jspec, jparams, q, r, engine_name="reference")
    got = api.fill(spec, params, q, r, engine_name="reference",
                   device="cpu")
    assert got.tb_layout == "row"
    wm, gm = np.asarray(want.matrix), _np(got.matrix)
    wt, gt = np.asarray(want.tb), _np(got.tb)
    assert gm.shape == wm.shape and gt.shape == wt.shape
    for f in ("end_i", "end_j"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    if spec.score_dtype == torch.int32:
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gt, wt)
        assert int(got.score) == int(want.score)
        return
    rtol = 2e-5 if spec.is_sum else 1e-5
    np.testing.assert_allclose(gm, wm, rtol=rtol, atol=1e-4)
    np.testing.assert_allclose(float(got.score), float(want.score),
                               rtol=rtol)
    if spec.is_sum:                 # a sum semiring stores no pointer
        np.testing.assert_array_equal(gt, wt)
        return
    same = (gm == wm).all(axis=-1)
    assert same.mean() > 0.9
    np.testing.assert_array_equal(gt[same], wt[same])


@pytest.mark.parametrize("kid", TRACEBACK)
@pytest.mark.parametrize("engine", ["reference", "wavefront"])
def test_path_rescores_to_score(kid, engine, rng):
    """Each engine's path re-scores to its score and lands on its end
    cell; the 'row' walk of the reference engine equals JAX's."""
    jspec, jparams, spec, params = _case(kid)
    nq, nr = 40, 44
    if spec.band is not None and abs(nq - nr) > spec.band:
        nq = nr
    q, r = _inputs(rng, spec, nq, nr)
    if spec.name == "protein_local":
        q, r = (rng.integers(0, 20, n).astype(np.uint8) for n in (nq, nr))
    a = api.align(spec, params, q, r, engine_name=engine, device="cpu")
    got = rescore.rescore(spec, params, q, r, a)
    np.testing.assert_allclose(got, float(a.score), rtol=1e-5, atol=1e-3)
    if engine == "reference":
        want = japi.align(jspec, jparams, q, r, engine_name="reference")
        assert ptb.moves_to_cigar(a.moves, a.n_moves) == \
            jtb.moves_to_cigar(want.moves, want.n_moves)
        assert (int(a.start_i), int(a.start_j)) == \
            (int(want.start_i), int(want.start_j))


def _padded(spec, rng, nq, nr):
    """Length-nq/nr sequences padded by one character (so that JAX has a
    non-empty array), with the effective lengths to pass."""
    q, r = _inputs(rng, spec, nq + 1, nr + 1)
    if spec.name == "protein_local":
        q, r = (rng.integers(0, 20, n + 1).astype(np.uint8)
                for n in (nq, nr))
    return q, r


@pytest.mark.parametrize("kid", ALL15)
def test_empty_and_out_of_band_pairs_match_jax_reference(kid, rng):
    """With no live cell in the objective region the score is the
    sentinel, the end cell (0, 0), the walk has no move and the CIGAR is
    '' — on the port's wavefront (K1's plain version, single and batched)
    and reference engines, as on JAX's reference."""
    jspec, jparams, spec, params = _case(kid)
    tb = spec.traceback is not None
    # a banded global corner outside the band is no live cell (#11, #13);
    # a banded local kernel (#12) still has cells near the origin
    corner = spec.band is not None and spec.region == "corner"
    cases = EMPTY + (OUT_OF_BAND if corner else [])
    padded = [_padded(spec, rng, nq, nr) for nq, nr in cases]
    batched = dispatch.run_pairs(
        spec, params, [(q[:nq], r[:nr]) for (q, r), (nq, nr)
                       in zip(padded, cases)],
        block=4, with_traceback=tb, device="cpu")
    for (nq, nr), (q, r), row in zip(cases, padded, batched):
        want = japi.align(jspec, jparams, q, r, q_len=nq, r_len=nr,
                          engine_name="reference", with_traceback=tb)
        assert (int(want.end_i), int(want.end_j)) == (0, 0)
        for engine in ("wavefront", "reference"):
            got = api.align(spec, params, q, r, q_len=nq, r_len=nr,
                            engine_name=engine, with_traceback=tb,
                            device="cpu")
            for res in (got, row) if engine == "wavefront" else (got,):
                what = (engine, nq, nr)
                assert float(res.score) == float(want.score), what
                assert (int(res.end_i), int(res.end_j)) == (0, 0), what
                if tb:
                    assert int(res.n_moves) == int(want.n_moves) == 0, what
                    assert ptb.moves_to_cigar(res.moves, res.n_moves) == \
                        jtb.moves_to_cigar(want.moves, want.n_moves) \
                        == "", what
                    assert (int(res.start_i), int(res.start_j)) == \
                        (int(want.start_i), int(want.start_j)), what


def test_reference_engine_runs_a_batch(rng):
    """One batched call of the engine equals the pairs one at a time."""
    from repro_torch.runtime import registry
    spec, params = pzoo.make(2)
    eng = registry.get_engine("reference")
    qs = torch.as_tensor(rng.integers(0, 4, (3, 20)).astype(np.uint8))
    rs = torch.as_tensor(rng.integers(0, 4, (3, 24)).astype(np.uint8))
    ql, rl = torch.tensor([20, 11, 7]), torch.tensor([24, 24, 13])
    res = eng(spec, params, qs, rs, ql, rl)
    assert res.matrix.shape == (3, 21, 25, 3) and res.tb.shape == (3, 21, 25)
    for b in range(3):
        one = eng(spec, params, qs[b:b + 1], rs[b:b + 1], ql[b:b + 1],
                  rl[b:b + 1])
        assert torch.equal(one.matrix[0], res.matrix[b])
        assert (int(one.score[0]), int(one.end_i[0]), int(one.end_j[0])) \
            == (int(res.score[b]), int(res.end_i[b]), int(res.end_j[b]))
