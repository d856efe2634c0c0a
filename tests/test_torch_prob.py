"""The probabilistic subsystem of the PyTorch port (``repro_torch.prob``)
against the JAX package's ``repro.prob``: the forward likelihood against
the path-enumeration oracles, logsumexp and backward parity with JAX's
reference engine, the Viterbi bound, banding, padding, batched dispatch,
posterior decoding and genotyping end to end, all on the CPU (K1's plain
version and the port's reference engine).

Tolerances: likelihoods match JAX's engines to rtol 2e-5 (what
tests/test_prob.py holds JAX's own engines to) and the oracle to rel 1e-4;
posterior matrices to 1e-4."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro import prob as jprob
from repro.core import align as jalign
from repro.data.synthetic import sample_site as jsample_site
from repro_torch import prob
from repro_torch.core import api, alphabets, types as T
from repro_torch.core import kernels_zoo as pzoo
from repro_torch.core import semiring as semiring_mod
from repro_torch.data.synthetic import sample_site
from repro_torch.runtime import dispatch, plan as plan_mod
from repro_torch.runtime import registry

PARAMS = prob.default_params()
JPARAMS = jprob.default_params()
GENOTYPE_SITES = [(0, 0), (0, 1), (1, 1)]


def _pair(rng, nq, nr):
    return (rng.integers(0, 4, nq).astype(np.uint8),
            rng.integers(0, 4, nr).astype(np.uint8))


def _score(spec, q, r, engine="wavefront", params=PARAMS, **kw):
    return float(api.align(spec, params, q, r, engine_name=engine,
                           with_traceback=False, device="cpu", **kw).score)


@pytest.mark.parametrize("nq,nr", [(1, 1), (2, 3), (3, 2), (4, 4), (3, 6)])
def test_forward_matches_enumeration_oracle(nq, nr, rng):
    """The port's oracle equals JAX's, and both engines equal it."""
    spec = prob.cached_pairhmm()
    for _ in range(3):
        q, r = _pair(rng, nq, nr)
        want = prob.oracle_forward(PARAMS, q, r)
        assert want == jprob.oracle_forward(JPARAMS, q, r)
        for engine in ("reference", "wavefront"):
            assert _score(spec, q, r, engine) == \
                pytest.approx(want, rel=1e-4), (engine, nq, nr)


def test_forward_oracle_other_params(rng):
    spec = prob.cached_pairhmm()
    for delta, eps, mp in [(0.05, 0.3, 0.8), (0.4, 0.05, 0.99)]:
        params = prob.default_params(delta=delta, eps=eps, match_p=mp)
        q, r = _pair(rng, 3, 4)
        want = prob.oracle_forward(params, q, r)
        assert _score(spec, q, r, params=params) == \
            pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("engine", ["wavefront", "reference",
                                    "wavefront_band128"])
@pytest.mark.parametrize("nq,nr", [(32, 32), (48, 31), (17, 63)])
def test_logsumexp_matches_jax_reference(engine, nq, nr, rng):
    banded = engine.endswith("band128")
    spec = prob.cached_pairhmm(band=128 if banded else None)
    q, r = _pair(rng, nq, nr)
    want = jalign(jprob.cached_pairhmm(), JPARAMS, q, r,
                  engine_name="reference", with_traceback=False)
    got = api.align(spec, PARAMS, q, r, engine_name=engine.split("_")[0],
                    with_traceback=False, device="cpu")
    np.testing.assert_allclose(float(got.score), float(want.score),
                               rtol=2e-5)
    assert (int(got.end_i), int(got.end_j)) == (0, 0)


@pytest.mark.parametrize("engine", ["wavefront", "reference"])
def test_backward_matches_jax_reference(engine, rng):
    q, r = _pair(rng, 40, 44)
    qr, rr = q[::-1].copy(), r[::-1].copy()
    want = jalign(jprob.cached_pairhmm_backward(), JPARAMS, qr, rr,
                  engine_name="reference", with_traceback=False)
    got = _score(prob.cached_pairhmm_backward(), qr, rr, engine)
    np.testing.assert_allclose(got, float(want.score), rtol=2e-5)
    # the backward fold is the same mass as the forward likelihood
    assert got == pytest.approx(_score(prob.cached_pairhmm(), q, r),
                                rel=1e-5)


def test_viterbi_mode_bounds_forward(rng):
    q, r = _pair(rng, 24, 24)
    fwd = _score(prob.cached_pairhmm(), q, r)
    vit = _score(prob.cached_pairhmm("max"), q, r)
    assert vit <= fwd + 1e-4
    want = jalign(jprob.cached_pairhmm("max"), JPARAMS, q, r,
                  engine_name="reference", with_traceback=False)
    np.testing.assert_allclose(vit, float(want.score), rtol=1e-5)
    ident = np.arange(16, dtype=np.uint8) % 4
    fwd_i = _score(prob.cached_pairhmm(), ident, ident)
    vit_i = _score(prob.cached_pairhmm("max"), ident, ident)
    assert vit_i <= fwd_i and fwd_i - vit_i < 1.0


def test_banded_forward_converges_to_full(rng):
    q, r = _pair(rng, 32, 32)
    full = _score(prob.cached_pairhmm(), q, r)
    wide = _score(prob.cached_pairhmm(band=64), q, r)
    tight = _score(prob.cached_pairhmm(band=4), q, r)
    assert wide == pytest.approx(full, rel=1e-6)
    assert tight <= full + 1e-4


def test_padded_lengths_no_drift(rng):
    """Bucket padding with effective lengths is mass-neutral."""
    spec = prob.cached_pairhmm()
    eng = registry.get_engine("wavefront")
    q, r = _pair(rng, 21, 27)
    exact = float(eng(spec, PARAMS, torch.as_tensor(q)[None],
                      torch.as_tensor(r)[None]).score[0])
    qp = np.zeros(64, np.uint8)
    qp[:21] = q
    rp = np.zeros(64, np.uint8)
    rp[:27] = r
    padded = float(eng(spec, PARAMS, torch.as_tensor(qp)[None],
                       torch.as_tensor(rp)[None], torch.tensor([21]),
                       torch.tensor([27])).score[0])
    assert np.isfinite(padded)
    assert padded == pytest.approx(exact, rel=1e-5)


def test_run_pairs_batched_matches_single(rng):
    plan_mod.clear_plan_cache()
    spec = prob.cached_pairhmm()
    pairs = [_pair(rng, int(rng.integers(8, 60)), int(rng.integers(8, 60)))
             for _ in range(9)]
    outs = dispatch.run_pairs(spec, PARAMS, pairs, block=4,
                              with_traceback=False, device="cpu")
    for (q, r), out in zip(pairs, outs):
        assert float(out.score) == pytest.approx(_score(spec, q, r),
                                                 rel=2e-5)
    keys = plan_mod.plan_cache_info()["keys"]
    assert any(k.semiring == "logsumexp" and k.batch_size == 4
               for k in keys)


def test_sum_semiring_rejects_traceback_and_int_dtype():
    from repro_torch.core.kernels_zoo import common as C
    with pytest.raises(ValueError, match="floating"):
        T.DPKernelSpec(name="bad", n_layers=1, pe=lambda *a: None,
                       init_row=None, init_col=None, objective="logsumexp",
                       score_dtype=torch.int32)
    with pytest.raises(ValueError, match="trace"):
        T.DPKernelSpec(name="bad", n_layers=1, pe=lambda *a: None,
                       init_row=None, init_col=None, objective="logsumexp",
                       score_dtype=torch.float32,
                       traceback=C.linear_tb(T.STOP_ORIGIN))
    with pytest.raises(ValueError, match="objective"):
        semiring_mod.from_objective("product")


def test_posterior_identities(rng):
    for _ in range(3):
        q, r = _pair(rng, int(rng.integers(4, 16)), int(rng.integers(4, 20)))
        post = prob.forward_backward(PARAMS, q, r, device="cpu")
        assert post.log_z_backward == pytest.approx(post.log_z, rel=1e-4)
        rows = post.post_match.sum(axis=1) + post.post_ins.sum(axis=1)
        np.testing.assert_allclose(rows, 1.0, atol=5e-4)


def test_posterior_diagonal_for_identical_pair():
    q = np.arange(12, dtype=np.uint8) % 4
    post = prob.forward_backward(PARAMS, q, q, device="cpu")
    assert (np.diag(post.post_match) > 0.5).all()
    assert (post.map_path == np.arange(12)).all()


@pytest.mark.parametrize("nq,nr", [(10, 14), (23, 31)])
def test_posterior_matches_jax(nq, nr, rng):
    q, r = _pair(rng, nq, nr)
    got = prob.forward_backward(PARAMS, q, r, device="cpu")
    want = jprob.forward_backward(JPARAMS, q, r)
    assert got.log_z == pytest.approx(want.log_z, rel=2e-5)
    assert got.log_z_backward == pytest.approx(want.log_z_backward,
                                               rel=2e-5)
    np.testing.assert_allclose(got.post_match, want.post_match, atol=1e-4)
    np.testing.assert_allclose(got.post_ins, want.post_ins, atol=1e-4)
    np.testing.assert_array_equal(got.map_path, want.map_path)


def test_posterior_refuses_empty_and_score_only_engines():
    with pytest.raises(ValueError, match="non-empty"):
        prob.forward_backward(PARAMS, np.zeros(0, np.uint8),
                              np.ones(3, np.uint8), device="cpu")
    with pytest.raises(ValueError, match="score matrix"):
        prob.forward_backward(PARAMS, np.ones(3, np.uint8),
                              np.ones(3, np.uint8), engine_name="wavefront",
                              device="cpu")


@pytest.mark.parametrize("truth", GENOTYPE_SITES)
def test_call_site_recovers_genotype(truth):
    site = sample_site(seed=11 * sum(truth) + 3, n_reads=10,
                       genotype=truth, error_rate=0.01)
    out = prob.call_site(site.reads, site.haplotypes, device="cpu")
    assert out["GT"] == truth
    assert out["GQ"] > 0
    assert out["PL"][out["genotypes"].index(truth)] == 0
    assert out["ll"].shape == (10, 2)
    want = jprob.call_site(site.reads, site.haplotypes)
    assert (out["GT"], out["GQ"], out["PL"]) == \
        (want["GT"], want["GQ"], want["PL"])


@pytest.mark.parametrize("seed,n_alts,genotype", [(5, 1, (0, 1)),
                                                  (7, 3, (1, 3))])
def test_read_hap_log_likelihoods_match_jax(seed, n_alts, genotype):
    site = sample_site(seed=seed, hap_len=96, read_len=40, n_reads=6,
                       n_alts=n_alts, genotype=genotype, error_rate=0.01)
    got = prob.read_hap_log_likelihoods(site.reads, site.haplotypes,
                                        block=8, device="cpu")
    want = jprob.read_hap_log_likelihoods(site.reads, site.haplotypes)
    assert got.shape == (6, n_alts + 1)
    np.testing.assert_allclose(got, want, rtol=2e-5)


@pytest.mark.parametrize("seed", [0, 3, 1023])
def test_sample_site_matches_jax(seed):
    kw = dict(hap_len=80, read_len=30, n_reads=7, error_rate=0.05,
              genotype=(1, 3), n_alts=3)
    got, want = sample_site(seed, **kw), jsample_site(seed, **kw)
    assert (got.genotype, got.variant_pos) == \
        (want.genotype, want.variant_pos)
    for a, b in zip(got.haplotypes + got.reads,
                    want.haplotypes + want.reads):
        np.testing.assert_array_equal(a, b)
    assert len(got.reads) == len(want.reads) == 7
    with pytest.raises(ValueError, match="n_alts"):
        sample_site(n_alts=4)


def test_params_carried_from_jax_give_the_same_likelihoods(rng):
    """JAX's ``prob.default_params()`` as numpy arrays, carried across by
    ``from_reference_params``, give JAX's likelihoods in the port."""
    jparams = jprob.default_params(delta=0.1, eps=0.3, match_p=0.95)
    params = pzoo.from_reference_params(
        {k: np.asarray(v) for k, v in jparams.items()})
    reads = [_pair(rng, 20, 1)[0] for _ in range(3)]
    haps = [_pair(rng, 1, 50)[1] for _ in range(2)]
    got = prob.read_hap_log_likelihoods(reads, haps, params, device="cpu")
    want = jprob.read_hap_log_likelihoods(reads, haps, jparams)
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_genotype_enumeration_and_hap_norm(rng):
    assert prob.genotypes(2, 2) == [(0, 0), (0, 1), (1, 1)]
    assert len(prob.genotypes(3, 2)) == 6
    read = alphabets.random_dna(rng, 24)
    hap = np.concatenate([alphabets.random_dna(rng, 20), read,
                          alphabets.random_dna(rng, 20)])
    long_hap = np.concatenate([hap, alphabets.random_dna(rng, 64)])
    ll = prob.read_hap_log_likelihoods([read], [hap, long_hap], PARAMS,
                                       device="cpu")
    assert abs(ll[0, 0] - ll[0, 1]) < 1.0


def test_entry_points_refuse_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    site = sample_site(seed=1, n_reads=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prob.call_site(site.reads, site.haplotypes)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prob.forward_backward(PARAMS, site.reads[0], site.haplotypes[0])
