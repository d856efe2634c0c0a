"""Public API of the PyTorch port (``align``, ``score_only``, ``fill``,
``align_batch``) against the JAX package on the CPU: exactly equal to JAX's
``reference`` engine on every field and the CIGAR, and to JAX's default
``wavefront`` engine on scores (on every field for the corner-region
kernels, where the two tie-break rules pick the same end cell).  Also the
device rule, the plan cache and the registry's errors."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import batch as jbatch
from repro.core import traceback as jtb
from repro_torch.core import api, batch
from repro_torch.core import traceback as ptb
from repro_torch.core import kernels_zoo as pzoo
from repro_torch.runtime import plan as plan_mod
from repro_torch.runtime import registry

from torch_parity import (PORTED, assert_same_alignment, kernel_pair,
                          random_codes, to_np)

CORNER = [1, 2, 5, 11, 13]


def _pair_codes(rng, spec, nq=40, nr=37):
    q = random_codes(rng, spec, nq)
    if spec.band is not None:            # keep the corner inside the band
        return q, q[: nq - 3].copy()
    return q, random_codes(rng, spec, nr)


@pytest.mark.parametrize("kid", PORTED)
def test_align_matches_reference_engine(kid, rng):
    jspec, jparams, spec, params = kernel_pair(kid)
    q, r = _pair_codes(rng, spec)
    want = japi.align(jspec, jparams, q, r, engine_name="reference")
    got = api.align(spec, params, q, r, device="cpu")
    assert_same_alignment(want, got)
    assert int(api.score_only(spec, params, q, r, device="cpu")) == \
        int(want.score)


@pytest.mark.parametrize("kid", PORTED)
def test_align_matches_xla_wavefront(kid, rng):
    jspec, jparams, spec, params = kernel_pair(kid)
    q, r = _pair_codes(rng, spec, 33, 29)
    want = japi.align(jspec, jparams, q, r)          # JAX default engine
    got = api.align(spec, params, q, r, device="cpu")
    assert int(to_np(got.score)) == int(to_np(want.score))
    if kid in CORNER:
        assert_same_alignment(want, got)


@pytest.mark.parametrize("kid", [2, 4, 13, 15])
def test_align_batch_matches_reference_engine(kid, rng):
    jspec, jparams, spec, params = kernel_pair(kid)
    B, Q, R = 4, 32, 32
    qs = np.stack([random_codes(rng, spec, Q) for _ in range(B)])
    rs = np.stack([random_codes(rng, spec, R) for _ in range(B)])
    if spec.band is not None:
        rs[:, :20] = qs[:, :20]
    ql = np.array([32, 20, 27, 9], np.int32)
    rl = np.array([30, 25, 27, 12], np.int32)
    want = jbatch.align_batch(jspec, jparams, qs, rs, ql, rl,
                              engine_name="reference")
    got = batch.align_batch(spec, params, qs, rs, ql, rl, device="cpu")
    assert_same_alignment(want, got, moves=False)
    if want.moves is not None:
        np.testing.assert_array_equal(to_np(got.moves), to_np(want.moves))


@pytest.mark.parametrize("strip", [1, 8])
def test_align_batch_strip_matches_jax(strip):
    """``align_batch(strip=)`` forwards the schedule to the plan: #2 on 4
    random pairs of 32 from ``default_rng(0)`` equals JAX's
    ``align_batch(..., strip=)`` (scores [-13, -32, -20, -21], end cells,
    moves, CIGARs; #2 is a corner-region kernel, where the two engines'
    tie-break rules agree) and the port's default plan."""
    jspec, jparams, spec, params = kernel_pair(2)
    rng = np.random.default_rng(0)
    qs = np.stack([random_codes(rng, spec, 32) for _ in range(4)])
    rs = np.stack([random_codes(rng, spec, 32) for _ in range(4)])
    want = jbatch.align_batch(jspec, jparams, qs, rs, strip=strip)
    got = batch.align_batch(spec, params, qs, rs, strip=strip, device="cpu")
    np.testing.assert_array_equal(to_np(got.score), [-13, -32, -20, -21])
    default = batch.align_batch(spec, params, qs, rs, device="cpu")
    for other in (want, default):
        assert_same_alignment(other, got, moves=False)
        np.testing.assert_array_equal(to_np(got.moves), to_np(other.moves))
    for i in range(4):
        assert ptb.moves_to_cigar(got.moves[i], got.n_moves[i]) == \
            jtb.moves_to_cigar(np.asarray(want.moves)[i], want.n_moves[i])


def test_fill_returns_chunk_store(rng):
    spec, params = pzoo.make(2)
    q, r = _pair_codes(rng, spec)
    res = api.fill(spec, params, q, r, device="cpu")
    assert res.tb_layout == ("chunk", 32, 2)
    assert tuple(res.tb.shape) == (64 // 32, 16, 32 + 64 - 1)


def test_entry_points_refuse_to_fall_back(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, params = pzoo.make(1)
    q, r = _pair_codes(rng, spec)
    calls = [lambda: api.align(spec, params, q, r),
             lambda: api.score_only(spec, params, q, r),
             lambda: api.fill(spec, params, q, r),
             lambda: batch.align_batch(spec, params, q[None], r[None])]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_plan_cache_reused_within_a_bucket(rng):
    spec, params = pzoo.make(2)
    plan_mod.clear_plan_cache()
    for n in (40, 50, 60):               # all in the 64 bucket
        api.align(spec, params, random_codes(rng, spec, n),
                  random_codes(rng, spec, n - 5), device="cpu")
    info = plan_mod.plan_cache_info()
    assert info["size"] == 1
    assert info["misses"] == 1 and info["hits"] == 2
    assert info["plans"][0]["calls"] == 3
    key = info["keys"][0]
    assert (key.device, key.tb_pack, key.bucket_shape) == \
        ("cpu", 2, ((64,), (64,)))
    assert plan_mod.plan_key_str(key) == \
        "global_affine/wavefront/64x64/b1/tb/align/p2/maxplus/cpu"


def test_registry_and_option_errors():
    assert registry.available_engines() == ["banded", "myers", "reference",
                                            "wavefront"]
    with pytest.raises(ValueError, match=r"unknown engine 'pallas'; have "
                                         r"\['banded', 'myers', 'reference', "
                                         r"'wavefront'\]"):
        registry.get_engine("pallas")
    spec, _ = pzoo.make(2)
    with pytest.raises(ValueError, match="valid options: \\['strip', "
                                         "'strip_warps', 'tb_pack', "
                                         "'xdrop'\\]"):
        plan_mod.resolve_engine_options(spec, "wavefront", {"blocksize": 2})
    with pytest.raises(ValueError, match="must be an integer"):
        plan_mod.resolve_engine_options(spec, "wavefront", {"tb_pack": 2.5})
    # a K1 plan pins strip, which K1 ignores, to its neutral 1
    assert plan_mod.resolve_engine_options(spec, "wavefront") == \
        {"strip": 1, "tb_pack": 2, "xdrop": None, "strip_warps": None}
    assert plan_mod.traceback_bytes(spec, 64, 64) == 2 * 16 * 95
    score_only_spec, _ = pzoo.make(12)
    assert plan_mod.traceback_bytes(score_only_spec, 64, 64) == 0


def test_single_walk_and_truncation(rng):
    spec, params = pzoo.make(4)
    q, r = _pair_codes(rng, spec)
    res = api.fill(spec, params, q, r, device="cpu")
    walked = ptb.run(spec, res, max_len=64 + 64 + 1)
    assert_same_alignment(api.align(spec, params, q, r, device="cpu"),
                          walked)
    assert not bool(walked.truncated)
    short = ptb.run(spec, res, max_len=2)
    assert bool(short.truncated)
    with pytest.raises(ptb.TracebackTruncated):
        ptb.raise_if_truncated(short)
