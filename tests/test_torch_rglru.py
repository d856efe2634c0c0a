"""The port's RG-LRU mixer (``repro_torch.models.mixers``: the gates, the
doubling scan ``lru_scan`` and ``rglru_apply`` in train, prefill and
decode) against the JAX package's ``repro.models.mixers.rglru_apply``, on
recurrentgemma-9b's reduced config in f32, every parameter moved off its
initial value by N(0, 0.1) noise (so the gates and decay span a range), at
sequence lengths that are and are not powers of two.

Tolerances: 2e-6 for the gates (the same f32 ops on one input), 1e-5
relative to the largest |h| for the scan against a sequential f32 loop and
JAX's ``lax.associative_scan`` (the partial sums are taken in other
orders), and the mixer tolerance of ``tests/test_torch_lm.py`` (1e-4) for
the mixer's output."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mixers as jmixers
from repro.models import params as jparams
from repro_torch import configs as pconfigs
from repro_torch.models import mixers

MIXER_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs():
    return (jconfigs.get("recurrentgemma-9b", reduced=True),
            pconfigs.get("recurrentgemma-9b", reduced=True))


def _params(cfg, seed=3):
    p = jparams.init_params(jax.random.PRNGKey(seed),
                            jmixers.rglru_defs(cfg), jnp.float32)
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32)),
        p)
    return jp, jax.tree.map(lambda a: torch.as_tensor(np.array(a)), jp)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _ctx(mode, S, torch_side, k_len=None):
    pos = np.arange(S, dtype=np.int32)[None]
    conv = torch.as_tensor if torch_side else jnp.asarray
    ctx = {"mode": mode, "positions": conv(pos)}
    if k_len is not None:
        ctx["k_len"] = conv(k_len)
    return ctx


def test_gates_match_jax(rng):
    jc, _ = _cfgs()
    jp, pp = _params(jc)
    u = rng.normal(size=(2, 9, jc.lru_width)).astype(np.float32)
    for want, got in zip(jmixers._lru_gates(jp, jnp.asarray(u)),
                         mixers._lru_gates(pp, torch.as_tensor(u))):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-6,
                                   atol=2e-6)


@pytest.mark.parametrize("S", [1, 2, 31, 32, 33, 64, 100])
def test_scan_matches_a_loop_and_jax(S, rng):
    """h_t = exp(log a_t) h_(t-1) + b_t from h = 0: the doubling scan
    against a sequential loop over positions and against JAX's
    ``lax.associative_scan`` with ``rglru_apply``'s combine."""
    log_a = -rng.uniform(0.01, 6.0, size=(2, S, 24)).astype(np.float32)
    b = rng.normal(size=(2, S, 24)).astype(np.float32)
    got = _np(mixers.lru_scan(torch.as_tensor(log_a), torch.as_tensor(b)))
    h, want = np.zeros((2, 24), np.float32), np.zeros_like(b)
    for t in range(S):
        h = np.exp(log_a[:, t]) * h + b[:, t]
        want[:, t] = h

    def combine(c1, c2):
        return c1[0] + c2[0], jnp.exp(c2[0]) * c1[1] + c2[1]
    _, jh = jax.lax.associative_scan(combine, (jnp.asarray(log_a),
                                               jnp.asarray(b)), axis=1)
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * top
    assert np.abs(got - np.asarray(jh)).max() <= 1e-5 * top


@pytest.mark.parametrize("S", [3, 32, 45])
def test_rglru_train_prefill_decode_match_jax(S, rng):
    """Train on S positions; prefill of S - 1 then a decode step of the
    last (the f32 h and the conv state carried in the cache); both
    packages' caches equal.  S 3 leaves a prefill shorter than the conv's
    CW - 1 = 3 positions of history, whose conv state JAX slices from the
    end (and so the port)."""
    jc, pc = _cfgs()
    jp, pp = _params(jc)
    x = rng.normal(size=(2, S, jc.d_model)).astype(np.float32)
    want, _ = jmixers.rglru_apply(jc, jp, jnp.asarray(x),
                                  _ctx("train", S, False), None)
    got, none = mixers.rglru_apply(pc, pp, torch.as_tensor(x),
                                   _ctx("train", S, True), None)
    assert none is None
    np.testing.assert_allclose(_np(got), _np(want), **MIXER_TOL)

    jy, jcache = jmixers.rglru_apply(jc, jp, jnp.asarray(x[:, :S - 1]),
                                     _ctx("prefill", S - 1, False), None)
    py, pcache = mixers.rglru_apply(pc, pp, torch.as_tensor(x[:, :S - 1]),
                                    _ctx("prefill", S - 1, True), None)
    np.testing.assert_allclose(_np(py), _np(jy), **MIXER_TOL)
    assert set(pcache) == {"h", "conv"}
    assert pcache["h"].dtype == torch.float32
    for k in pcache:
        assert tuple(pcache[k].shape) == tuple(jcache[k].shape), k
        np.testing.assert_allclose(_np(pcache[k]), _np(jcache[k]),
                                   **MIXER_TOL)
    if S - 1 < jc.conv_width - 1:        # the decode's history is JAX's
        return                           # (B, CW - 1, W) ring
    k_len = np.full((2,), S - 1, np.int32)
    jy, jnew = jmixers.rglru_apply(jc, jp, jnp.asarray(x[:, S - 1:]),
                                   _ctx("decode", 1, False, k_len), jcache)
    py, pnew = mixers.rglru_apply(pc, pp, torch.as_tensor(x[:, S - 1:]),
                                  _ctx("decode", 1, True, k_len), pcache)
    np.testing.assert_allclose(_np(py), _np(jy), **MIXER_TOL)
    np.testing.assert_allclose(_np(py), _np(got)[:, S - 1:], **MIXER_TOL)
    for k in pnew:
        np.testing.assert_allclose(_np(pnew[k]), _np(jnew[k]), **MIXER_TOL)


def test_grow_cache_leaves_the_recurrent_state_alone():
    """``lm.grow_cache`` pads the attention ring and no RG-LRU leaf: h
    (B, W) f32 and conv (B, CW - 1, W) keep their shape and values."""
    from repro_torch.models import lm
    _, pc = _cfgs()
    cache = lm.init_cache(pc, 2, 8, "cpu")
    for t in (cache[0]["sub0"]["mixer"]["h"], cache[0]["sub0"]["mixer"][
            "conv"]):
        t.normal_()
    grown = lm.grow_cache(pc, cache, 2, 40)
    for sub in ("sub0", "sub1"):
        for leaf in ("h", "conv"):
            assert grown[0][sub]["mixer"][leaf] is cache[0][sub]["mixer"][
                leaf]
    assert grown[0]["sub0"]["mixer"]["h"].shape == (1, 2, pc.lru_width)
    assert grown[0]["sub0"]["mixer"]["conv"].shape == \
        (1, 2, pc.conv_width - 1, pc.lru_width)
