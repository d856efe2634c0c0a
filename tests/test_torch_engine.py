"""The port's eager wavefront engine (``repro_torch.core.engine``), its
'diag' traceback store, and the X-drop route of the ``wavefront`` engine
against the JAX package's XLA engine, on the same numpy-seeded inputs.

Integer kernels are held exactly (score, end cell, pointer store, CIGAR);
float kernels (#8, #9, #10) to rtol 1e-5 on the score with exact end cells.
The JAX side runs ``repro.core.engine.run`` vmapped over the pairs under one
``jax.jit`` per (kernel, strip, xdrop on/off), with ``xdrop`` a traced
argument so that its three values share one compile."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from torch_parity import (assert_same_alignment, kernel_pair, random_codes,
                          to_np)

from repro_torch.core import api
from repro_torch.core import engine as peng
from repro_torch.core import kernels_zoo as pzoo
from repro_torch.core import traceback as ptb
from repro_torch.core import types as PT
from repro_torch.runtime import dispatch
from repro_torch.runtime import plan as plan_mod
from repro_torch.runtime import registry

FLOAT_KERNELS = (8, 9, 10)
XDROPS = (2, 10, 10 ** 6)
B, Q, R = 3, 20, 24
QL = np.array([20, 15, 7], np.int32)
RL = np.array([24, 13, 10], np.int32)


def _codes(rng, kid, spec, n, length):
    if kid == 8:
        from repro.core.kernels_zoo.profile import make_profile
        return np.stack([make_profile(rng, length) for _ in range(n)])
    if kid == 9:
        return rng.normal(size=(n, length, 2)).astype(np.float32)
    if kid == 14:
        return rng.integers(0, 128, (n, length)).astype(np.int32)
    return np.stack([random_codes(rng, spec, length) for _ in range(n)])


def _inputs(kid, spec, seed=0):
    """Pairs whose reference starts with a mutated copy of the query, so
    X-drop prunes some cells and keeps others."""
    rng = np.random.default_rng(seed + kid)
    qs = _codes(rng, kid, spec, B, Q)
    rs = _codes(rng, kid, spec, B, R)
    keep = rng.random((B, Q)) > 0.15
    rs[:, :Q][keep] = qs[keep]
    return qs, rs


def _jax_fill_walk(jspec, jparams, strip, with_xdrop):
    """jit(vmap(engine.run)) over the pairs, plus the batched walk when the
    kernel has a traceback; ``xdrop`` is the last (traced) argument."""
    import jax
    from repro.core import engine as jeng
    from repro.core import traceback as jtb

    def one(p, q, r, ql, rl, xd):
        return jeng.run(jspec, p, q, r, ql, rl, strip=strip,
                        xdrop=xd if with_xdrop else None)

    def fn(p, q, r, ql, rl, xd):
        res = jax.vmap(one, in_axes=(None, 0, 0, 0, 0, None))(
            p, q, r, ql, rl, xd)
        aln = (jtb.run_batched(jspec, res, max_len=Q + R + 1)
               if jspec.traceback is not None else None)
        return res, aln
    return jax.jit(fn)


def _port_fill_walk(spec, params, qs, rs, strip, xdrop):
    res = peng.run(spec, params, torch.as_tensor(qs), torch.as_tensor(rs),
                   torch.as_tensor(QL), torch.as_tensor(RL), strip=strip,
                   xdrop=xdrop)
    aln = (ptb.run_batched(spec, res, max_len=Q + R + 1)
           if spec.traceback is not None else None)
    return res, aln


def _row(aln, b):
    return PT.Alignment(**{k: (None if v is None else to_np(v)[b])
                           for k, v in vars(aln).items()})


def _hold(kid, want, got, what):
    (wres, waln), (gres, galn) = want, got
    if kid in FLOAT_KERNELS:
        np.testing.assert_allclose(to_np(gres.score), np.asarray(wres.score),
                                   rtol=1e-5, err_msg=f"{what}: score")
    else:
        np.testing.assert_array_equal(to_np(gres.score),
                                      np.asarray(wres.score),
                                      err_msg=f"{what}: score")
        if wres.tb is not None:
            assert gres.tb_layout == wres.tb_layout
            np.testing.assert_array_equal(to_np(gres.tb), np.asarray(wres.tb),
                                          err_msg=f"{what}: pointer store")
    for f in ("end_i", "end_j"):
        np.testing.assert_array_equal(to_np(getattr(gres, f)),
                                      np.asarray(getattr(wres, f)),
                                      err_msg=f"{what}: {f}")
    if waln is None:
        return
    fields = ("end_i", "end_j", "start_i", "start_j", "n_moves")
    if kid not in FLOAT_KERNELS:
        fields = ("score",) + fields
    for b in range(B):
        assert_same_alignment(_row(waln, b), _row(galn, b), fields=fields)


@pytest.mark.parametrize("kid", range(1, 16))
def test_engine_matches_jax(kid):
    """Every max/min kernel of #1-15 (JAX's wavefront runs them all), xdrop
    in {None, 2, 10, 10**6}, strip in {1, 8}: score, end cell, pointer
    store and CIGAR."""
    jspec, jparams, spec, params = kernel_pair(kid)
    qs, rs = _inputs(kid, spec)
    for strip in (1, 8):
        for with_xdrop, values in ((False, (None,)), (True, XDROPS)):
            fn = _jax_fill_walk(jspec, jparams, strip, with_xdrop)
            for xdrop in values:
                want = fn(jparams, qs, rs, QL, RL,
                          np.int32(0 if xdrop is None else xdrop))
                got = _port_fill_walk(spec, params, qs, rs, strip, xdrop)
                _hold(kid, want, got, f"#{kid} strip {strip} xdrop {xdrop}")


@pytest.mark.parametrize("kid,pack", [(1, 1), (1, 4), (2, 2), (4, 2)])
def test_diag_store_and_walk_match_jax(kid, pack):
    """The ('diag', pack) store (lane i of diagonal d in byte i // pack,
    slot i % pack) and its walk, against JAX's engine and traceback."""
    import jax
    import jax.numpy as jnp
    from repro.core import engine as jeng
    from repro.core import traceback as jtb
    jspec, jparams, spec, params = kernel_pair(kid)
    qs, rs = _inputs(kid, spec, seed=7)
    got = peng.run(spec, params, torch.as_tensor(qs), torch.as_tensor(rs),
                   torch.as_tensor(QL), torch.as_tensor(RL), tb_pack=pack,
                   strip=1)
    layout = "diag" if pack == 1 else ("diag", pack)
    assert got.tb_layout == layout
    assert ptb.default_max_len(tuple(got.tb.shape[1:]), layout) == Q + R + 1
    galn = ptb.run_batched(spec, got)

    @jax.jit
    def fn(p, q, r, ql, rl):
        res = jax.vmap(lambda *a: jeng.run(jspec, *a, strip=1, tb_pack=pack),
                       in_axes=(None, 0, 0, 0, 0))(p, q, r, ql, rl)
        return res, jtb.run_batched(jspec, res)
    wres, waln = fn(jparams, jnp.asarray(qs), jnp.asarray(rs), QL, RL)
    np.testing.assert_array_equal(to_np(got.tb), np.asarray(wres.tb))
    for b in range(B):
        assert_same_alignment(_row(waln, b), _row(galn, b))


def _pairs(rng, spec, n, lo, hi):
    out = []
    for _ in range(n):
        q = random_codes(rng, spec, int(rng.integers(lo, hi)))
        r = q.copy()
        r[rng.random(len(r)) < 0.1] = random_codes(rng, spec, 1)[0]
        out.append((q, r[: int(rng.integers(lo, len(r) + 1))]))
    return out


@pytest.mark.parametrize("kid,xdrop,strip", [(2, 10, 1), (4, 4, 2),
                                             (1, 2, 8)])
def test_run_pairs_and_align_with_xdrop_match_jax(kid, xdrop, strip):
    """``run_pairs``/``align`` with ``xdrop`` on the CPU equal JAX's
    wavefront plan at the same ``strip`` (bucket 64, one compile), pair by
    pair: score, end cell, start cell, moves and CIGAR."""
    import jax.numpy as jnp
    from repro.runtime import plan as jplan
    jspec, jparams, spec, params = kernel_pair(kid)
    pairs = _pairs(np.random.default_rng(kid), spec, 10, 40, 64)
    got = dispatch.run_pairs(spec, params, pairs, block=4, device="cpu",
                             xdrop=xdrop, strip=strip)
    jp = jplan.get_plan(jspec, "wavefront", (64,), (64,), strip=strip,
                        xdrop=xdrop)
    wants = []
    for q, r in pairs:
        qp = np.zeros(64, np.uint8)
        rp = np.zeros(64, np.uint8)
        qp[: len(q)], rp[: len(r)] = q, r
        wants.append(jp(jparams, jnp.asarray(qp), jnp.asarray(rp),
                        np.int32(len(q)), np.int32(len(r))))
    for want, g in zip(wants, got):
        assert_same_alignment(want, g)
    q, r = pairs[0]
    assert_same_alignment(wants[0], api.align(
        spec, params, q, r, device="cpu", xdrop=xdrop, strip=strip))


def test_xdrop_plans_skip_k1_and_name_their_fill(monkeypatch):
    """An X-drop plan runs the eager engine and never K1; an xdrop=None
    plan runs K1; ``plan_cache_info`` names each plan's fill; a batched plan
    passes the engine ``live_bound = max(q_lens + r_lens)``."""
    from repro_torch.kernels.wavefront import ops
    spec, params = pzoo.make(2)
    plan_mod.clear_plan_cache()
    pairs = _pairs(np.random.default_rng(3), spec, 6, 40, 60)   # bucket 64
    k1_calls, bounds = [], []
    real_ops, real_engine = ops.run, peng.run
    monkeypatch.setattr(ops, "run",
                        lambda *a, **k: k1_calls.append(1) or
                        real_ops(*a, **k))
    monkeypatch.setattr(peng, "run",
                        lambda *a, **k: bounds.append(k["live_bound"]) or
                        real_engine(*a, **k))
    dispatch.run_pairs(spec, params, pairs, block=8, device="cpu", xdrop=6)
    assert not k1_calls
    assert bounds == [max(len(q) + len(r) for q, r in pairs)]
    dispatch.run_pairs(spec, params, pairs, block=8, device="cpu")
    assert k1_calls
    fills = {p["key"].xdrop: p["fill"]
             for p in plan_mod.plan_cache_info()["plans"]}
    assert fills == {6: registry.ENGINE_FILL, None: registry.K1_FILL}


def test_cache_does_not_split_on_ignored_options():
    """``strip`` means nothing to K1 and ``strip_warps`` nothing to the
    eager engine: each is pinned to its neutral value, so asking for it
    reuses the plan."""
    spec, _ = pzoo.make(2)
    plan_mod.clear_plan_cache()
    a = plan_mod.get_plan(spec, "wavefront", (64,), (64,), batch_size=4,
                          device="cpu", tb_pack=2)
    assert plan_mod.get_plan(spec, "wavefront", (64,), (64,), batch_size=4,
                             device="cpu", tb_pack=2, strip=4) is a
    assert (a.key.strip, a.key.strip_warps, a.fill) == (1, None,
                                                        registry.K1_FILL)
    x = plan_mod.get_plan(spec, "wavefront", (64,), (64,), batch_size=4,
                          device="cpu", xdrop=5, strip=4)
    assert plan_mod.get_plan(spec, "wavefront", (64,), (64,), batch_size=4,
                             device="cpu", xdrop=5, strip=4,
                             strip_warps=2) is x
    assert (x.key.strip, x.key.strip_warps) == (4, None)
    assert plan_mod.plan_key_str(x.key) == \
        "global_affine/wavefront/64x64/b4/tb/align/p2s4/maxplus/x5/cpu"
    assert plan_mod.plan_key_str(a.key) == \
        "global_affine/wavefront/64x64/b4/tb/align/p2/maxplus/cpu"


def test_strip_default_by_device():
    assert peng.STRIP_DEFAULTS == {"cpu": 1, "default": 8}
    assert peng.default_strip("cpu") == 1
    assert peng.default_strip("cuda") == 8
    spec, _ = pzoo.make(2)
    assert plan_mod.resolve_engine_options(
        spec, "wavefront", {"xdrop": 3}, "cuda")["strip"] == 8
    assert plan_mod.resolve_engine_options(
        spec, "wavefront", {"xdrop": 3}, "cpu")["strip"] == 1


# -- ports of tests/test_myers.py's X-drop cases --------------------------

def _one(spec, params, q, r, **kw):
    return peng.run(spec, params, torch.as_tensor(q)[None],
                    torch.as_tensor(r)[None], **kw)


def test_xdrop_huge_matches_exact():
    """An X-drop budget no alignment can exceed is bit-identical to the
    exact fill."""
    rng = np.random.default_rng(0)
    spec, params = pzoo.make("global_linear")
    q = rng.integers(0, 4, 48).astype(np.uint8)
    r = rng.integers(0, 4, 48).astype(np.uint8)
    exact = _one(spec, params, q, r)
    wide = _one(spec, params, q, r, xdrop=10 ** 6)
    for f in ("score", "end_i", "end_j"):
        assert torch.equal(getattr(exact, f), getattr(wide, f)), f


def test_xdrop_perfect_match_survives_any_budget():
    rng = np.random.default_rng(1)
    spec, params = pzoo.make("global_linear")
    q = rng.integers(0, 4, 40).astype(np.uint8)
    exact = _one(spec, params, q, q)
    tight = _one(spec, params, q, q, xdrop=2)
    assert int(tight.score) == int(exact.score)


def test_xdrop_rejects_sum_semiring():
    from repro_torch.prob import kernels as prob_kernels
    spec = prob_kernels.pairhmm()
    q = np.zeros(8, np.uint8)
    with pytest.raises(ValueError, match="sum-semiring"):
        _one(spec, {}, q, q, xdrop=5)


def test_negative_xdrop_is_refused():
    spec, _ = pzoo.make("edit_distance")
    with pytest.raises(ValueError, match=r"'xdrop' must be >= 0"):
        plan_mod.resolve_engine_options(spec, "wavefront", {"xdrop": -3})
    with pytest.raises(ValueError, match="does not accept"):
        plan_mod.get_plan(spec, "myers", (32,), (32,), batch_size=2,
                          with_traceback=False, mode="fill", strip=4,
                          device="cpu")


def test_engine_sum_semiring_matches_jax():
    """Without X-drop the engine also folds a sum semiring (the pair-HMM
    forward at logsumexp): rtol 1e-5 against JAX's engine."""
    import jax
    import jax.numpy as jnp
    from repro.core import engine as jeng
    from repro import prob as jprob
    from repro_torch import prob as pprob
    jspec, spec = jprob.cached_pairhmm(), pprob.cached_pairhmm()
    jparams = {k: np.asarray(v) for k, v in jprob.default_params().items()}
    params = pzoo.from_reference_params(jparams)
    rng = np.random.default_rng(5)
    qs = rng.integers(0, 4, (B, Q)).astype(np.uint8)
    rs = rng.integers(0, 4, (B, R)).astype(np.uint8)
    got = peng.run(spec, params, torch.as_tensor(qs), torch.as_tensor(rs),
                   torch.as_tensor(QL), torch.as_tensor(RL))
    want = jax.jit(jax.vmap(functools.partial(jeng.run, jspec, strip=1),
                            in_axes=(None, 0, 0, 0, 0)))(
        jparams, jnp.asarray(qs), jnp.asarray(rs), QL, RL)
    np.testing.assert_allclose(to_np(got.score), np.asarray(want.score),
                               rtol=1e-5)
