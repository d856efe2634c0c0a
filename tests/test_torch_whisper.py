"""The port's whisper encoder-decoder (``repro_torch.models.whisper``)
against the JAX package's, on the reduced whisper-medium in f32: ``encode``,
``forward``, ``prefill`` then ``decode_step`` over a grown self cache, the
cache layout against JAX's ``cache_spec``, and whole-model gradients of the
loss against ``jax.grad`` (remat off and on).

Weights: the port's ``init_params`` (fan_in over one layer's input width),
carried into JAX, and moved by N(0, 0.05) noise for the gradients.  JAX's
own init divides a stacked leaf by the square root of the layer count
(ROADMAP queue 3), which drives the reduced decoder's activations to a few
hundred, where f32 sums taken in another order differ by 1e-4 of the
logits.  Tolerances: those of ``tests/test_models.py:56-69`` (forward and
prefill 2e-4 / 1e-4, a decode step 2e-3 / 1e-3); gradients within 1e-3 of
each leaf's largest entry (as ``tests/test_torch_lm.py``)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro.models import whisper as jwhisper
from repro.train.loss import lm_loss as jlm_loss
from repro_torch import configs as pconfigs
from repro_torch.models import get_model, whisper
from repro_torch.models.params import (from_jax, init_params, leaves,
                                       tree_map, unflatten)
from repro_torch.train.loss import lm_loss

FWD_TOL = dict(atol=2e-4, rtol=1e-4)
DEC_TOL = dict(atol=2e-3, rtol=1e-3)
B, SE, SD = 2, 24, 20


def _cfgs(**changes):
    return (dataclasses.replace(jconfigs.get("whisper-medium", reduced=True),
                                **changes),
            dataclasses.replace(pconfigs.get("whisper-medium", reduced=True),
                                **changes))


def _weights(pc, seed=0, noise=0.0):
    """(numpy tree, port tree): the port's init, plus N(0, noise)."""
    p = init_params(pc, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed)
    tree = tree_map(lambda t: t.numpy() + noise * rng.normal(
        size=t.shape).astype(np.float32), p)
    return tree, from_jax(pc, tree, "cpu")


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, SE, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, SD)).astype(np.int32)
    return frames, toks


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def test_get_model_returns_whisper():
    for reduced in (False, True):
        assert get_model(pconfigs.get("whisper-medium",
                                      reduced=reduced)) is whisper
    assert jget_model(jconfigs.get("whisper-medium")) is jwhisper


def test_encode_and_forward_match_jax():
    jc, pc = _cfgs()
    tree, pp = _weights(pc)
    jp = jax.tree.map(jnp.asarray, tree)
    frames, toks = _inputs(jc)
    np.testing.assert_allclose(
        _np(whisper.encode(pc, pp, torch.as_tensor(frames))),
        _np(jwhisper.encode(jc, jp, jnp.asarray(frames))), **FWD_TOL)
    want = jwhisper.forward(jc, jp, {"frames": jnp.asarray(frames),
                                     "tokens": jnp.asarray(toks)})
    got = whisper.forward(pc, pp, {"frames": torch.as_tensor(frames),
                                   "tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(_np(got["logits"]), _np(want["logits"]),
                               **FWD_TOL)
    assert got["prefix"] == want["prefix"] == 0
    assert got["aux_loss"] == want["aux_loss"] == 0.0


def test_prefill_and_decode_match_jax():
    """Prefill SD - 1 tokens over the frames, grow the self cache by 4
    (as ``tests/test_models.py`` does), decode the last token: the prefill
    and decode logits against JAX's and against the port's ``forward``
    over all SD tokens; k_len equal; the cross cache left as prefill
    built it."""
    jc, pc = _cfgs()
    tree, pp = _weights(pc)
    jp = jax.tree.map(jnp.asarray, tree)
    frames, toks = _inputs(jc)
    full = whisper.forward(pc, pp, {"frames": torch.as_tensor(frames),
                                    "tokens": torch.as_tensor(toks)})
    jl, jcache, jk = jwhisper.prefill(jc, jp, {
        "frames": jnp.asarray(frames), "tokens": jnp.asarray(toks[:, :-1])})
    pl, pcache, pk = whisper.prefill(pc, pp, {
        "frames": torch.as_tensor(frames),
        "tokens": torch.as_tensor(toks[:, :-1])})
    np.testing.assert_allclose(_np(pl), _np(jl), **FWD_TOL)
    np.testing.assert_allclose(_np(pl), _np(full["logits"][:, -2]),
                               **FWD_TOL)
    np.testing.assert_array_equal(_np(pk), _np(jk))

    jcache = dict(jcache, self=jax.tree.map(
        lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))),
        jcache["self"]))
    grown = whisper.init_cache(pc, B, SD + 3, SE, "cpu")
    for name in ("k", "v"):
        grown["self"][name][:, :, :SD - 1] = pcache["self"][name]
    grown["cross_k"].copy_(pcache["cross_k"])
    grown["cross_v"].copy_(pcache["cross_v"])
    jd, jnew = jwhisper.decode_step(jc, jp, jcache, jnp.asarray(toks[:, -1]),
                                    jk)
    pd, pnew = whisper.decode_step(pc, pp, grown,
                                   torch.as_tensor(toks[:, -1]), pk)
    assert pnew is grown
    np.testing.assert_allclose(_np(pd), _np(jd), **DEC_TOL)
    np.testing.assert_allclose(_np(pd), _np(full["logits"][:, -1]),
                               **DEC_TOL)
    np.testing.assert_allclose(_np(pnew["self"]["k"]),
                               _np(jnew["self"]["k"]), **FWD_TOL)
    np.testing.assert_array_equal(_np(pnew["cross_k"]),
                                  _np(pcache["cross_k"]))


def test_cache_layout_matches_jax():
    jc, pc = _cfgs()
    jspec = jwhisper.cache_spec(jc, 3, 17, 29)
    pspec = whisper.cache_spec(pc, 3, 17, 29)
    flat = jax.tree_util.tree_flatten_with_path(
        jspec, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
        and isinstance(x[0], tuple))[0]
    assert len(flat) == len(leaves(pspec)) == 4
    for path, (shape, dtype) in flat:
        node = pspec
        for k in path:
            node = node[k.key]
        assert node.shape == tuple(shape)
        assert str(node.dtype) == f"torch.{jnp.dtype(dtype).name}"
    cache = whisper.init_cache(pc, 3, 17, 29, "cpu")
    assert all(float(t.abs().sum()) == 0 for t in leaves(cache))
    # prefill builds the same layout at S_dec = its token count
    _, pp = _weights(pc)
    frames, toks = _inputs(pc)
    _, built, _ = whisper.prefill(pc, pp, {
        "frames": torch.as_tensor(frames[:, :7]),
        "tokens": torch.as_tensor(toks[:, :5])})
    want = leaves(whisper.cache_spec(pc, B, 5, 7))
    assert [(tuple(t.shape), t.dtype) for t in leaves(built)] == \
        [(c.shape, c.dtype) for c in want]


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_jax(remat):
    """Gradients of ``lm_loss`` through ``forward`` (K3's plain backward on
    the CPU, each layer under ``torch.utils.checkpoint`` with remat)
    against ``jax.grad`` of JAX's loss; the loss within 1e-6 relative."""
    jc, pc = _cfgs(remat=remat)
    tree, pp = _weights(pc, seed=3, noise=0.05)
    jp = jax.tree.map(jnp.asarray, tree)
    frames, toks = _inputs(jc, seed=4)
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}
    jl, jg = jax.value_and_grad(
        lambda p: jlm_loss(jc, jwhisper.forward(jc, p, jb), jb)[0])(jp)
    live = [t.detach().requires_grad_() for t in leaves(pp)]
    pb = {"frames": torch.as_tensor(frames), "tokens": torch.as_tensor(toks)}
    loss, _ = lm_loss(pc, whisper.forward(pc, unflatten(pp, live), pb), pb)
    got = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    want = leaves(from_jax(pc, jax.tree.map(np.asarray, jg), "cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), w.numpy()
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max()
