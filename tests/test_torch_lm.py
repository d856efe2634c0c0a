"""The LM substrate of the PyTorch port against the JAX package, on the
reduced configs in f32 with weights carried across by
``repro_torch.models.params.from_jax``: the layers, the attention mixer
(with and without a sliding window), the RWKV-6 time and channel mixes,
and whole-model ``forward``/``prefill``/``decode_step`` (llava with a
prefix of patch embeddings, qwen3-moe through the MoE FFN at its reduced
config's no-drop capacity, recurrentgemma's RG-LRU beside local
attention, deepseek-v3's MLA with its MTP head's logits; the RG-LRU and
MLA mixers alone are in ``tests/test_torch_rglru.py`` and
``tests/test_torch_mla.py``).  Tolerances:
2e-5 for a layer and 1e-4 for a mixer (f32 sums in other orders, over
more terms in a mixer), and the whole-model
tolerances of ``tests/test_models.py`` (2e-4 / 1e-4 for forward and
prefill, 2e-3 / 1e-3 for a decode step); whole-model gradients of the
loss against ``jax.grad`` with remat off and on (each leaf within 1e-3 of
its largest entry: JAX's own gradients move by up to 1.5e-4 of a leaf's
largest entry when only the attention chunk changes)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import mixers as jmixers
from repro.models import params as jparams
from repro_torch import configs as pconfigs
from repro_torch.models import get_model, layers, lm, mixers, whisper
from repro_torch.models.params import count_params, from_jax, init_params

ARCHS = ["olmo-1b", "rwkv6-3b", "stablelm-12b", "phi3-medium-14b",
         "command-r-plus-104b", "qwen3-moe-30b-a3b", "llava-next-mistral-7b",
         "recurrentgemma-9b", "deepseek-v3-671b"]
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
# a mixer sums a few thousand f32 products per output, of magnitude ~10
MIXER_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch, **changes):
    j = jconfigs.get(arch, reduced=True)
    p = pconfigs.get(arch, reduced=True)
    if changes:
        j, p = dataclasses.replace(j, **changes), dataclasses.replace(
            p, **changes)
    return j, p


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _carry(tree):
    """A JAX tree (dicts / tuples of arrays) as torch tensors, unchecked:
    for single layers, whose trees ``from_jax`` does not declare."""
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)


def _random_defs(defs, seed):
    """Initialised JAX params with every leaf (zeros and ones too) moved by
    N(0, 0.1) noise, so data-dependent paths (the decay LoRA, the token
    shift, the bonus u) are exercised (log-decays then span about -8 to
    -0.1)."""
    p = jparams.init_params(jax.random.PRNGKey(seed), defs, jnp.float32)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32)),
        p)


def _x(rng, B, S, D):
    return rng.normal(size=(B, S, D)).astype(np.float32)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "layernorm_np"])
def test_norm(norm, rng):
    jc, pc = _cfgs("olmo-1b", norm=norm)
    p = _random_defs(jlayers.norm_defs(jc, 64), 1)
    x = _x(rng, 2, 5, 64)
    want = jlayers.norm_apply(jc, p, jnp.asarray(x))
    got = layers.norm_apply(pc, _carry(p), torch.as_tensor(x))
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


def test_rms_head_norm(rng):
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    s = rng.normal(size=(16,)).astype(np.float32)
    want = jlayers.rms_head_norm(jnp.asarray(s), jnp.asarray(x))
    got = layers.rms_head_norm(torch.as_tensor(s), torch.as_tensor(x))
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


@pytest.mark.parametrize("rope_dim", [None, 8])
def test_rope(rope_dim, rng):
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    for pos in (np.arange(7, dtype=np.int32)[None],
                np.array([[5], [300]], np.int32)):
        xx = x if pos.shape[1] == 7 else x[:, :1]
        want = jlayers.rope_apply(jnp.asarray(xx), jnp.asarray(pos),
                                  10_000.0, rope_dim)
        got = layers.rope_apply(torch.as_tensor(xx), torch.as_tensor(pos),
                                10_000.0, rope_dim)
        np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp(act, rng):
    jc, pc = _cfgs("olmo-1b", act=act)
    p = _random_defs(jlayers.mlp_defs(jc), 2)
    x = _x(rng, 2, 5, 64)
    want = jlayers.mlp_apply(jc, p, jnp.asarray(x))
    got = layers.mlp_apply(pc, _carry(p), torch.as_tensor(x))
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


def test_decode_attention(rng):
    B, S, H, K, hd = 3, 20, 4, 2, 16
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    kc = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    vc = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    k_len = np.array([1, 7, 20], np.int32)
    want = jlayers.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                                    k_len=jnp.asarray(k_len))
    got = layers.decode_attention(*map(torch.as_tensor, (q, kc, vc)),
                                  k_len=torch.as_tensor(k_len))
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)
    # a ring buffer: slot positions, some empty (-1), and a window
    sp = rng.permutation(np.arange(S)).astype(np.int32)[None].repeat(B, 0)
    sp[:, :3] = -1
    want = jlayers.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                                    k_len=jnp.asarray(k_len + 10), window=8,
                                    slot_pos=jnp.asarray(sp))
    got = layers.decode_attention(*map(torch.as_tensor, (q, kc, vc)),
                                  k_len=torch.as_tensor(k_len + 10),
                                  window=8, slot_pos=torch.as_tensor(sp))
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


# ---------------------------------------------------------------------------
# Mixers
# ---------------------------------------------------------------------------
def _decode_after_prefill(japply, papply, p, x, S, cap, grow):
    """Prefill x[:, :S - 1] on both sides, grow the caches to ``cap``, then
    decode position S - 1; returns ((jax y, port y), ...) per mode."""
    B = x.shape[0]
    jp, pp = p, _carry(p)
    pos = np.arange(S - 1, dtype=np.int32)[None]
    jy, jcache = japply(jp, jnp.asarray(x[:, :S - 1]),
                        {"mode": "prefill", "positions": jnp.asarray(pos)},
                        None)
    py, pcache = papply(pp, torch.as_tensor(x[:, :S - 1]),
                        {"mode": "prefill",
                         "positions": torch.as_tensor(pos)}, None)
    out = [(jy, py)]
    jcache, pcache = grow(jcache, pcache, cap)
    k_len = np.full((B,), S - 1, np.int32)
    jy, _ = japply(jp, jnp.asarray(x[:, S - 1:]),
                   {"mode": "decode", "k_len": jnp.asarray(k_len)}, jcache)
    py, _ = papply(pp, torch.as_tensor(x[:, S - 1:]),
                   {"mode": "decode", "k_len": torch.as_tensor(k_len)},
                   pcache)
    out.append((jy, py))
    return out


@pytest.mark.parametrize("window", [None, 8, 40])
def test_attn_mixer(window, rng):
    """Train, prefill and a decode step of GQA attention; with a window the
    prefill builds the ring buffer and decode writes slot pos % W."""
    jc, pc = _cfgs("olmo-1b", n_kv_heads=2)
    jc = dataclasses.replace(jc, attn_chunk=16)   # JAX pads to 16-row blocks
    p = _random_defs(jmixers.attn_defs(jc), 3)
    B, S = 2, 30
    x = _x(rng, B, S, 64)
    pos = np.arange(S, dtype=np.int32)[None]
    want, _ = jmixers.attn_apply(jc, p, jnp.asarray(x), {
        "mode": "train", "positions": jnp.asarray(pos)}, None, window=window)
    got, _ = mixers.attn_apply(pc, _carry(p), torch.as_tensor(x), {
        "mode": "train", "positions": torch.as_tensor(pos)}, None,
        window=window)
    np.testing.assert_allclose(_np(got), _np(want), **MIXER_TOL)

    def grow(jcache, pcache, cap):
        if window is not None:          # ring buffers keep their size
            return jcache, pcache
        pad = ((0, 0), (0, cap - jcache["k"].shape[1]), (0, 0), (0, 0))
        return ({k: jnp.pad(v, pad) for k, v in jcache.items()},
                {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad[1][1]))
                 for k, v in pcache.items()})

    for jy, py in _decode_after_prefill(
            lambda *a: jmixers.attn_apply(jc, *a, window=window),
            lambda *a: mixers.attn_apply(pc, *a, window=window),
            p, x, S, S + 4, grow):
        np.testing.assert_allclose(_np(py), _np(jy), **MIXER_TOL)


def test_rwkv6_time_and_channel_mix(rng):
    """The RWKV-6 time mix (prefill on the chunked recurrence, then the
    single-step decode) and the channel mix, with every parameter moved off
    its initial value."""
    jc, pc = _cfgs("rwkv6-3b")
    B, S = 2, 45
    x = _x(rng, B, S, 64)
    for defs, japply, papply in (
            (jmixers.rwkv6_defs(jc),
             lambda *a: jmixers.rwkv6_apply(jc, *a),
             lambda *a: mixers.rwkv6_apply(pc, *a)),
            (jmixers.rwkv_cm_defs(jc),
             lambda *a: jmixers.rwkv_cm_apply(jc, *a),
             lambda *a: mixers.rwkv_cm_apply(pc, *a))):
        p = _random_defs(defs, 4)
        for jy, py in _decode_after_prefill(japply, papply, p, x, S, S,
                                            lambda j, q, _: (j, q)):
            np.testing.assert_allclose(_np(py), _np(jy), **MIXER_TOL)


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------
MODELS = {"olmo-1b": {}, "rwkv6-3b": {},
          "olmo-1b-local": {"pattern": ("attn", "attn_local"), "window": 8},
          "stablelm-12b": {}, "phi3-medium-14b": {},
          "command-r-plus-104b": {}, "qwen3-moe-30b-a3b": {},
          "llava-next-mistral-7b": {}, "recurrentgemma-9b": {},
          "deepseek-v3-671b": {}}


# Weights drawn by the port's ``init_params`` (fan_in over one layer's input
# width) and carried into JAX, where JAX's own init divides a stacked leaf
# by the square root of its layer count (ROADMAP queue 3): recurrentgemma's
# reduced groups repeat once, so JAX's init gives every projection N(0, 1)
# and its activations reach the hundreds, where f32 sums taken in another
# order move 1.5e-4 of the logits (as whisper's, tests/test_torch_whisper.py).
PORT_INIT = {"recurrentgemma-9b"}


def _model_params(arch, jc, pc, seed, noise=0.0):
    """(JAX tree, port tree) of one set of weights: JAX's init (``noise``:
    moved by N(0, noise), ``_random_defs``), or for PORT_INIT the port's,
    plus N(0, noise)."""
    if arch not in PORT_INIT:
        jp = (_random_defs(jlm.param_defs(jc), seed) if noise else
              jlm.init(jc, jax.random.PRNGKey(seed)))
        return jp, from_jax(pc, jax.tree.map(np.asarray, jp), "cpu")
    from repro_torch.models.params import tree_map
    rng = np.random.default_rng(seed)
    tree = tree_map(lambda t: t.numpy() + noise * rng.normal(
        size=t.shape).astype(np.float32),
        init_params(pc, torch.Generator().manual_seed(seed), "cpu"))
    return jax.tree.map(jnp.asarray, tree), from_jax(pc, tree, "cpu")


def _lm_batch(cfg, rng, B, S):
    """numpy tokens (B, S) and, for a vlm config, a prefix of S // 4
    patch embeddings ahead of them."""
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vlm":
        b["prefix_embeds"] = rng.normal(
            size=(B, S // 4, cfg.d_model)).astype(np.float32)
    return b


def _as(batch, fn):
    return {k: fn(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_prefill_decode_match_jax(name, rng):
    arch = name.removesuffix("-local")
    jc, pc = _cfgs(arch, **MODELS[name])
    jp, pp = _model_params(arch, jc, pc, 0)
    B, S = 2, 40
    batch = _lm_batch(jc, rng, B, S)
    toks = batch["tokens"]
    jout = jlm.forward(jc, jp, _as(batch, jnp.asarray))
    pout = lm.forward(pc, pp, _as(batch, torch.as_tensor))
    want, got = jout["logits"], pout["logits"]
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-4, rtol=1e-4)
    assert set(pout) == set(jout)            # mtp_logits with cfg.mtp
    if "mtp_logits" in jout:
        np.testing.assert_allclose(_np(pout["mtp_logits"]),
                                   _np(jout["mtp_logits"]), atol=2e-4,
                                   rtol=1e-4)
    assert pout["prefix"] == jout["prefix"]
    np.testing.assert_allclose(float(pout["aux_loss"]),
                               float(jout["aux_loss"]), rtol=1e-5)

    head = dict(batch, tokens=toks[:, :S - 1])
    jl, jcache, jk = jlm.prefill(jc, jp, _as(head, jnp.asarray))
    pl, pcache, pk = lm.prefill(pc, pp, _as(head, torch.as_tensor))
    np.testing.assert_allclose(_np(pl), _np(jl), atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(_np(pk), _np(jk))
    jcache = jlm.grow_cache(jc, jcache, B, int(jk[0]) + 4)
    pcache = lm.grow_cache(pc, pcache, B, int(pk[0]) + 4)
    jd, _ = jlm.decode_step(jc, jp, jcache, jnp.asarray(toks[:, -1]), jk)
    pd, _ = lm.decode_step(pc, pp, pcache, torch.as_tensor(toks[:, -1]), pk)
    np.testing.assert_allclose(_np(pd), _np(jd), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(_np(pd), _np(got[:, -1]), atol=2e-3,
                               rtol=1e-3)


def _paths(tree, is_leaf, path=()):
    """{key path: leaf} of nested dicts/tuples (None dropped)."""
    if is_leaf(tree):
        return {path: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(_paths(v, is_leaf, path + (k,)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_matches_jax(arch):
    jc, pc = _cfgs(arch)
    jspec = _paths(jlm.cache_spec(jc, 3, 17), lambda x: isinstance(x, tuple)
                   and len(x) == 2 and isinstance(x[0], tuple))
    pspec = _paths(lm.cache_spec(pc, 3, 17),
                   lambda x: isinstance(x, lm.CacheLeaf))
    assert set(jspec) == set(pspec)
    for path, (shape, dtype) in jspec.items():
        assert pspec[path].shape == tuple(shape), path
        assert str(pspec[path].dtype) == f"torch.{jnp.dtype(dtype).name}"
    cache = lm.init_cache(pc, 3, 17, "cpu")
    assert all(float(t.abs().sum()) == 0 for t in _leaves(cache))


def _leaves(tree):
    from repro_torch.models.params import leaves
    return leaves(tree)


def _jax_defs(cfg):
    return jget_model(cfg).param_defs(cfg)


def _jax_count(cfg):
    """The parameters JAX's ``param_defs`` declares, counted in int64:
    ``jparams.count_params`` multiplies each shape in int32 and wraps past
    2^31 (a stacked leaf of stablelm-12b's MLP holds 2.8 G, qwen3-moe's
    stacked experts 9.66 G)."""
    defs = jax.tree.leaves(_jax_defs(cfg),
                           is_leaf=lambda d: isinstance(d, jparams.ParamDef))
    sizes = [int(np.prod(d.shape, dtype=np.int64)) for d in defs]
    return sum(sizes), max(sizes)


@pytest.mark.parametrize("arch", ARCHS + ["whisper-medium"])
def test_full_config_param_counts_equal_jax(arch):
    jc = jconfigs.get(arch)
    want, biggest = _jax_count(jc)
    assert count_params(pconfigs.get(arch)) == want
    if biggest < 2 ** 31:                # JAX's own count does not wrap
        assert jparams.count_params(_jax_defs(jc)) == want
    assert count_params(pconfigs.get(arch, reduced=True)) == \
        jparams.count_params(_jax_defs(jconfigs.get(arch, reduced=True)))


def test_from_jax_checks_shapes_and_keys():
    jc, pc = _cfgs("olmo-1b")
    tree = jax.tree.map(np.asarray, jlm.init(jc, jax.random.PRNGKey(0)))
    bad = dict(tree, embed={"table": tree["embed"]["table"][:, :8]})
    with pytest.raises(ValueError, match="shape"):
        from_jax(pc, bad, "cpu")
    with pytest.raises(ValueError, match="dtype"):
        from_jax(pc, dict(tree, embed={"table": tree["embed"]["table"]
                                       .astype(np.float16)}), "cpu")
    with pytest.raises(ValueError, match="keys"):
        from_jax(pc, {k: v for k, v in tree.items() if k != "final_norm"},
                 "cpu")


def test_from_jax_carries_bfloat16_bits():
    jc, pc = _cfgs("olmo-1b", param_dtype=jnp.bfloat16)
    pc = dataclasses.replace(pc, param_dtype=torch.bfloat16)
    tree = jax.tree.map(np.asarray, jlm.init(jc, jax.random.PRNGKey(1)))
    got = from_jax(pc, tree, "cpu")
    want = np.asarray(tree["embed"]["table"]).astype(np.float32)
    assert got["embed"]["table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["embed"]["table"].float().numpy(), want)


def test_init_params_kinds():
    _, pc = _cfgs("rwkv6-3b")
    p = init_params(pc, torch.Generator().manual_seed(0), "cpu")
    mix = p["groups"][0]["sub0"]["mixer"]
    assert float(mix["u"].abs().sum()) == 0                  # zeros
    assert torch.equal(mix["ln_scale"], torch.ones_like(mix["ln_scale"]))
    # fan_in: 1/sqrt of one layer's input width (64), not of the layer
    # axis that JAX's stacked declaration puts first
    assert abs(float(mix["wr"].std()) - 64 ** -0.5) < 0.02
    assert abs(float(p["embed"]["table"].std()) - 0.02) < 0.002  # normal
    again = init_params(pc, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["embed"]["table"], p["embed"]["table"])


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCH_NAMES))
def test_get_model_takes_every_registered_architecture(arch):
    """Every architecture the JAX package registers is registered in the
    port, under the same name, and ``get_model`` returns its module (whisper
    for the encoder-decoder, lm for the rest), full and reduced."""
    for reduced in (False, True):
        j = jconfigs.get(arch, reduced=reduced)
        p = pconfigs.get(arch, reduced=reduced)
        assert p.name == j.name
        assert get_model(p) is (whisper if j.enc_dec else lm)
    assert arch in pconfigs.ARCH_NAMES


def test_windowed_cache_grown_past_the_prompt_matches_jax(rng):
    """A sliding-window ring grown past a prompt shorter than the window:
    the zero-padded slots carry slot_pos 0, so decode counts them as keys
    at position 0 with k = v = 0, in JAX and in the port alike (a note on
    the reference, ROADMAP queue 3)."""
    jc, pc = _cfgs("olmo-1b", pattern=("attn_local",), window=16)
    jp = jlm.init(jc, jax.random.PRNGKey(0))
    pp = from_jax(pc, jax.tree.map(np.asarray, jp), "cpu")
    toks = rng.integers(0, jc.vocab_size, (1, 8))
    _, jcache, jk = jlm.prefill(jc, jp, {"tokens": jnp.asarray(toks[:, :7])})
    _, pcache, pk = lm.prefill(pc, pp, {"tokens": torch.as_tensor(
        toks[:, :7])})
    jd, _ = jlm.decode_step(jc, jp, jlm.grow_cache(jc, jcache, 1, 32),
                            jnp.asarray(toks[:, 7]), jk)
    pd, _ = lm.decode_step(pc, pp, lm.grow_cache(pc, pcache, 1, 32),
                           torch.as_tensor(toks[:, 7]), pk)
    np.testing.assert_allclose(_np(pd), _np(jd), atol=2e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_gradients_match_jax(arch, remat, rng):
    """Gradients of ``lm_loss`` through ``forward`` on the CPU (K3's and
    K4's plain backward, torch autograd elsewhere, each period under
    ``torch.utils.checkpoint`` with remat) against ``jax.grad`` of JAX's
    loss, every parameter moved off its initial value; and the loss within
    1e-6 relative."""
    from repro.train.loss import lm_loss as jlm_loss
    from repro_torch.models.params import leaves, unflatten
    from repro_torch.train.loss import lm_loss
    jc, pc = _cfgs(arch, remat=remat)
    jp, pp = _model_params(arch, jc, pc, 5, noise=0.1)
    batch = _lm_batch(jc, rng, 2, 33)
    jb = _as(batch, jnp.asarray)
    jl, jg = jax.value_and_grad(
        lambda p: jlm_loss(jc, jlm.forward(jc, p, jb), jb)[0])(jp)
    live = [t.detach().requires_grad_() for t in leaves(pp)]
    pb = _as(batch, torch.as_tensor)
    loss, _ = lm_loss(pc, lm.forward(pc, unflatten(pp, live), pb), pb)
    got = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    want = leaves(from_jax(pc, jax.tree.map(np.asarray, jg), "cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), w.numpy()
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max()


def test_remat_gives_the_same_gradients(rng):
    """remat recomputes each period in the backward: the same gradients,
    bit for bit, on the CPU."""
    from repro_torch.models.params import leaves, unflatten
    from repro_torch.train.loss import lm_loss
    out = []
    for remat in (False, True):
        _, pc = _cfgs("olmo-1b", remat=remat)
        pp = init_params(pc, torch.Generator().manual_seed(0), "cpu")
        live = [t.detach().requires_grad_() for t in leaves(pp)]
        b = {"tokens": torch.as_tensor(np.arange(40).reshape(2, 20) % 256)}
        loss, _ = lm_loss(pc, lm.forward(pc, unflatten(pp, live), b), b)
        out.append(torch.autograd.grad(loss, live))
    for a, b in zip(*out):
        assert torch.equal(a, b)
