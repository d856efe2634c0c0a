"""Whisper-style encoder-decoder (port of ``repro/models/whisper.py``).

The conv frontend is a stub, as in the JAX package: inputs arrive as
precomputed frame embeddings.  Encoder: bidirectional attention blocks.
Decoder: causal self-attention, then cross-attention to the encoder states.
Learned positional embeddings, GELU MLPs, pre-LayerNorm.  Every attention
of train and prefill goes through ``layers.flash_attention`` (K3 on the
card: the encoder and the cross-attention non-causal, the cross at
Sq != Sk).  Decode caches the decoder's self k/v, which grows one slot a
step in place, and each layer's cross k/v, projected once from the encoder
states at prefill and read by ``layers.decode_attention`` after.  With
``cfg.remat`` each encoder and decoder layer of a train pass runs under
``torch.utils.checkpoint``, as JAX wraps it in ``jax.checkpoint``.

There is no serving session for it, as in JAX: ``ServeSession`` refuses
encoder-decoder configs; drive ``prefill`` / ``decode_step`` directly.
``forward``, ``prefill`` and ``decode_step`` take the activation hook
``sc`` at JAX's places (see ``lm``).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import replicate_plain

from . import mixers
from .layers import decode_attention, embed_lookup, flash_attention, \
    mlp_apply, mlp_defs, norm_apply, norm_defs
from .lm import _RESID, CacheLeaf, _as_tensor, _copy_into, _no_sc, _unstack
from .params import (ParamDef, abstract_params, logical_tree, stack_defs,
                     to_dtype, tree_map)

P = ParamDef


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------
def _enc_layer_defs(cfg):
    return {"norm1": norm_defs(cfg, cfg.d_model),
            "attn": mixers.attn_defs(cfg),
            "norm2": norm_defs(cfg, cfg.d_model),
            "ffn": mlp_defs(cfg)}


def _dec_layer_defs(cfg):
    return {"norm1": norm_defs(cfg, cfg.d_model),
            "self": mixers.attn_defs(cfg),
            "norm_x": norm_defs(cfg, cfg.d_model),
            "cross": mixers.attn_defs(cfg),
            "norm2": norm_defs(cfg, cfg.d_model),
            "ffn": mlp_defs(cfg)}


def param_defs(cfg):
    D, V = cfg.d_model, cfg.vocab_eff
    return {
        "enc": {"pos": P((cfg.max_seq, D), (None, "embed")),
                "stack": stack_defs(_enc_layer_defs(cfg), cfg.n_enc_layers),
                "final_norm": norm_defs(cfg, D)},
        "dec": {"embed": {"table": P((V, D), ("vocab", "embed"))},
                "pos": P((cfg.max_seq, D), (None, "embed")),
                "stack": stack_defs(_dec_layer_defs(cfg), cfg.n_layers),
                "final_norm": norm_defs(cfg, D),
                "head": {"w": P((D, V), ("embed", "vocab"), init="fan_in")}},
    }


def abstract(cfg):
    """The parameter tree as ``meta`` tensors."""
    return abstract_params(param_defs(cfg), cfg.param_dtype)


def logical(cfg):
    """The parameter tree's logical axis names."""
    return logical_tree(param_defs(cfg))


# ---------------------------------------------------------------------------
# Layers (no rope: positions are learned embeddings)
# ---------------------------------------------------------------------------
def _attn(p, x, x_kv, *, causal):
    """-> (output (B, Sq, D), (k, v)); K3 on the card."""
    q = mixers._proj(x, p["wq"])
    k, v = mixers._proj(x_kv, p["wk"]), mixers._proj(x_kv, p["wv"])
    o = flash_attention(q, k, v, causal=causal, window=None)
    out = mixers._out_local if isinstance(o, DTensor) else mixers._out
    return out(o, p["wo"]), (k, v)


def _enc_layer(cfg, p, x, sc):
    h = norm_apply(cfg, p["norm1"], x)
    x = sc(x + _attn(p["attn"], h, h, causal=False)[0], _RESID)
    x = x + mlp_apply(cfg, p["ffn"], norm_apply(cfg, p["norm2"], x))
    return sc(x, _RESID)


def _layer_call(remat, fn, *args):
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def encode(cfg, params, frames, remat=False, sc=_no_sc):
    """frames: (B, Se, D) precomputed embeddings -> encoder states; with
    ``remat`` (a train pass) each layer runs under ``checkpoint``."""
    enc = params["enc"]
    dt = to_dtype(cfg.compute_dtype)
    frames = _as_tensor(frames, enc["pos"].device)
    Se = frames.shape[1]
    x = frames.to(dt) + enc["pos"][:Se].to(dt)[None]

    def layer(pp, xc):
        return _enc_layer(cfg, pp, xc, sc)
    for pp in _unstack(enc["stack"], cfg.n_enc_layers):
        x = _layer_call(remat, layer, pp, x)
    return norm_apply(cfg, enc["final_norm"], x)


def _dec_layer(cfg, p, x, enc_out, ctx, cache):
    """-> (x, new cache): prefill builds {self: {k, v}, cross_k, cross_v};
    decode writes the self slot in place and keeps the cross k/v."""
    mode = ctx["mode"]
    nc = {}
    if mode == "decode":
        h = norm_apply(cfg, p["norm1"], x)
        y, nc["self"] = mixers._attn_decode(cfg, p["self"], h, ctx,
                                            cache["self"], None)
        x = x + y
        h = norm_apply(cfg, p["norm_x"], x)
        q = mixers._proj(h, p["cross"]["wq"])
        ck, cv = cache["cross_k"], cache["cross_v"]
        k_len = torch.full((x.shape[0],), ck.shape[1], dtype=torch.int32,
                           device=x.device)
        o = decode_attention(q, ck, cv, k_len=k_len)
        x = x + mixers._out(o, p["cross"]["wo"])
        nc["cross_k"], nc["cross_v"] = ck, cv
    else:
        h = norm_apply(cfg, p["norm1"], x)
        y, (k, v) = _attn(p["self"], h, h, causal=True)
        x = x + y
        if mode == "prefill":
            nc["self"] = {"k": k, "v": v}
        h = norm_apply(cfg, p["norm_x"], x)
        y, (ck, cv) = _attn(p["cross"], h, enc_out, causal=False)
        x = x + y
        if mode == "prefill":
            nc["cross_k"], nc["cross_v"] = ck, cv
    x = ctx["sc"](x, _RESID)
    x = x + mlp_apply(cfg, p["ffn"], norm_apply(cfg, p["norm2"], x))
    return ctx["sc"](x, _RESID), nc


def _dec_embed(cfg, params, tokens, positions=None):
    """Token embeddings plus the learned positions (default 0 .. S - 1)."""
    dec = params["dec"]
    dt = to_dtype(cfg.compute_dtype)
    tokens = _as_tensor(tokens, dec["pos"].device)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    return (embed_lookup(dec["embed"]["table"], tokens).to(dt)
            + embed_lookup(dec["pos"], positions).to(dt))


def _logits(cfg, params, x):
    """f32 logits: products of the working dtype accumulated in f32."""
    dec = params["dec"]
    h = norm_apply(cfg, dec["final_norm"], x)
    return h.float() @ dec["head"]["w"].float()


def forward(cfg, params, batch, sc=None):
    """Train: batch = {'frames': (B, Se, D), 'tokens': (B, Sd)} -> f32
    logits of every decoder position."""
    sc = sc or _no_sc
    enc_out = encode(cfg, params, batch["frames"], remat=cfg.remat, sc=sc)
    x = _dec_embed(cfg, params, batch["tokens"])
    ctx = {"mode": "train", "sc": sc}

    def layer(pp, xc, e):
        return _dec_layer(cfg, pp, xc, e, ctx, None)[0]
    for pp in _unstack(params["dec"]["stack"], cfg.n_layers):
        x = _layer_call(cfg.remat, layer, pp, x, enc_out)
    return {"logits": sc(_logits(cfg, params, x), ("batch", None, "vocab")),
            "aux_loss": 0.0, "prefix": 0}


def prefill(cfg, params, batch, sc=None):
    """``_prefill``; plain tensors meet a sharded tree's DTensors as
    replicated values."""
    with replicate_plain(params):
        return _prefill(cfg, params, batch, sc)


def _prefill(cfg, params, batch, sc=None):
    """-> (last-position logits (B, V), cache, k_len (B,) = Sd)."""
    sc = sc or _no_sc
    enc_out = encode(cfg, params, batch["frames"], sc=sc)
    x = _dec_embed(cfg, params, batch["tokens"])
    B, Sd = x.shape[:2]
    ctx = {"mode": "prefill", "sc": sc}
    built = []
    for pp in _unstack(params["dec"]["stack"], cfg.n_layers):
        x, nc = _dec_layer(cfg, pp, x, enc_out, ctx, None)
        built.append(nc)
    logits = _logits(cfg, params, x[:, -1:])[:, 0]
    cache = tree_map(lambda *ts: torch.stack(ts), *built)
    return logits, cache, torch.full((B,), Sd, dtype=torch.int32,
                                     device=x.device)


def decode_step(cfg, params, cache, token, k_len, sc=None):
    """``_decode_step``; plain tensors meet a sharded tree's DTensors as
    replicated values."""
    with replicate_plain(params):
        return _decode_step(cfg, params, cache, token, k_len, sc)


def _decode_step(cfg, params, cache, token, k_len, sc=None):
    """token: (B,) int; k_len: (B,) valid self-cache length (its capacity
    bounds the decode length; the cross k/v are fixed).
    -> (logits (B, V), cache): the cache is updated in place."""
    x = _dec_embed(cfg, params, token[:, None], k_len[:, None].long())
    ctx = {"mode": "decode", "sc": sc or _no_sc, "k_len": k_len}
    for layer, pp in enumerate(_unstack(params["dec"]["stack"],
                                        cfg.n_layers)):
        cc = tree_map(lambda t: t[layer], cache)
        x, nc = _dec_layer(cfg, pp, x, None, ctx, cc)
        tree_map(_copy_into, cc, nc)
    return _logits(cfg, params, x)[:, 0], cache


# ---------------------------------------------------------------------------
# Cache layout (must match what prefill builds)
# ---------------------------------------------------------------------------
def cache_spec(cfg, B, S_dec, S_enc):
    """Tree of ``CacheLeaf``, each stacked on the decoder's layer axis."""
    dt = to_dtype(cfg.compute_dtype)
    K, hd, L = cfg.n_kv_eff, cfg.head_dim, cfg.n_layers

    def leaf(S):
        return CacheLeaf((L, B, S, K, hd), dt)
    return {"self": {"k": leaf(S_dec), "v": leaf(S_dec)},
            "cross_k": leaf(S_enc), "cross_v": leaf(S_enc)}


def init_cache(cfg, B, S_dec, S_enc, device):
    """A zero cache (zeros, not uninitialised memory: see
    ``lm.init_cache``)."""
    return tree_map(lambda c: torch.zeros(c.shape, dtype=c.dtype,
                                          device=device),
                    cache_spec(cfg, B, S_dec, S_enc))


def abstract_cache(cfg, B, S_dec, S_enc):
    """The cache as ``meta`` tensors."""
    return tree_map(lambda c: torch.empty(c.shape, dtype=c.dtype,
                                          device="meta"),
                    cache_spec(cfg, B, S_dec, S_enc))


def cache_logical(cfg):
    """Logical axes of the cache's tensors, parallel to ``cache_spec``."""
    ax = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    return {"self": {"k": ax, "v": ax}, "cross_k": ax, "cross_v": ax}
