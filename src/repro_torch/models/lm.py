"""Decoder-only LM over the ported mixers and FFNs (port of
``repro/models/lm.py``).

A config's ``layer_plan()`` splits the stack into groups; each group's
parameters are one tree stacked on a leading layer axis, and a Python loop
over that axis takes the place of JAX's ``lax.scan``.  Three modes share one
code path: 'train' (full-sequence logits, differentiable: K3 and K4 carry
their backward kernels, and with ``cfg.remat`` each period runs under
``torch.utils.checkpoint``, as JAX wraps it in ``jax.checkpoint``),
'prefill' (last-position logits and the built KV/state cache) and 'decode'
(one token against a cache, which is updated in place and returned).
``forward`` and ``prefill`` take an optional multimodal prefix
(``batch["prefix_embeds"]``, llava's patch embeddings) ahead of the tokens;
``forward`` returns the MoE load-balance loss summed over the layers and,
where the config has multi-token prediction (DeepSeek-V3), the MTP head's
logits.  ``forward``, ``prefill`` and ``decode_step`` take the activation
hook ``sc(x, logical_axes)`` (default: none) at JAX's places, the residual
stream, the assembled input and the logits: on a mesh it is
``launch.shardctx.ShardCtx``, which redistributes DTensor activations to
their resolved placements.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import mixers, moe
from .layers import embed_lookup, mlp_apply, mlp_defs, norm_apply, \
    norm_defs
from .params import (ParamDef, abstract_params, leaves, logical_tree,
                     stack_defs, to_dtype, tree_map, unflatten)

P = ParamDef

_MIXER_DEFS = {
    "attn": mixers.attn_defs,
    "attn_local": mixers.attn_defs,
    "mla": mixers.mla_defs,
    "rglru": mixers.rglru_defs,
    "rwkv6": mixers.rwkv6_defs,
}


def _mixer_apply(cfg, kind, p, x, ctx, cache):
    if kind == "attn":
        return mixers.attn_apply(cfg, p, x, ctx, cache, window=None)
    if kind == "attn_local":
        return mixers.attn_apply(cfg, p, x, ctx, cache, window=cfg.window)
    if kind == "mla":
        return mixers.mla_apply(cfg, p, x, ctx, cache)
    if kind == "rglru":
        return mixers.rglru_apply(cfg, p, x, ctx, cache)
    if kind == "rwkv6":
        return mixers.rwkv6_apply(cfg, p, x, ctx, cache)
    raise ValueError(kind)


def _ffn_defs(cfg, kind):
    if kind == "dense":
        return mlp_defs(cfg)
    if kind == "moe":
        return moe.moe_defs(cfg)
    if kind == "rwkv_cm":
        return mixers.rwkv_cm_defs(cfg)
    raise ValueError(kind)


def _ffn_apply(cfg, kind, p, x, ctx, cache):
    """-> (y, new_cache, aux)."""
    if kind == "dense":
        return mlp_apply(cfg, p, x), None, 0.0
    if kind == "moe":
        y, aux = moe.moe_apply(cfg, p, x)
        return y, None, aux
    if kind == "rwkv_cm":
        return (*mixers.rwkv_cm_apply(cfg, p, x, ctx, cache), 0.0)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Layer / period / group
# ---------------------------------------------------------------------------
def _layer_defs(cfg, kind, ffn_kind):
    d = {"norm1": norm_defs(cfg, cfg.d_model),
         "mixer": _MIXER_DEFS[kind](cfg),
         "ffn": _ffn_defs(cfg, ffn_kind)}
    if not cfg.parallel_block:
        d["norm2"] = norm_defs(cfg, cfg.d_model)
    return d


_RESID = ("batch", None, "embed")


def _no_sc(x, _):
    return x


def _layer_apply(cfg, kind, ffn_kind, p, x, ctx, cache):
    sc = ctx["sc"]
    cache = cache or {}
    if cfg.parallel_block:
        h = norm_apply(cfg, p["norm1"], x)
        ym, mc = _mixer_apply(cfg, kind, p["mixer"], h, ctx,
                              cache.get("mixer"))
        yf, fc, aux = _ffn_apply(cfg, ffn_kind, p["ffn"], h, ctx,
                                 cache.get("ffn"))
        x = sc(x + ym + yf, _RESID)
    else:
        ym, mc = _mixer_apply(cfg, kind, p["mixer"],
                              norm_apply(cfg, p["norm1"], x), ctx,
                              cache.get("mixer"))
        x = sc(x + ym, _RESID)
        yf, fc, aux = _ffn_apply(cfg, ffn_kind, p["ffn"],
                                 norm_apply(cfg, p["norm2"], x), ctx,
                                 cache.get("ffn"))
        x = sc(x + yf, _RESID)
    return x, {"mixer": mc, "ffn": fc}, aux


def _period_defs(cfg, mixers_t, ffn_kind):
    return {f"sub{t}": _layer_defs(cfg, k, ffn_kind)
            for t, k in enumerate(mixers_t)}


def _period_apply(cfg, mixers_t, ffn_kind, p, x, ctx, cache):
    ncs, aux = {}, 0.0
    for t, k in enumerate(mixers_t):
        x, ncs[f"sub{t}"], a = _layer_apply(
            cfg, k, ffn_kind, p[f"sub{t}"], x, ctx,
            (cache or {}).get(f"sub{t}"))
        aux = aux + a
    return x, ncs, aux


def _copy_into(view, new):
    if new is not view:
        view.copy_(new)


def _unstack(p_group, repeat):
    """The group's per-layer parameter trees: each stacked leaf unbound once
    on its layer axis, so that autograd gathers a leaf's per-layer
    gradients in one stack (a slice per layer would add a zero-filled
    leaf-sized gradient for every layer)."""
    cols = [t.unbind(0) for t in leaves(p_group)]
    return [unflatten(p_group, [c[layer] for c in cols])
            for layer in range(repeat)]


def _group_apply(cfg, plan_entry, p_group, x, ctx, cache_group):
    """One group, layer by layer -> (x, cache, aux summed over the group's
    layers).  Prefill returns the layer-stacked cache; decode writes each
    layer's new cache into ``cache_group``; train runs each period under
    ``checkpoint`` when ``cfg.remat``."""
    mixers_t, ffn_kind, repeat = plan_entry
    mode = ctx["mode"]
    aux = 0.0
    if mode == "train":
        def period(pp, xc):
            xo, _, a = _period_apply(cfg, mixers_t, ffn_kind, pp, xc, ctx,
                                     None)
            return xo, a
        for pp in _unstack(p_group, repeat):
            x, a = (checkpoint(period, pp, x, use_reentrant=False)
                    if cfg.remat else period(pp, x))
            aux = aux + a
        return x, None, aux
    built = []
    for layer, pp in enumerate(_unstack(p_group, repeat)):
        cc = (tree_map(lambda t: t[layer], cache_group)
              if mode == "decode" else None)
        x, nc, a = _period_apply(cfg, mixers_t, ffn_kind, pp, x, ctx, cc)
        aux = aux + a
        if mode == "prefill":
            built.append(nc)
        elif mode == "decode":
            tree_map(_copy_into, cc, nc)
    if mode == "prefill":
        return x, tree_map(lambda *ts: torch.stack(ts), *built), aux
    return x, cache_group, aux


# ---------------------------------------------------------------------------
# Whole-model parameter definitions
# ---------------------------------------------------------------------------
def param_defs(cfg) -> Dict[str, Any]:
    V, D = cfg.vocab_eff, cfg.d_model
    defs = {"embed": {"table": P((V, D), ("vocab", "embed"))}}
    defs["groups"] = tuple(
        stack_defs(_period_defs(cfg, mixers_t, ffn_kind), repeat)
        for mixers_t, ffn_kind, repeat in cfg.layer_plan())
    defs["final_norm"] = norm_defs(cfg, D)
    if not cfg.tie_embeddings:
        defs["head"] = {"w": P((D, V), ("embed", "vocab"), init="fan_in")}
    if cfg.mtp:
        defs["mtp"] = {
            "norm_h": norm_defs(cfg, D),
            "norm_e": norm_defs(cfg, D),
            "proj": P((2 * D, D), (None, "embed"), init="fan_in"),
            "block": _layer_defs(cfg, cfg.pattern[0], _mtp_ffn(cfg)),
        }
    return defs


def abstract(cfg):
    """The parameter tree as ``meta`` tensors (shapes and dtypes only)."""
    return abstract_params(param_defs(cfg), cfg.param_dtype)


def logical(cfg):
    """The parameter tree's logical axis names, one tuple a leaf."""
    return logical_tree(param_defs(cfg))


def _mtp_ffn(cfg):
    """The MTP block's FFN: dense when the config starts with dense layers
    (DeepSeek-V3's first_dense) or has no experts, else MoE."""
    return "dense" if cfg.first_dense or not cfg.n_experts else "moe"


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
def _as_tensor(x, device):
    """``x`` as a tensor on ``device``; a DTensor stays as it is."""
    from torch.distributed.tensor import DTensor
    return x if isinstance(x, DTensor) else torch.as_tensor(x,
                                                            device=device)


def _embed(cfg, params, tokens):
    return embed_lookup(params["embed"]["table"], tokens).to(
        to_dtype(cfg.compute_dtype))


def _assemble_input(cfg, params, batch, sc=_no_sc):
    """tokens (and an optional multimodal prefix of embeddings ahead of
    them) -> (x (B, S, D), prefix length)."""
    dev = params["embed"]["table"].device
    parts, prefix = [], 0
    if "prefix_embeds" in batch:           # llava's patch embeddings
        pe = _as_tensor(batch["prefix_embeds"], dev)
        parts.append(pe.to(to_dtype(cfg.compute_dtype)))
        prefix = pe.shape[1]
    if batch.get("tokens") is not None:
        parts.append(_embed(cfg, params, _as_tensor(batch["tokens"], dev)))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
    return sc(x, _RESID), prefix


def _head(cfg, params, x):
    """f32 logits: products of the working dtype accumulated in f32, as
    JAX's ``preferred_element_type=F32``."""
    if cfg.tie_embeddings:
        return x.float() @ params["embed"]["table"].float().t()
    return x.float() @ params["head"]["w"].float()


def _positions(S, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None, :]


def forward(cfg, params, batch, sc=None):
    """Train-mode forward: full-sequence f32 logits (prefix positions
    included), the MoE aux loss summed over layers, the prefix length, and
    with ``cfg.mtp`` and tokens the MTP head's logits (``mtp_logits``)."""
    sc = sc or _no_sc
    x, prefix = _assemble_input(cfg, params, batch, sc)
    ctx = {"mode": "train", "sc": sc,
           "positions": _positions(x.shape[1], x.device)}
    aux = 0.0
    for plan_entry, pg in zip(cfg.layer_plan(), params["groups"]):
        x, _, a = _group_apply(cfg, plan_entry, pg, x, ctx, None)
        aux = aux + a
    h = norm_apply(cfg, params["final_norm"], x)
    out = {"logits": sc(_head(cfg, params, h), ("batch", None, "vocab")),
           "aux_loss": aux, "prefix": prefix}
    if cfg.mtp and batch.get("tokens") is not None:
        tokens = _as_tensor(batch["tokens"], h.device)
        out["mtp_logits"] = _mtp_logits(cfg, params, h, tokens, ctx, prefix)
    return out


def _mtp_logits(cfg, params, h, tokens, ctx, prefix):
    """DeepSeek-style depth-1 multi-token prediction head: the trunk's
    final-normed state at position t with the embedding of token t + 1,
    through one block of the first mixer kind, predicts token t + 2; it
    shares the output head (the block's aux loss is dropped, as in JAX)."""
    mp = params["mtp"]
    emb = _embed(cfg, params, tokens[:, 1:])               # token t + 1
    z = torch.cat([norm_apply(cfg, mp["norm_h"], h[:, prefix:-1]),
                   norm_apply(cfg, mp["norm_e"], emb)], -1) @ mp["proj"]
    mctx = dict(ctx, positions=_positions(z.shape[1], z.device))
    z, _, _ = _layer_apply(cfg, cfg.pattern[0], _mtp_ffn(cfg), mp["block"],
                           z, mctx, None)
    return _head(cfg, params, z)


def prefill(cfg, params, batch, sc=None):
    """-> (last-position logits (B, V), cache, k_len (B,)); the cache and
    k_len count the prefix positions too."""
    sc = sc or _no_sc
    x, _ = _assemble_input(cfg, params, batch, sc)
    B, S = x.shape[:2]
    ctx = {"mode": "prefill", "sc": sc, "positions": _positions(S, x.device)}
    caches = []
    for plan_entry, pg in zip(cfg.layer_plan(), params["groups"]):
        x, nc, _ = _group_apply(cfg, plan_entry, pg, x, ctx, None)
        caches.append(nc)
    h = norm_apply(cfg, params["final_norm"], x[:, -1:])
    logits = _head(cfg, params, h)[:, 0]
    return logits, tuple(caches), torch.full((B,), S, dtype=torch.int32,
                                             device=x.device)


def decode_step(cfg, params, cache, token, k_len, sc=None):
    """token: (B,) int; k_len: (B,) valid cache length.
    -> (logits (B, V), cache): the cache is updated in place."""
    x = _embed(cfg, params, token[:, None])
    ctx = {"mode": "decode", "sc": sc or _no_sc, "k_len": k_len,
           "positions": k_len[:, None]}
    for plan_entry, pg, cg in zip(cfg.layer_plan(), params["groups"], cache):
        x, _, _ = _group_apply(cfg, plan_entry, pg, x, ctx, cg)
    h = norm_apply(cfg, params["final_norm"], x)
    return _head(cfg, params, h)[:, 0], cache


# ---------------------------------------------------------------------------
# Cache layout (must match what prefill builds)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CacheLeaf:
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _mixer_cache_spec(cfg, kind, B, S):
    dt = to_dtype(cfg.compute_dtype)
    K, hd = cfg.n_kv_eff, cfg.head_dim
    if kind == "attn":
        return {"k": CacheLeaf((B, S, K, hd), dt),
                "v": CacheLeaf((B, S, K, hd), dt)}
    if kind == "attn_local":
        W = min(cfg.window, S)
        return {"k": CacheLeaf((B, W, K, hd), dt),
                "v": CacheLeaf((B, W, K, hd), dt),
                "slot_pos": CacheLeaf((B, W), torch.int32)}
    if kind == "mla":
        return {"ckv": CacheLeaf((B, S, cfg.kv_lora), dt),
                "krope": CacheLeaf((B, S, cfg.rope_dim), dt)}
    if kind == "rglru":
        W = cfg.lru_width
        return {"h": CacheLeaf((B, W), torch.float32),
                "conv": CacheLeaf((B, cfg.conv_width - 1, W), dt)}
    if kind == "rwkv6":
        H = cfg.rwkv_heads
        return {"state": CacheLeaf((B, H, hd, hd), torch.float32),
                "shift": CacheLeaf((B, cfg.d_model), dt)}
    raise ValueError(kind)


def cache_spec(cfg, B, S):
    """Tree of ``CacheLeaf`` matching the prefill cache layout, each leaf
    stacked on the group's layer axis."""
    groups = []
    for mixers_t, ffn_kind, repeat in cfg.layer_plan():
        period = {}
        for t, k in enumerate(mixers_t):
            ffn = ({"shift": CacheLeaf((B, cfg.d_model),
                                       to_dtype(cfg.compute_dtype))}
                   if ffn_kind == "rwkv_cm" else None)
            period[f"sub{t}"] = {"mixer": _mixer_cache_spec(cfg, k, B, S),
                                 "ffn": ffn}
        groups.append(tree_map(
            lambda c: CacheLeaf((repeat,) + c.shape, c.dtype), period))
    return tuple(groups)


def init_cache(cfg, B, S, device):
    """A zero cache.  Zeros, not uninitialised memory: decode attention
    masks stale slots to p = 0 but still multiplies 0 * v there, and a NaN
    bit pattern would poison the row."""
    return tree_map(lambda c: torch.zeros(c.shape, dtype=c.dtype,
                                          device=device),
                    cache_spec(cfg, B, S))


def grow_cache(cfg, cache, B, new_len):
    """Zero-pad a prefill-built cache to a larger decode capacity: any dim
    smaller than ``cache_spec(cfg, B, new_len)``'s is padded at its end."""
    def grow(x, c):
        if tuple(x.shape) == c.shape:
            return x
        if any(s > t for s, t in zip(x.shape, c.shape)):
            raise ValueError(f"cache leaf {tuple(x.shape)} exceeds "
                             f"{c.shape}")
        out = x.new_zeros(c.shape)
        out[tuple(slice(0, s) for s in x.shape)] = x
        return out
    return tree_map(grow, cache, cache_spec(cfg, B, new_len))


def abstract_cache(cfg, B, S):
    """The cache as ``meta`` tensors (``cache_spec``'s shapes and dtypes)."""
    return tree_map(lambda c: torch.empty(c.shape, dtype=c.dtype,
                                          device="meta"),
                    cache_spec(cfg, B, S))


_MIXER_CACHE_LOGICAL = {
    "attn": {"k": ("batch", "cache_seq", "kv_heads", "head_dim"),
             "v": ("batch", "cache_seq", "kv_heads", "head_dim")},
    "attn_local": {"k": ("batch", "cache_seq", "kv_heads", "head_dim"),
                   "v": ("batch", "cache_seq", "kv_heads", "head_dim"),
                   "slot_pos": ("batch", None)},
    "mla": {"ckv": ("batch", "cache_seq", None),
            "krope": ("batch", "cache_seq", None)},
    "rglru": {"h": ("batch", "lru"), "conv": ("batch", None, "lru")},
    "rwkv6": {"state": ("batch", "heads", None, None),
              "shift": ("batch", None)},
}


def cache_logical(cfg):
    """Logical axes of the cache's tensors, parallel to ``cache_spec``."""
    groups = []
    for mixers_t, ffn_kind, repeat in cfg.layer_plan():
        period = {}
        for t, k in enumerate(mixers_t):
            period[f"sub{t}"] = {
                "mixer": {n: ("layers",) + ax
                          for n, ax in _MIXER_CACHE_LOGICAL[k].items()},
                "ffn": ({"shift": ("layers", "batch", None)}
                        if ffn_kind == "rwkv_cm" else None)}
        groups.append(period)
    return tuple(groups)
