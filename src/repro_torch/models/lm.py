"""Decoder-only LM over the ported mixers (port of ``repro/models/lm.py``).

A config's ``layer_plan()`` splits the stack into groups; each group's
parameters are one tree stacked on a leading layer axis, and a Python loop
over that axis takes the place of JAX's ``lax.scan``.  Three modes share one
code path: 'train' (full-sequence logits, differentiable: K3 and K4 carry
their backward kernels, and with ``cfg.remat`` each period runs under
``torch.utils.checkpoint``, as JAX wraps it in ``jax.checkpoint``),
'prefill' (last-position logits and the built KV/state cache) and 'decode'
(one token against a cache, which is updated in place and returned).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import mixers
from .layers import mlp_apply, mlp_defs, norm_apply, norm_defs
from .params import (ParamDef, leaves, stack_defs, to_dtype, tree_map,
                     unflatten)

P = ParamDef

_MIXER_DEFS = {
    "attn": mixers.attn_defs,
    "attn_local": mixers.attn_defs,
    "rwkv6": mixers.rwkv6_defs,
}


def _mixer_apply(cfg, kind, p, x, ctx, cache):
    if kind == "attn":
        return mixers.attn_apply(cfg, p, x, ctx, cache, window=None)
    if kind == "attn_local":
        return mixers.attn_apply(cfg, p, x, ctx, cache, window=cfg.window)
    if kind == "rwkv6":
        return mixers.rwkv6_apply(cfg, p, x, ctx, cache)
    raise ValueError(kind)


def _ffn_defs(cfg, kind):
    if kind == "dense":
        return mlp_defs(cfg)
    if kind == "rwkv_cm":
        return mixers.rwkv_cm_defs(cfg)
    raise ValueError(kind)


def _ffn_apply(cfg, kind, p, x, ctx, cache):
    if kind == "dense":
        return mlp_apply(cfg, p, x), None
    if kind == "rwkv_cm":
        return mixers.rwkv_cm_apply(cfg, p, x, ctx, cache)
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


def _layer_apply(cfg, kind, ffn_kind, p, x, ctx, cache):
    cache = cache or {}
    if cfg.parallel_block:
        h = norm_apply(cfg, p["norm1"], x)
        ym, mc = _mixer_apply(cfg, kind, p["mixer"], h, ctx,
                              cache.get("mixer"))
        yf, fc = _ffn_apply(cfg, ffn_kind, p["ffn"], h, ctx,
                            cache.get("ffn"))
        x = x + ym + yf
    else:
        ym, mc = _mixer_apply(cfg, kind, p["mixer"],
                              norm_apply(cfg, p["norm1"], x), ctx,
                              cache.get("mixer"))
        x = x + ym
        yf, fc = _ffn_apply(cfg, ffn_kind, p["ffn"],
                            norm_apply(cfg, p["norm2"], x), ctx,
                            cache.get("ffn"))
        x = x + yf
    return x, {"mixer": mc, "ffn": fc}


def _period_defs(cfg, mixers_t, ffn_kind):
    return {f"sub{t}": _layer_defs(cfg, k, ffn_kind)
            for t, k in enumerate(mixers_t)}


def _period_apply(cfg, mixers_t, ffn_kind, p, x, ctx, cache):
    ncs = {}
    for t, k in enumerate(mixers_t):
        x, ncs[f"sub{t}"] = _layer_apply(cfg, k, ffn_kind, p[f"sub{t}"], x,
                                         ctx, (cache or {}).get(f"sub{t}"))
    return x, ncs


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
    """One group, layer by layer.  Prefill returns the layer-stacked cache;
    decode writes each layer's new cache into ``cache_group``; train runs
    each period under ``checkpoint`` when ``cfg.remat``."""
    mixers_t, ffn_kind, repeat = plan_entry
    mode = ctx["mode"]
    if mode == "train":
        def period(pp, xc):
            return _period_apply(cfg, mixers_t, ffn_kind, pp, xc, ctx,
                                 None)[0]
        for pp in _unstack(p_group, repeat):
            x = (checkpoint(period, pp, x, use_reentrant=False)
                 if cfg.remat else period(pp, x))
        return x, None
    built = []
    for layer, pp in enumerate(_unstack(p_group, repeat)):
        cc = (tree_map(lambda t: t[layer], cache_group)
              if mode == "decode" else None)
        x, nc = _period_apply(cfg, mixers_t, ffn_kind, pp, x, ctx, cc)
        if mode == "prefill":
            built.append(nc)
        elif mode == "decode":
            tree_map(_copy_into, cc, nc)
    if mode == "prefill":
        return x, tree_map(lambda *ts: torch.stack(ts), *built)
    return x, cache_group


# ---------------------------------------------------------------------------
# Whole-model parameter definitions
# ---------------------------------------------------------------------------
def param_defs(cfg) -> Dict[str, Any]:
    V, D = cfg.vocab_eff, cfg.d_model
    defs = {"embed": {"table": P((V, D))}}
    defs["groups"] = tuple(
        stack_defs(_period_defs(cfg, mixers_t, ffn_kind), repeat)
        for mixers_t, ffn_kind, repeat in cfg.layer_plan())
    defs["final_norm"] = norm_defs(cfg, D)
    if not cfg.tie_embeddings:
        defs["head"] = {"w": P((D, V), init="fan_in")}
    return defs


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
def _embed(cfg, params, tokens):
    return params["embed"]["table"][tokens].to(to_dtype(cfg.compute_dtype))


def _head(cfg, params, x):
    """f32 logits: products of the working dtype accumulated in f32, as
    JAX's ``preferred_element_type=F32``."""
    if cfg.tie_embeddings:
        return x.float() @ params["embed"]["table"].float().t()
    return x.float() @ params["head"]["w"].float()


def _positions(S, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None, :]


def forward(cfg, params, batch):
    """Train-mode forward: full-sequence f32 logits."""
    tokens = torch.as_tensor(batch["tokens"])
    x = _embed(cfg, params, tokens.to(params["embed"]["table"].device))
    ctx = {"mode": "train", "positions": _positions(x.shape[1], x.device)}
    for plan_entry, pg in zip(cfg.layer_plan(), params["groups"]):
        x, _ = _group_apply(cfg, plan_entry, pg, x, ctx, None)
    h = norm_apply(cfg, params["final_norm"], x)
    return {"logits": _head(cfg, params, h), "aux_loss": 0.0, "prefix": 0}


def prefill(cfg, params, batch):
    """-> (last-position logits (B, V), cache, k_len (B,))."""
    tokens = torch.as_tensor(batch["tokens"])
    x = _embed(cfg, params, tokens.to(params["embed"]["table"].device))
    B, S = x.shape[:2]
    ctx = {"mode": "prefill", "positions": _positions(S, x.device)}
    caches = []
    for plan_entry, pg in zip(cfg.layer_plan(), params["groups"]):
        x, nc = _group_apply(cfg, plan_entry, pg, x, ctx, None)
        caches.append(nc)
    h = norm_apply(cfg, params["final_norm"], x[:, -1:])
    logits = _head(cfg, params, h)[:, 0]
    return logits, tuple(caches), torch.full((B,), S, dtype=torch.int32,
                                             device=x.device)


def decode_step(cfg, params, cache, token, k_len):
    """token: (B,) int; k_len: (B,) valid cache length.
    -> (logits (B, V), cache): the cache is updated in place."""
    x = _embed(cfg, params, token[:, None])
    ctx = {"mode": "decode", "k_len": k_len, "positions": k_len[:, None]}
    for plan_entry, pg, cg in zip(cfg.layer_plan(), params["groups"], cache):
        x, _ = _group_apply(cfg, plan_entry, pg, x, ctx, cg)
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
