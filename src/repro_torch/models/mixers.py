"""Temporal-mixing sublayers (port of ``repro/models/mixers.py``): GQA
attention (full causal and sliding window) and the RWKV-6 time mix and
channel mix.  MLA and RG-LRU are not ported yet (ROADMAP queue 1 item 15).

Every mixer exposes ``<kind>_defs(cfg)`` and
``<kind>_apply(cfg, p, x, ctx, cache) -> (y, new_cache)``; ``ctx`` keys:
mode ('train' | 'prefill' | 'decode'), positions, k_len (decode: valid
cache length per batch row).

In decode the key/value cache is written in place at each row's slot (an
indexed write where JAX blends a one-hot row, ``cache*(1-oh)+oh*new``,
which gives the same bits for finite values), and the returned cache holds
the same tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6 import kernel as K4
from .layers import decode_attention, flash_attention, rms_head_norm, \
    rope_apply
from .params import ParamDef

P = ParamDef


# ===========================================================================
# GQA attention (kinds: 'attn' full causal, 'attn_local' sliding window)
# ===========================================================================
def attn_defs(cfg):
    D, H, K, hd = cfg.d_model, cfg.n_heads_eff, cfg.n_kv_eff, cfg.head_dim
    d = {"wq": P((D, H, hd), init="fan_in"),
         "wk": P((D, K, hd), init="fan_in"),
         "wv": P((D, K, hd), init="fan_in"),
         "wo": P((H, hd, D), init="fan_in")}
    if cfg.qk_norm:
        d["q_norm"] = P((hd,), init="ones")
        d["k_norm"] = P((hd,), init="ones")
    return d


def _proj(x, w):
    """(B, S, D) @ (D, heads, hd) -> (B, S, heads, hd)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1],
                                                   *w.shape[1:])


def _qkv(cfg, p, x):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    return q, k, v


def _out(o, wo):
    """(B, S, H, hd) @ (H, hd, D) -> (B, S, D)."""
    return o.reshape(*o.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


def attn_qkv(cfg, p, x, positions):
    """The projections and rotary embedding of a train/prefill pass: the
    q, k, v that K3 receives."""
    q, k, v = _qkv(cfg, p, x)
    if cfg.positional == "rope":
        q = rope_apply(q, positions, cfg.rope_theta)
        k = rope_apply(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply(cfg, p, x, ctx, cache, *, window=None, causal=True):
    mode = ctx["mode"]
    if mode == "decode":
        return _attn_decode(cfg, p, x, ctx, cache, window)
    q, k, v = attn_qkv(cfg, p, x, ctx["positions"])
    o = flash_attention(q, k, v, causal=causal, window=window)
    y = _out(o, p["wo"])
    new_cache = None
    if mode == "prefill":
        if window is None:
            new_cache = {"k": k, "v": v}
        else:  # ring buffer holding the trailing window; slot = pos % W
            B, S = k.shape[:2]
            W = min(window, S)
            shift = (S - W) % W
            pos = torch.arange(S - W, S, dtype=torch.int32, device=x.device)
            new_cache = {
                "k": torch.roll(k[:, S - W:], shift, dims=1),
                "v": torch.roll(v[:, S - W:], shift, dims=1),
                "slot_pos": torch.roll(pos, shift)[None].expand(B, W)
                .contiguous()}
    return y, new_cache


def _write_slot(cache, new, idx):
    """cache: (B, S, ...); new: (B, 1, ...); idx: (B,) time slot per row.
    Writes in place and returns ``cache``."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, idx.long()] = new[:, 0].to(cache.dtype)
    return cache


def _attn_decode(cfg, p, x, ctx, cache, window):
    """x: (B, 1, D); cache k/v: (B, S, K, hd) (a ring when windowed)."""
    k_len = ctx["k_len"]                       # (B,) tokens already cached
    q, k, v = _qkv(cfg, p, x)
    if cfg.positional == "rope":
        pos = k_len[:, None]
        q = rope_apply(q, pos, cfg.rope_theta)
        k = rope_apply(k, pos, cfg.rope_theta)
    if window is None:
        kc = _write_slot(cache["k"], k, k_len)     # append at k_len
        vc = _write_slot(cache["v"], v, k_len)
        new_cache = {"k": kc, "v": vc}
        o = decode_attention(q, kc, vc, k_len=k_len + 1)
    else:
        W = cache["k"].shape[1]
        slot = k_len % W
        kc = _write_slot(cache["k"], k, slot)
        vc = _write_slot(cache["v"], v, slot)
        sp = _write_slot(cache["slot_pos"], k_len[:, None], slot)
        new_cache = {"k": kc, "v": vc, "slot_pos": sp}
        o = decode_attention(q, kc, vc, k_len=k_len + 1, window=window,
                             slot_pos=sp)
    return _out(o, p["wo"]), new_cache


# ===========================================================================
# WKV6 (RWKV "Finch"): data-dependent-decay linear attention
# ===========================================================================
_TM_LORA = 32
_DECAY_LORA = 64


def rwkv6_defs(cfg):
    D = cfg.d_model
    H, hd = cfg.rwkv_heads, cfg.head_dim
    M = H * hd
    return {
        "mu_base": P((D,), init="zeros"),
        "mu": P((5, D), init="zeros"),                     # r,k,v,w,g
        "tm_a": P((D, 5 * _TM_LORA), init="fan_in"),
        "tm_b": P((5, _TM_LORA, D), init="zeros"),
        "wr": P((D, M), init="fan_in"),
        "wk": P((D, M), init="fan_in"),
        "wv": P((D, M), init="fan_in"),
        "wg": P((D, M), init="fan_in"),
        "w0": P((M,), init="zeros"),
        "wd_a": P((D, _DECAY_LORA), init="fan_in"),
        "wd_b": P((_DECAY_LORA, M), init="zeros"),
        "u": P((H, hd), init="zeros"),
        "ln_scale": P((M,), init="ones"),
        "wo": P((M, D), init="fan_in"),
    }


def _ddlerp(p, x, x_prev):
    """RWKV6 data-dependent token-shift mixing -> (5, B, S, D)."""
    dx = x_prev - x
    xx = x + dx * p["mu_base"]
    lora = torch.tanh(xx @ p["tm_a"])
    lora = lora.reshape(*lora.shape[:-1], 5, _TM_LORA)
    adj = torch.einsum("bsft,ftd->fbsd", lora, p["tm_b"])
    mix = p["mu"][:, None, None, :] + adj                 # (5, B, S, D)
    return x[None] + dx[None] * mix


def rwkv6_inputs(cfg, p, x, x_prev):
    """r, k, v (x's dtype), the gate g, the log-decays lw (f32, <= 0) and
    the bonus u (f32): what the recurrence (K4 in prefill) receives."""
    B, S, _ = x.shape
    H, hd = cfg.rwkv_heads, cfg.head_dim
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev)
    r = (xr @ p["wr"]).reshape(B, S, H, hd)
    k = (xk @ p["wk"]).reshape(B, S, H, hd)
    v = (xv @ p["wv"]).reshape(B, S, H, hd)
    g = F.silu(xg @ p["wg"])
    lw = -torch.exp((p["w0"] + torch.tanh(xw @ p["wd_a"]) @ p["wd_b"])
                    .float()).reshape(B, S, H, hd)
    return r, k, v, g, lw, p["u"].float()


def _shifted(x):
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)


def rwkv6_apply(cfg, p, x, ctx, cache, **_):
    mode = ctx["mode"]
    B, S, D = x.shape
    H, hd = cfg.rwkv_heads, cfg.head_dim
    x_prev = cache["shift"][:, None] if mode == "decode" else _shifted(x)
    r, k, v, g, lw, u = rwkv6_inputs(cfg, p, x, x_prev)

    if mode == "decode":   # single-step recurrence, plain torch
        state0 = cache["state"]
        r1, k1, v1 = r[:, 0], k[:, 0], v[:, 0]
        rt, kt, vt = r1.float(), k1.float(), v1.float()
        # y = r (state + (u * k) v^T);  state' = diag(w) state + k v^T, with
        # k v^T in the activations' dtype, as JAX's einsum of two of them
        y = torch.einsum("bhd,bhdv->bhv", rt, state0) + \
            (rt * u * kt).sum(-1, keepdim=True) * vt
        state = torch.exp(lw[:, 0])[..., None] * state0 + \
            (k1[..., :, None] * v1[..., None, :]).float()
        y = y[:, None]                                     # (B, 1, H, hd)
        new_cache = {"state": state, "shift": x[:, -1]}
    else:
        y, state = K4.wkv6_fill(r, k, v, lw, u)
        y = y.to(x.dtype)
        new_cache = ({"state": state, "shift": x[:, S - 1]}
                     if mode == "prefill" else None)

    # per-head group norm, gate, output projection
    y = y.reshape(B, -1, H, hd)
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + 1e-6)
    y = (y.reshape(B, -1, H * hd) * p["ln_scale"]).to(x.dtype)
    return (y * g) @ p["wo"], new_cache


def rwkv_cm_defs(cfg):
    """RWKV channel mix (squared-ReLU FFN with token shift)."""
    D, FF = cfg.d_model, cfg.d_ff
    return {"mu_k": P((D,), init="zeros"),
            "w_up": P((D, FF), init="fan_in"),
            "w_down": P((FF, D), init="fan_in")}


def rwkv_cm_apply(cfg, p, x, ctx, cache):
    decode = ctx["mode"] == "decode"
    x_prev = cache["shift"][:, None] if decode else _shifted(x)
    xk = x + (x_prev - x) * p["mu_k"]
    h = torch.relu(xk @ p["w_up"]).square()
    y = h @ p["w_down"]
    new_cache = {"shift": x[:, -1]} if ctx["mode"] != "train" else None
    return y, new_cache
