"""Temporal-mixing sublayers (port of ``repro/models/mixers.py``): GQA
attention (full causal and sliding window), DeepSeek's multi-head latent
attention (MLA), the RG-LRU recurrence of RecurrentGemma, and the RWKV-6
time mix and channel mix.

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

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels.wkv6 import kernel as K4
from .layers import NEG_INF, _gelu, decode_attention, flash_attention, \
    rms_head_norm, rope_apply, split_last
from .params import ParamDef

P = ParamDef


# ===========================================================================
# GQA attention (kinds: 'attn' full causal, 'attn_local' sliding window)
# ===========================================================================
def attn_defs(cfg):
    D, H, K, hd = cfg.d_model, cfg.n_heads_eff, cfg.n_kv_eff, cfg.head_dim
    d = {"wq": P((D, H, hd), ("embed", "heads", "head_dim"), init="fan_in"),
         "wk": P((D, K, hd), ("embed", "kv_heads", "head_dim"), init="fan_in"),
         "wv": P((D, K, hd), ("embed", "kv_heads", "head_dim"), init="fan_in"),
         "wo": P((H, hd, D), ("heads", "head_dim", "embed"), init="fan_in")}
    if cfg.qk_norm:
        d["q_norm"] = P((hd,), (None,), init="ones")
        d["k_norm"] = P((hd,), (None,), init="ones")
    return d


def _proj(x, w):
    """(B, S, D) @ (D, heads, hd) -> (B, S, heads, hd)."""
    if isinstance(x, DTensor):
        return _proj_local(x, w)
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1],
                                                   *w.shape[1:])


def _proj_local(x, w):
    """``_proj`` of DTensors as Megatron's column-parallel product,
    through ``sharding.on_shards``: x's batch split as it is, the heads
    split over the other mesh axes that split w's heads, the rest of w
    gathered (FSDP).  (DTensor's own product may split a replicated w's
    columns unevenly across heads, which the head view cannot take.)"""
    from repro_torch.sharding import on_shards, shard_dims
    bdims = shard_dims(x, 0)
    hdims = [i for i in shard_dims(w, 1) if i not in bdims]
    return on_shards(
        lambda xl, wl: (xl @ wl.reshape(wl.shape[0], -1)).reshape(
            *xl.shape[:-1], *wl.shape[1:]),
        x.device_mesh, bdims, hdims, [(0, None), (None, 1)],
        [(0, x.ndim - 1)])(x, w)


def _qkv(cfg, p, x):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    return q, k, v


def _out(o, wo):
    """(B, S, H, hd) @ (H, hd, D) -> (B, S, D)."""
    return o.reshape(*o.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


def _out_local(o, wo):
    """``_out`` of DTensors as Megatron's row-parallel product, through
    ``sharding.on_shards``: o's batch split as it is, the heads over the
    other mesh axes that split o's heads, wo's heads alike and the rest of
    wo gathered (FSDP); the output a partial sum over the head axes.
    Whisper's attention takes it on DTensors: there DTensor's own product
    of the flattened heads meets a strided split in the backward it has no
    strategy for.  (The decoder-only models keep ``_out``: its sums come
    out in another order, which one AdamW step turns into 3e-3 of relative
    difference from the unsharded step on stablelm-12b.)"""
    from repro_torch.sharding import SUM, on_shards, shard_dims
    bdims = shard_dims(o, 0)
    hdims = [i for i in shard_dims(o, 2) if i not in bdims]
    return on_shards(
        lambda ol, wl: ol.reshape(*ol.shape[:2], -1)
        @ wl.reshape(-1, wl.shape[-1]),
        o.device_mesh, bdims, hdims, [(0, 2), (None, 0)],
        [(0, SUM)])(o, wo)


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
    if isinstance(cache, DTensor):
        return _write_slot_sharded(cache, new, idx)
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, idx.long()] = new[:, 0].to(cache.dtype)
    return cache


def _write_slot_sharded(cache, new, idx):
    """``_write_slot`` on a DTensor cache, in place on each rank's own
    block (DTensor has no in-place ``index_put_`` that keeps a split
    sequence): ``new`` and ``idx`` come to the cache's batch split, whole
    elsewhere, and a rank writes the rows whose slot lies in its block of
    the sequence."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding import flat_rank, shard_dims
    mesh, pl = cache.device_mesh, cache.placements
    whole = (Replicate(),) * mesh.ndim

    def placed(t, want):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, whole, run_check=False)
        return t.redistribute(mesh, want).to_local()
    nl = placed(new.to(cache.dtype), tuple(
        Replicate() if p == Shard(1) else p for p in pl))
    il = placed(idx, tuple(p if p == Shard(0) else Replicate()
                           for p in pl)).long()
    loc = cache.to_local()
    S = loc.shape[1]
    rel = il - flat_rank(mesh, shard_dims(cache, 1)) * S
    inside = (rel >= 0) & (rel < S)
    rows = torch.arange(loc.shape[0], device=loc.device)
    slot = rel.clamp(0, S - 1)
    keep = inside.reshape((-1,) + (1,) * (loc.dim() - 2))
    loc[rows, slot] = torch.where(keep, nl[:, 0], loc[rows, slot])
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
# MLA: DeepSeek multi-head latent attention
# ===========================================================================
def mla_defs(cfg):
    D, H, hd = cfg.d_model, cfg.n_heads_eff, cfg.head_dim
    ql, kl, rd = cfg.q_lora, cfg.kv_lora, cfg.rope_dim
    return {
        "wdq": P((D, ql), ("embed", "q_lora"), init="fan_in"),
        "q_norm": P((ql,), (None,), init="ones"),
        "wuq": P((ql, H, hd + rd), ("q_lora", "heads", None), init="fan_in"),
        "wdkv": P((D, kl + rd), ("embed", None), init="fan_in"),
        "kv_norm": P((kl,), (None,), init="ones"),
        "wuk": P((kl, H, hd), (None, "heads", "head_dim"), init="fan_in"),
        "wuv": P((kl, H, hd), (None, "heads", "head_dim"), init="fan_in"),
        "wo": P((H, hd, D), ("heads", "head_dim", "embed"), init="fan_in"),
    }


def _down(x, w):
    """x @ w, MLA's projection to a latent (q_lora, kv_lora + rope_dim);
    on DTensors through ``sharding.on_shards``: x's batch split as it is,
    w gathered whole (FSDP) and its gradient a partial sum over the batch
    ranks.  (DTensor's own product splits the sequence of the gradient
    arriving from the heads' column-parallel product, and has no strategy
    for the weight's gradient on the strided split that leaves.)"""
    if not isinstance(x, DTensor):
        return x @ w
    from repro_torch.sharding import on_shards, shard_dims
    return on_shards(lambda xl, wl: xl @ wl, x.device_mesh,
                     shard_dims(x, 0), [], [(0, None), (None, None)],
                     [(0, None)])(x, w)


def _mla_qc(cfg, p, x, pos):
    """The query path and the compressed kv latent, shared by every mode:
    q without and with rotary (B, S, H, hd) and (B, S, H, rope_dim), the
    normed latent ckv (B, S, kv_lora) and the shared rotary key (B, S,
    rope_dim).  JAX's ``_rms`` is ``rms_head_norm``'s arithmetic."""
    hd, rd = cfg.head_dim, cfg.rope_dim
    q = _proj(rms_head_norm(p["q_norm"], _down(x, p["wdq"])), p["wuq"])
    q_nope, q_rope = q[..., :hd], rope_apply(q[..., hd:], pos,
                                             cfg.rope_theta)
    ckv_full = _down(x, p["wdkv"])
    ckv = rms_head_norm(p["kv_norm"], ckv_full[..., :cfg.kv_lora])
    k_rope = rope_apply(ckv_full[..., None, cfg.kv_lora:], pos,
                        cfg.rope_theta)[..., 0, :]
    return q_nope, q_rope, ckv, k_rope


def mla_apply(cfg, p, x, ctx, cache, **_):
    """Train and prefill decompress k and v and run K3 with q/k of width
    hd + rope_dim and v of width hd (K3's (192, 128) pair at DeepSeek-V3's
    widths), scale 1/sqrt(hd + rope_dim); prefill caches the latent.
    Decode is the absorbed form over the latent cache."""
    if ctx["mode"] == "decode":
        return _mla_decode(cfg, p, x, ctx, cache)
    q, k, v, ckv, k_rope = mla_qkv(cfg, p, x, ctx["positions"])
    o = flash_attention(q, k, v, causal=True, window=None,
                        scale=1.0 / math.sqrt(cfg.head_dim + cfg.rope_dim))
    new_cache = ({"ckv": ckv, "krope": k_rope}
                 if ctx["mode"] == "prefill" else None)
    return _out(o, p["wo"]), new_cache


def mla_qkv(cfg, p, x, positions):
    """The q, k, v that K3 receives in a train/prefill pass (q and k of
    width hd + rope_dim, v of width hd, k decompressed from the latent and
    the shared rotary key broadcast over the heads), and the latent cache
    leaves ckv and krope."""
    q_nope, q_rope, ckv, k_rope = _mla_qc(cfg, p, x, positions)
    k_nope, v = _proj(ckv, p["wuk"]), _proj(ckv, p["wuv"])
    H, rd = q_nope.shape[2], cfg.rope_dim
    k_rope_h = k_rope[:, :, None, :].expand(*k_rope.shape[:2], H, rd)
    return (torch.cat([q_nope, q_rope], -1),
            torch.cat([k_nope, k_rope_h], -1), v, ckv, k_rope)


def _mla_decode(cfg, p, x, ctx, cache):
    """Absorbed-projection decode: the cache holds only the (kv_lora +
    rope_dim)-wide latent a token; W_UK is absorbed into the query and
    W_UV applied after the softmax, plain torch as JAX's einsums (scores
    and the context accumulated in f32, p cast to the cache's dtype)."""
    k_len = ctx["k_len"]
    q_nope, q_rope, ckv_new, krope_new = _mla_qc(cfg, p, x, k_len[:, None])
    ckv = _write_slot(cache["ckv"], ckv_new, k_len)
    krope = _write_slot(cache["krope"], krope_new, k_len)
    q_c = torch.einsum("bshk,lhk->bshl", q_nope, p["wuk"])
    s = (torch.einsum("bshl,btl->bhst", q_c.float(), ckv.float())
         + torch.einsum("bshr,btr->bhst", q_rope.float(), krope.float()))
    s = s * (1.0 / math.sqrt(cfg.head_dim + cfg.rope_dim))
    valid = torch.arange(ckv.shape[1], device=x.device)[None, :] < \
        (k_len + 1)[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    ctx_c = torch.einsum("bhst,btl->bshl", pr.to(ckv.dtype).float(),
                         ckv.float()).to(x.dtype)
    o = torch.einsum("bshl,lhk->bshk", ctx_c, p["wuv"])
    return _out(o, p["wo"]), {"ckv": ckv, "krope": krope}


# ===========================================================================
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# ===========================================================================
def rglru_defs(cfg):
    D, W, CW = cfg.d_model, cfg.lru_width, cfg.conv_width
    NB = cfg.n_heads                      # block-diagonal gate blocks
    Wb = W // NB
    return {
        "w_x": P((D, W), ("embed", "lru"), init="fan_in"),
        "w_gate": P((D, W), ("embed", "lru"), init="fan_in"),
        "conv_w": P((CW, W), (None, "lru"), init="fan_in"),
        "conv_b": P((W,), ("lru",), init="zeros"),
        "w_rg": P((NB, Wb, Wb), ("lru", None, None), init="fan_in"),
        "b_rg": P((W,), ("lru",), init="zeros"),
        "w_ig": P((NB, Wb, Wb), ("lru", None, None), init="fan_in"),
        "b_ig": P((W,), ("lru",), init="zeros"),
        "lam": P((W,), ("lru",), init="ones"),
        "w_out": P((W, D), ("lru", "embed"), init="fan_in"),
    }


_LRU_C = 8.0


def _block_diag(u, w):
    """u: (..., W) x block-diagonal w: (NB, Wb, Wb) -> (..., W)."""
    NB, Wb, _ = w.shape
    ub = split_last(u, (NB, Wb))
    return torch.einsum("...nw,nwv->...nv", ub, w).reshape(u.shape)


def _lru_gates(p, u):
    """(log a, input gate), both f32: log a = -8 r softplus(lambda)."""
    r = torch.sigmoid(_block_diag(u, p["w_rg"]) + p["b_rg"]).float()
    i = torch.sigmoid(_block_diag(u, p["w_ig"]) + p["b_ig"]).float()
    return -_LRU_C * r * F.softplus(p["lam"].float()), i


def _lru_input(log_a, i, uc):
    """b = sqrt(1 - a^2) (i u): the gated, normalised input, f32."""
    return torch.sqrt(torch.clamp(1 - torch.exp(2 * log_a), min=1e-12)) \
        * (i * uc.float())


def lru_scan(log_a, b):
    """h_t = a_t h_(t-1) + b_t from h = 0 over axis 1, as JAX's
    ``lax.associative_scan`` of (log a, b) under the combine
    (a1 + a2, exp(a2) b1 + b2): a doubling scan in log space, ceil(log2 S)
    whole-sequence elementwise steps (each position t takes the pair d
    places back, the identity (0, 0) before the start).  Not a Python
    loop over positions: at S = 4096 and 26 RG-LRU layers that would be
    about 10^5 launches a pass.  The partial sums differ from JAX's tree
    in order only."""
    S, d = log_a.shape[1], 1
    while d < S:
        pad = (0, 0, d, 0)
        b = torch.exp(log_a) * F.pad(b[:, :S - d], pad) + b
        log_a = log_a + F.pad(log_a[:, :S - d], pad)
        d *= 2
    return b


def rglru_apply(cfg, p, x, ctx, cache, **_):
    CW = cfg.conv_width
    gate = _gelu(x @ p["w_gate"])
    u = x @ p["w_x"]
    if ctx["mode"] == "decode":
        hist = torch.cat([cache["conv"], u], 1)          # (B, CW, W)
        uc = torch.einsum("bcw,cw->bw", hist, p["conv_w"])[:, None] \
            + p["conv_b"]
        log_a, i = _lru_gates(p, uc)
        h = torch.exp(log_a)[:, 0] * cache["h"] + \
            _lru_input(log_a, i, uc)[:, 0]               # (B, W) f32 state
        y = (h[:, None].to(x.dtype) * gate) @ p["w_out"]
        return y, {"h": h, "conv": hist[:, 1:]}
    # train / prefill: causal depthwise conv, then the scan
    S = u.shape[1]
    uc = sum(F.pad(u, (0, 0, CW - 1 - k, 0))[:, :S] * p["conv_w"][k]
             for k in range(CW)) + p["conv_b"]
    log_a, i = _lru_gates(p, uc)
    h = lru_scan(log_a, _lru_input(log_a, i, uc))
    y = (h.to(x.dtype) * gate) @ p["w_out"]
    new_cache = None
    if ctx["mode"] == "prefill":
        new_cache = {"h": h[:, -1], "conv": u[:, S - (CW - 1):]}
    return y, new_cache


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
        "mu_base": P((D,), (None,), init="zeros"),
        "mu": P((5, D), (None, None), init="zeros"),       # r,k,v,w,g
        "tm_a": P((D, 5 * _TM_LORA), ("embed", None), init="fan_in"),
        "tm_b": P((5, _TM_LORA, D), (None, None, None), init="zeros"),
        "wr": P((D, M), ("embed", "heads_flat"), init="fan_in"),
        "wk": P((D, M), ("embed", "heads_flat"), init="fan_in"),
        "wv": P((D, M), ("embed", "heads_flat"), init="fan_in"),
        "wg": P((D, M), ("embed", "heads_flat"), init="fan_in"),
        "w0": P((M,), ("heads_flat",), init="zeros"),
        "wd_a": P((D, _DECAY_LORA), ("embed", None), init="fan_in"),
        "wd_b": P((_DECAY_LORA, M), (None, "heads_flat"), init="zeros"),
        "u": P((H, hd), ("heads", None), init="zeros"),
        "ln_scale": P((M,), ("heads_flat",), init="ones"),
        "wo": P((M, D), ("heads_flat", "embed"), init="fan_in"),
    }


def _ddlerp(p, x, x_prev):
    """RWKV6 data-dependent token-shift mixing -> (5, B, S, D)."""
    dx = x_prev - x
    xx = x + dx * p["mu_base"]
    lora = split_last(torch.tanh(xx @ p["tm_a"]), (5, _TM_LORA))
    adj = torch.einsum("bsft,ftd->fbsd", lora, p["tm_b"])
    mix = p["mu"][:, None, None, :] + adj                 # (5, B, S, D)
    return x[None] + dx[None] * mix


def rwkv6_inputs(cfg, p, x, x_prev):
    """r, k, v (x's dtype), the gate g, the log-decays lw (f32, <= 0) and
    the bonus u (f32): what the recurrence (K4 in prefill) receives."""
    H, hd = cfg.rwkv_heads, cfg.head_dim
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev)
    r = split_last(xr @ p["wr"], (H, hd))
    k = split_last(xk @ p["wk"], (H, hd))
    v = split_last(xv @ p["wv"], (H, hd))
    g = F.silu(xg @ p["wg"])
    lw = -torch.exp((p["w0"] + torch.tanh(xw @ p["wd_a"]) @ p["wd_b"])
                    .float())
    lw = split_last(lw, (H, hd))
    return r, k, v, g, lw, p["u"].float()


def _wkv6_local(r, k, v, lw, u):
    """K4 on each rank's shards of DTensor r, k, v, lw (B, S, H, hd) and u
    (H, hd), through ``sharding.on_shards``: the batch split as r's batch
    is, the heads over every other mesh axis if they divide them."""
    from repro_torch.sharding import on_shards, shard_dims, split_dims
    mesh = r.device_mesh
    bdims = shard_dims(r, 0)
    x = (0, 2)
    return on_shards(
        lambda *a: K4.WKV6Function.apply(*(t.contiguous() for t in a)),
        mesh, bdims, split_dims(mesh, bdims, r.shape[2]),
        [x, x, x, x, (None, 0)], [x, (0, 1)])(r, k, v, lw, u)


def _rwkv6_step(r1, k1, v1, lw1, u, state0):
    """One decode step of the recurrence: r, k, v, lw (B, H, hd), u (H, hd)
    and the state (B, H, hd, hd) -> (y (B, H, hd) f32, state')."""
    rt, kt, vt = r1.float(), k1.float(), v1.float()
    # y = r (state + (u * k) v^T);  state' = diag(w) state + k v^T, with
    # k v^T in the activations' dtype, as JAX's einsum of two of them
    y = torch.einsum("bhd,bhdv->bhv", rt, state0) + \
        (rt * u * kt).sum(-1, keepdim=True) * vt
    state = torch.exp(lw1)[..., None] * state0 + \
        (k1[..., :, None] * v1[..., None, :]).float()
    return y, state


def _rwkv6_step_local(r1, k1, v1, lw1, u, state0):
    """``_rwkv6_step`` on each rank's shards of DTensors, as ``_wkv6_local``
    places K4: the batch split as the state's batch is, the heads over
    every other mesh axis if they divide them."""
    from repro_torch.sharding import on_shards, shard_dims, split_dims
    mesh = state0.device_mesh
    bdims = shard_dims(state0, 0)
    x = (0, 1)
    return on_shards(_rwkv6_step, mesh, bdims,
                     split_dims(mesh, bdims, state0.shape[1]),
                     [x, x, x, x, (None, 0), x], [x, x])(
                         r1, k1, v1, lw1, u, state0)


def _shifted(x):
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)


def rwkv6_apply(cfg, p, x, ctx, cache, **_):
    mode = ctx["mode"]
    B, S, D = x.shape
    H, hd = cfg.rwkv_heads, cfg.head_dim
    x_prev = cache["shift"][:, None] if mode == "decode" else _shifted(x)
    r, k, v, g, lw, u = rwkv6_inputs(cfg, p, x, x_prev)

    if mode == "decode":   # single-step recurrence, plain torch
        args = (r[:, 0], k[:, 0], v[:, 0], lw[:, 0], u, cache["state"])
        y, state = (_rwkv6_step_local(*args) if isinstance(r, DTensor)
                    else _rwkv6_step(*args))
        y = y[:, None]                                     # (B, 1, H, hd)
        new_cache = {"state": state, "shift": x[:, -1]}
    else:   # the chunked recurrence on K4, with its backward kernel
        y, state = (_wkv6_local(r, k, v, lw, u) if isinstance(r, DTensor)
                    else K4.WKV6Function.apply(r, k, v, lw, u))
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
    return {"mu_k": P((D,), (None,), init="zeros"),
            "w_up": P((D, FF), ("embed", "mlp"), init="fan_in"),
            "w_down": P((FF, D), ("mlp", "embed"), init="fan_in")}


def rwkv_cm_apply(cfg, p, x, ctx, cache):
    decode = ctx["mode"] == "decode"
    x_prev = cache["shift"][:, None] if decode else _shifted(x)
    xk = x + (x_prev - x) * p["mu_k"]
    h = torch.relu(xk @ p["w_up"]).square()
    y = h @ p["w_down"]
    new_cache = {"shift": x[:, -1]} if ctx["mode"] != "train" else None
    return y, new_cache
