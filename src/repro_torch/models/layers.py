"""Shared neural building blocks (port of ``repro/models/layers.py``).

Norms, rotary embeddings, the dense MLPs, single-position decode attention
(plain torch, as in JAX) and ``flash_attention``: the model-layout entry to
K3 (``kernels/flash_attn``), which takes the place of the JAX package's
blockwise XLA attention.  Functions take and return tensors in the JAX
package's layouts: activations (B, S, D), heads (B, S, H, hd).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels.flash_attn import kernel as K3
from .params import ParamDef

F32 = torch.float32
NEG_INF = -1e30


def split_last(x, shape):
    """``x.reshape(*x.shape[:-1], *shape)``; a DTensor whose last dim is
    split over mesh axes that do not divide ``shape[0]`` (a replicated
    weight's product, which DTensor may split by columns) is first made
    whole in that dim."""
    if isinstance(x, DTensor):
        from torch.distributed.tensor import Replicate
        last = x.ndim - 1
        n = math.prod(x.device_mesh.size(i)
                      for i, p in enumerate(x.placements) if p.is_shard(last))
        if shape[0] % n:
            x = x.redistribute(x.device_mesh, tuple(
                Replicate() if p.is_shard(last) else p
                for p in x.placements))
    return x.reshape(*x.shape[:-1], *shape)


def embed_lookup(table, ids):
    """``table[ids]`` (rows of a (V, D) table).  A DTensor table is looked
    up on local shards (``sharding.on_shards``), as Megatron's
    vocab-parallel embedding: ids split as their batch is, the table's
    vocabulary split as it is on the other mesh axes (each rank's rows of
    its own slice, zero elsewhere, the sum partial over those axes) and
    its embed dim gathered (FSDP)."""
    if not isinstance(table, DTensor):
        return table[ids]
    from torch.distributed.tensor import Replicate
    from repro_torch.sharding import SUM, flat_rank, on_shards, shard_dims
    mesh = table.device_mesh
    if not isinstance(ids, DTensor):      # positions: the same on every rank
        ids = DTensor.from_local(ids, mesh, (Replicate(),) * mesh.ndim,
                                 run_check=False)
    bdims = shard_dims(ids, 0)
    vdims = [i for i in shard_dims(table, 0) if i not in bdims]
    split = math.prod(mesh.size(i) for i in vdims) > 1

    def local(t, i):
        if not split:
            return t[i]
        idx = i - flat_rank(mesh, vdims) * t.shape[0]
        inside = (idx >= 0) & (idx < t.shape[0])
        rows = t[idx.clamp(0, t.shape[0] - 1)]
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))

    return on_shards(local, mesh, bdims, vdims, [(None, 0), (0, None)],
                     [(0, SUM)])(table, ids)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def norm_defs(cfg, dim: int):
    if cfg.norm == "rmsnorm":
        return {"scale": ParamDef((dim,), (None,), init="ones")}
    if cfg.norm == "layernorm":
        return {"scale": ParamDef((dim,), (None,), init="ones"),
                "bias": ParamDef((dim,), (None,), init="zeros")}
    if cfg.norm == "layernorm_np":      # olmo: non-parametric
        return {}
    raise ValueError(cfg.norm)


def norm_apply(cfg, p, x):
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
        return (xf * p["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + 1e-5)
    if cfg.norm == "layernorm":
        xf = xf * p["scale"].float() + p["bias"].float()
    return xf.to(x.dtype)


def rms_head_norm(scale, x):
    """Per-head q/k RMSNorm over the head_dim axis."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    return (xf * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (NeoX half-split convention)
# ---------------------------------------------------------------------------
def rope_apply(x, positions, theta: float, rope_dim: Optional[int] = None):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    rd = rope_dim or hd
    half = rd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=F32, device=x.device) / half)
    ang = positions.to(F32)[..., None] * freqs              # (..., S, half)
    sin = torch.sin(ang)[..., None, :]                      # (..., S, 1, half)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:rd]
    xr = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    if rd < hd:
        xr = torch.cat([xr, x[..., rd:]], -1)
    return xr.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def flash_attention(q, k, v, *, causal: bool, window: Optional[int],
                    q_start: int = 0, k_len=None,
                    scale: Optional[float] = None):
    """q: (B, Sq, H, hd), k: (B, Sk, K, hd), v: (B, Sk, K, hd_v) with
    H = K * G (GQA); returns (B, Sq, H, hd_v) in q's dtype, as JAX's
    ``flash_attention`` (Sk may differ from Sq, as in cross-attention, and
    hd_v from hd, as in MLA).  ``q_start``: the position of q[0] for the
    causal and window masks (keys sit at 0 .. Sk - 1); ``k_len``: keys at
    and past it are masked; ``scale`` defaults to 1/sqrt(hd).  On a CUDA
    tensor this is one launch of K3, which masks the ragged edges itself
    (built for the (hd, hd_v) pairs ``K3.WIDTH_PAIRS``: hd = hd_v from 16
    to 256, and MLA's 192 over 128); on a CPU tensor it is K3's plain
    version, over the same 64-row tiles.  p is
    rounded to v's dtype before p v on both devices, as JAX's model path
    casts it.  Where autograd records, it goes through
    ``K3.FlashAttnFunction`` (the forward also writes its lse; the
    backward is K3's backward kernel), as JAX's ``_flash_core`` is a
    custom_vjp; elsewhere (serving) the forward alone runs, with no lse.
    DTensor inputs run K3 on each rank's own heads (``_local_heads``)."""
    if isinstance(q, DTensor):
        return _local_heads(flash_attention, q, k, v, causal=causal,
                            window=window, q_start=q_start, k_len=k_len,
                            scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return K3.FlashAttnFunction.apply(q, k, v, causal, window, k_len,
                                          scale, v.dtype, q_start)
    return K3.flash_fill(q, k, v, causal=causal, window=window, k_len=k_len,
                         scale=scale, p_dtype=v.dtype, q_start=q_start)


def _local_heads(fn, q, k, v, **kw):
    """``fn`` (K3's entry) on each rank's local shards of DTensor q, k, v
    (B, S, heads, hd), through ``sharding.on_shards``: the batch split over
    the mesh axes that split q's batch, the query heads over every other
    axis if they divide them, and the key/value heads likewise where they
    divide.  Where they do not (GQA whose ``kv_heads`` do not divide the
    axis), the key/value heads stay whole on each rank and the rank takes
    the contiguous ones its query heads read (q head h reads kv head
    h // G); when a rank's query heads would not cover whole groups nor
    lie within one (phi3-medium's 40 over 10 on 8 ranks: 5 heads, groups
    of 4), the heads stay whole on every rank instead."""
    from repro_torch.sharding import flat_rank, on_shards, shard_dims, \
        split_dims
    mesh = q.device_mesh
    H, K = q.shape[2], k.shape[2]
    G = H // K
    bdims = shard_dims(q, 0)
    hdims = split_dims(mesh, bdims, H)
    n = math.prod(mesh.size(i) for i in hdims)
    h_loc = H // n
    if K % n and h_loc % G and G % h_loc:
        hdims, n, h_loc = [], 1, H
    kv_split = K % n == 0

    def local(ql, kl, vl):
        if not kv_split:        # the kv heads this rank's q heads read
            r = flat_rank(mesh, hdims)
            lo, hi = (r * h_loc) // G, ((r + 1) * h_loc - 1) // G + 1
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return fn(ql, kl.contiguous(), vl.contiguous(), **kw)

    kv = (0, 2) if kv_split else (0, None)
    return on_shards(local, mesh, bdims, hdims, [(0, 2), kv, kv],
                     [(0, 2)])(q, k, v)


def decode_attention(q, k_cache, v_cache, *, k_len, window=None,
                     slot_pos=None, scale=None):
    """Single-position attention over a (possibly ring-buffer) KV cache.

    q: (B, 1, H, hd); k/v_cache: (B, S, K, hd); ``k_len``: (B,) tokens
    valid; ``slot_pos``: (B, S) absolute position per ring slot (window
    caches); returns (B, 1, H, hd).  Scores and the softmax are f32, ``p``
    is cast to the cache's dtype before ``p @ v`` (as in JAX), and products
    accumulate in f32.  A DTensor cache runs on each rank's own blocks
    (``_decode_sharded``).
    """
    if isinstance(k_cache, DTensor):
        return _decode_sharded(q, k_cache, v_cache, k_len=k_len,
                               window=window, slot_pos=slot_pos, scale=scale)
    s, v = _decode_scores(q, k_cache, v_cache, k_len, window, slot_pos,
                          scale, 0)
    return _decode_out(q, torch.softmax(s, dim=-1), v)


def _decode_scores(q, k_cache, v_cache, k_len, window, slot_pos, scale,
                   s0):
    """Masked f32 scores (B, K, G, S) of q over the cache's S slots, which
    sit at positions s0 .. s0 + S - 1 of the whole cache."""
    B, _, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    k_len = torch.as_tensor(k_len, device=q.device).reshape(-1).expand(B)
    if slot_pos is not None:       # ring buffer: valid slots carry pos >= 0
        valid = slot_pos >= 0
        if window is not None:     # the query's position is k_len - 1
            valid = valid & (slot_pos > (k_len[:, None] - 1 - window))
    else:
        valid = (torch.arange(S, device=q.device)[None, :] + s0
                 < k_len[:, None])
    return torch.where(valid[:, None, None, :], s, NEG_INF), v_cache


def _decode_out(q, p, v_cache):
    B, _, H, hd = q.shape
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


def _decode_sharded(q, k_cache, v_cache, *, k_len, window, slot_pos,
                    scale):
    """``decode_attention`` on each rank's blocks of a DTensor cache, as it
    is placed: its batch split, its key/value heads split (q's heads come
    to the same split) and its slots split, where DTensor has no strategy
    for the products.  Over a split of the slots each rank scores its own
    block, the row max and sum come from an all-reduce over those ranks,
    and so does the sum of p v: the softmax of the whole row, as on one
    card, up to the order of the sum."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.sharding import flat_rank, shard_dims
    mesh = k_cache.device_mesh
    bdims, sdims = shard_dims(k_cache, 0), shard_dims(k_cache, 1)
    kdims = shard_dims(k_cache, 2)

    def pl(*dims):                 # Shard(d) on the mesh dims of each d
        out = [Replicate()] * mesh.ndim
        for d, mdims in dims:
            for i in mdims:
                out[i] = Shard(d)
        return tuple(out)

    def whole(t):
        return t if isinstance(t, DTensor) else DTensor.from_local(
            t, mesh, (Replicate(),) * mesh.ndim, run_check=False)

    def local(ql, kl, vl, lens, sp):
        S = kl.shape[1]
        s0 = flat_rank(mesh, sdims) * S
        if sp is not None:
            sp = sp[:, s0:s0 + S]
        s, v = _decode_scores(ql, kl, vl, lens, window, sp, scale, s0)
        m = s.amax(-1, keepdim=True)
        for i in sdims:
            m = funcol.all_reduce(m, "max", (mesh, i))
        p = torch.exp(s - m)
        den = p.sum(-1, keepdim=True)
        for i in sdims:
            den = funcol.all_reduce(den, "sum", (mesh, i))
        o = torch.einsum("bkgs,bskd->bkgd", (p / den).to(vl.dtype).float(),
                         vl.float())
        for i in sdims:
            o = funcol.all_reduce(o, "sum", (mesh, i))
        B, _, H, hd = ql.shape
        return o.reshape(B, 1, H, vl.shape[-1]).to(ql.dtype)

    cache_pl = tuple(k_cache.placements)
    head_pl = pl((0, bdims), (2, kdims))
    rows_pl = pl((0, bdims))
    args = [whole(q), k_cache, v_cache, whole(k_len)]
    in_pl = [head_pl, cache_pl, tuple(v_cache.placements), rows_pl]
    if slot_pos is not None:
        args.append(whole(slot_pos))
        in_pl.append(rows_pl)
    else:
        args.append(None)
        in_pl.append(None)
    return local_map(local, out_placements=(head_pl,),
                     in_placements=tuple(in_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


# ---------------------------------------------------------------------------
# Dense MLPs
# ---------------------------------------------------------------------------
def mlp_defs(cfg, d_ff: Optional[int] = None):
    D, FF = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        return {"w_gate": ParamDef((D, FF), ("embed", "mlp"), init="fan_in"),
                "w_up": ParamDef((D, FF), ("embed", "mlp"), init="fan_in"),
                "w_down": ParamDef((FF, D), ("mlp", "embed"), init="fan_in")}
    return {"w_up": ParamDef((D, FF), ("embed", "mlp"), init="fan_in"),
            "w_down": ParamDef((FF, D), ("mlp", "embed"), init="fan_in")}


def _gelu(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default form


def mlp_apply(cfg, p, x):
    dt = x.dtype
    if cfg.act in ("swiglu", "geglu"):
        act = F.silu if cfg.act == "swiglu" else _gelu
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.act == "relu2":
        h = torch.relu(x @ p["w_up"]).square()
    else:
        h = _gelu(x @ p["w_up"])
    return (h @ p["w_down"]).to(dt)
