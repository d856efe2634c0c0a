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

from repro_torch.kernels.flash_attn import kernel as K3
from .params import ParamDef

F32 = torch.float32
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def norm_defs(cfg, dim: int):
    if cfg.norm == "rmsnorm":
        return {"scale": ParamDef((dim,), init="ones")}
    if cfg.norm == "layernorm":
        return {"scale": ParamDef((dim,), init="ones"),
                "bias": ParamDef((dim,), init="zeros")}
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
                    k_len=None, scale: Optional[float] = None):
    """q: (B, S, H, hd), k/v: (B, S, K, hd) with H = K * G (GQA); returns
    (B, S, H, hd) in q's dtype.  On a CUDA tensor this is one launch of K3,
    which masks the ragged edge itself; on a CPU tensor it is K3's plain
    version, over the same 64-row tiles.  p is rounded to v's dtype before
    p v on both devices, as JAX's model path casts it.  Where autograd
    records, it goes through ``K3.FlashAttnFunction`` (the forward also
    writes its lse; the backward is K3's backward kernel), as JAX's
    ``_flash_core`` is a custom_vjp; elsewhere (serving) the forward alone
    runs, with no lse."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return K3.FlashAttnFunction.apply(q, k, v, causal, window, k_len,
                                          scale, v.dtype)
    return K3.flash_fill(q, k, v, causal=causal, window=window, k_len=k_len,
                         scale=scale, p_dtype=v.dtype)


def decode_attention(q, k_cache, v_cache, *, k_len, window=None,
                     slot_pos=None, scale=None):
    """Single-position attention over a (possibly ring-buffer) KV cache.

    q: (B, 1, H, hd); k/v_cache: (B, S, K, hd); ``k_len``: (B,) tokens
    valid; ``slot_pos``: (B, S) absolute position per ring slot (window
    caches); returns (B, 1, H, hd).  Scores and the softmax are f32, ``p``
    is cast to the cache's dtype before ``p @ v`` (as in JAX), and products
    accumulate in f32.
    """
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
        valid = torch.arange(S, device=q.device)[None, :] < k_len[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Dense MLPs
# ---------------------------------------------------------------------------
def mlp_defs(cfg, d_ff: Optional[int] = None):
    D, FF = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        return {"w_gate": ParamDef((D, FF), init="fan_in"),
                "w_up": ParamDef((D, FF), init="fan_in"),
                "w_down": ParamDef((FF, D), init="fan_in")}
    return {"w_up": ParamDef((D, FF), init="fan_in"),
            "w_down": ParamDef((FF, D), init="fan_in")}


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
