"""Mixture-of-Experts FFN, GShard-style grouped dispatch (port of
``repro/models/moe.py``).

Tokens are blocked into groups of ``cfg.moe_group`` (the ragged tail padded
with zero rows, which route like any token and are sliced away); within a
group each token picks its top-k experts and each expert takes at most
``_capacity`` choices, all first choices of the group before any second
choice, in token order.  A capacity-bounded one-hot dispatch / combine pair
of products moves tokens to experts and back.  Dispatch is dense, as in
JAX: every expert's weights are read on every call.  Router math runs in
f32.

Routers: 'softmax' (qwen3: renormalized top-k of softmax probs) and
'sigmoid' (deepseek-v3: top-k of sigmoid scores, renormalized).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .params import ParamDef

P = ParamDef
F32 = torch.float32


def moe_defs(cfg):
    D, E, FF = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    d = {"router": P((D, E), init="fan_in", dtype=F32),
         "w_gate": P((E, D, FF), init="fan_in"),
         "w_up": P((E, D, FF), init="fan_in"),
         "w_down": P((E, FF, D), init="fan_in")}
    if cfg.n_shared_experts:
        sff = FF * cfg.n_shared_experts
        d["shared"] = {"w_gate": P((D, sff), init="fan_in"),
                       "w_up": P((D, sff), init="fan_in"),
                       "w_down": P((sff, D), init="fan_in")}
    return d


def _capacity(cfg, g: int) -> int:
    c = int(g * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(c, cfg.top_k)


def route(cfg, router, xt, C: int):
    """xt: (n, g, D) token groups -> probs (n, g, E) f32, gate (n, g, K)
    renormalized, idx (n, g, K) experts in descending score, slot (n, g, K)
    each choice's place in its expert's queue, keep (n, g, K) slot < C.

    The top-k is a stable descending sort, so equal scores (the zero pad
    rows score every expert alike) take the lower expert first, as
    ``jax.lax.top_k`` does.  Slots count in int32: exact."""
    E, K = cfg.n_experts, cfg.top_k
    n, g, _ = xt.shape
    logits = torch.einsum("ngd,de->nge", xt.float(), router.float())
    if cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
        probs = scores / scores.sum(-1, keepdim=True)
    else:
        probs = torch.softmax(logits, dim=-1)
        scores = probs
    top, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    gate, idx = top[..., :K], order[..., :K]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    # capacity: priority (choice order, then token order), choice-major,
    # counted along the innermost axis of (n, E, K * g)
    oh = F.one_hot(idx, E).to(torch.int32)                 # (n, g, K, E)
    flat = oh.permute(0, 3, 2, 1).reshape(n, E, K * g)
    before = torch.cumsum(flat, -1, dtype=torch.int32) - flat  # slots before
    slot = before.reshape(n, E, K, g).permute(0, 3, 2, 1).gather(
        -1, idx[..., None])[..., 0]                         # (n, g, K)
    return probs, gate, idx, slot, slot < C


def moe_apply(cfg, p, x):
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, aux loss (f32 0-dim))."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    g = min(cfg.moe_group, T)
    pad = (-T) % g
    xt = x.reshape(T, D)
    if pad:                        # ragged tail: pad, route, slice away
        xt = F.pad(xt, (0, 0, 0, pad))
    n = (T + pad) // g
    C = _capacity(cfg, g)
    xt = xt.reshape(n, g, D)
    probs, gate, idx, slot, keep = route(cfg, p["router"], xt, C)

    # dispatch / combine (n, g, E, C): a token's K experts differ, so each
    # (expert, slot) cell is written once; a dropped choice writes 0
    cell = idx * C + torch.where(keep, slot, torch.zeros_like(slot))
    zero = torch.zeros((n, g, E * C), dtype=F32, device=x.device)
    dispatch = zero.scatter(-1, cell, keep.to(F32)).view(n, g, E, C)
    combine = zero.scatter(-1, cell, gate * keep).view(n, g, E, C)

    cdt = x.dtype
    xin = torch.einsum("ngec,ngd->necd", dispatch.to(cdt), xt)
    h = F.silu(torch.einsum("necd,edf->necf", xin, p["w_gate"])) \
        * torch.einsum("necd,edf->necf", xin, p["w_up"])
    yout = torch.einsum("necf,efd->necd", h, p["w_down"])
    y = torch.einsum("ngec,necd->ngd", combine.to(cdt), yout)
    y = y.reshape(n * g, D)[:T].reshape(B, S, D)

    if cfg.n_shared_experts:
        sp = p["shared"]
        y = y + (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]

    # load-balance auxiliary loss (Switch/GShard form), pad rows included
    chosen = F.one_hot(idx, E).amax(dim=2).to(F32)         # (n, g, E)
    frac_tokens = chosen.mean(dim=1)                        # (n, E)
    frac_probs = probs.mean(dim=1)                          # (n, E)
    aux = E * (frac_tokens * frac_probs).sum(-1).mean()
    return y, aux
