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

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from .params import ParamDef

P = ParamDef
F32 = torch.float32


def moe_defs(cfg):
    D, E, FF = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    d = {"router": P((D, E), ("embed", "expert"), init="fan_in", dtype=F32),
         "w_gate": P((E, D, FF), ("expert", "embed", "expert_mlp"),
                     init="fan_in"),
         "w_up": P((E, D, FF), ("expert", "embed", "expert_mlp"),
                   init="fan_in"),
         "w_down": P((E, FF, D), ("expert", "expert_mlp", "embed"),
                     init="fan_in")}
    if cfg.n_shared_experts:
        sff = FF * cfg.n_shared_experts
        d["shared"] = {"w_gate": P((D, sff), ("embed", "mlp"), init="fan_in"),
                       "w_up": P((D, sff), ("embed", "mlp"), init="fan_in"),
                       "w_down": P((sff, D), ("mlp", "embed"), init="fan_in")}
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


def _groups(cfg, x):
    """x (B, S, D) -> its tokens in groups (n, g, D), the ragged tail
    padded with zero rows (which route like any token and are sliced
    away), and the per-expert capacity."""
    B, S, D = x.shape
    T = B * S
    g = min(cfg.moe_group, T)
    pad = (-T) % g
    xt = x.reshape(T, D)
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    return xt.reshape((T + pad) // g, g, D), _capacity(cfg, g)


def _aux_loss(cfg, probs, idx):
    """Load-balance auxiliary loss (Switch/GShard form), pad rows
    included."""
    E = cfg.n_experts
    chosen = F.one_hot(idx, E).amax(dim=2).to(F32)         # (n, g, E)
    frac_tokens = chosen.mean(dim=1)                        # (n, E)
    frac_probs = probs.mean(dim=1)                          # (n, E)
    return E * (frac_tokens * frac_probs).sum(-1).mean()


def _experts(cfg, x, xt, C, gate, idx, slot, keep, w_gate, w_up, w_down,
             e_lo=0):
    """The routed experts' output (B, S, D): the products of the experts
    ``e_lo .. e_lo + len(w_gate)`` whose weights are given (all of them
    unsharded; a rank's own under expert parallelism, whose sums over the
    experts are then partial)."""
    B, S, D = x.shape
    n, g, _ = xt.shape
    E = cfg.n_experts
    # dispatch / combine (n, g, E, C): a token's K experts differ, so each
    # (expert, slot) cell is written once; a dropped choice writes 0
    cell = idx * C + torch.where(keep, slot, torch.zeros_like(slot))
    zero = torch.zeros((n, g, E * C), dtype=F32, device=x.device)
    dispatch = zero.scatter(-1, cell, keep.to(F32)).view(n, g, E, C)
    combine = zero.scatter(-1, cell, gate * keep).view(n, g, E, C)
    if w_gate.shape[0] < E:
        e_hi = e_lo + w_gate.shape[0]
        dispatch = dispatch[:, :, e_lo:e_hi]
        combine = combine[:, :, e_lo:e_hi]

    cdt = x.dtype
    xin = torch.einsum("ngec,ngd->necd", dispatch.to(cdt), xt)
    h = F.silu(torch.einsum("necd,edf->necf", xin, w_gate)) \
        * torch.einsum("necd,edf->necf", xin, w_up)
    yout = torch.einsum("necf,efd->necd", h, w_down)
    y = torch.einsum("ngec,necd->ngd", combine.to(cdt), yout)
    return y.reshape(n * g, D)[:B * S].reshape(B, S, D)


def _routed_sharded(cfg, p, x):
    """The routed experts and the aux loss of a DTensor x, each through
    ``sharding.on_shards``.  Each rank routes its own batch rows (split as
    x's batch is, when each rank's tokens are whole groups, else every row
    on every rank) against the whole router, and runs the experts it
    holds: experts split over the other mesh axes if they divide them
    (expert parallelism, the output partial over those axes), the rest of
    each expert weight gathered (FSDP).  The aux loss is the mean of the
    ranks' group means (their groups are equal in number): a partial sum
    of each rank's mean over the batch ranks.  It is a map of its own,
    whose work is not split over the expert axes, so that its gradient is
    not counted once an expert rank."""
    from repro_torch.sharding import (SUM, flat_rank, on_shards, shard_dims,
                                      split_dims)
    mesh = x.device_mesh
    bdims = shard_dims(x, 0)
    B, S, _ = x.shape
    n_b = math.prod(mesh.size(i) for i in bdims)
    if (B // n_b * S) % min(cfg.moe_group, B * S):
        bdims, n_b = [], 1
    edims = split_dims(mesh, bdims, cfg.n_experts)

    def aux_local(xl, router):
        xt, C = _groups(cfg, xl)
        probs, _, idx, _, _ = route(cfg, router, xt, C)
        return _aux_loss(cfg, probs, idx) / n_b

    def y_local(xl, router, wg, wu, wd):
        xt, C = _groups(cfg, xl)
        _, gate, idx, slot, keep = route(cfg, router, xt, C)
        return _experts(cfg, xl, xt, C, gate, idx, slot, keep, wg, wu, wd,
                        flat_rank(mesh, edims) * wg.shape[0])

    whole, w = (None, None), (None, 0)
    aux = on_shards(aux_local, mesh, bdims, [], [(0, None), whole],
                    [(SUM, None)])(x, p["router"])
    y = on_shards(y_local, mesh, bdims, edims, [(0, None), whole, w, w, w],
                  [(0, SUM)])(x, p["router"], p["w_gate"], p["w_up"],
                              p["w_down"])
    return y, aux


def moe_apply(cfg, p, x):
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, aux loss (f32 0-dim));
    a DTensor x runs the routed experts on each rank's shards
    (``_routed_sharded``)."""
    if isinstance(x, DTensor):
        y, aux = _routed_sharded(cfg, p, x)
    else:
        xt, C = _groups(cfg, x)
        probs, gate, idx, slot, keep = route(cfg, p["router"], xt, C)
        y = _experts(cfg, x, xt, C, gate, idx, slot, keep, p["w_gate"],
                     p["w_up"], p["w_down"])
        aux = _aux_loss(cfg, probs, idx)
    if cfg.n_shared_experts:
        sp = p["shared"]
        y = y + (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]
    return y, aux
