"""AdamW as the JAX package writes it, with optional int8 block-quantized
moments (port of ``repro/optim/adamw.py``).

Not ``torch.optim.AdamW``: the moments are f32 whatever the parameter's
dtype, the bias corrections divide m and v, weight decay is added to the
update from the f32 copy of the parameter, and the result is cast back to
the parameter's dtype, as JAX's ``update`` computes it.  The quantized
variant keeps both moments as int8: the first linear with a per-row absmax
scale, the second in log space with a per-row (lo, span) pair.

JAX's ``update`` is a pure function.  Here ``update`` writes the new
parameters and moments into the tensors it is given (and replaces the
quantized moments' entries in their dicts): a full-width state holds
f32 moments of billions of parameters, and a second copy of it would not
fit the card.  Leaf by leaf, the arithmetic is JAX's, in its order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.params import leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    quantized: bool = False          # int8 moments
    clip_norm: Optional[float] = 1.0


# -- int8 block quantization (rows = leading dims) ---------------------------
_V_FLOOR = 1e-30


def _rows(x, op):
    """``x``'s per-row ``op`` ('amax' / 'amin') over the last dim, kept."""
    return getattr(x, op)(dim=-1, keepdim=True) if x.dim() else x


def _quantize(x):
    """x: f32 -> (int8, f32 per-row absmax scale)."""
    a = _rows(x.abs(), "amax")
    a = a.clamp_min(1e-20)
    q = torch.round(x / a * 127.0).clamp(-127, 127).to(torch.int8)
    return q, a.to(F32)


def _dequantize(q, a):
    return q.to(F32) / 127.0 * a


def _quantize_log(v):
    """v >= 0 -> (int8 codes, f32 (lo, span) per row packed on last dim)."""
    lv = torch.log2(v.clamp_min(_V_FLOOR))
    lo = _rows(lv, "amin")
    hi = _rows(lv, "amax")
    span = (hi - lo).clamp_min(1e-6)
    q = (torch.round((lv - lo) / span * 254.0) - 127).clamp(
        -127, 127).to(torch.int8)
    scale = torch.cat([lo, span], dim=-1) if v.dim() else \
        torch.stack([lo, span])
    return q, scale.to(F32)


def _dequantize_log(q, scale):
    if q.dim():
        lo, span = scale[..., :1], scale[..., 1:]
    else:
        lo, span = scale[0], scale[1]
    lv = (q.to(F32) + 127.0) / 254.0 * span + lo
    v = torch.exp2(lv)
    return torch.where(v <= _V_FLOOR * 2, 0.0, v)


def init_state(cfg: AdamWConfig, params):
    def one(p):
        zeros = torch.zeros(p.shape, dtype=F32, device=p.device)
        if cfg.quantized:
            qm, sm = _quantize(zeros)
            qv, sv = _quantize_log(zeros)
            return {"m_q": qm, "m_s": sm, "v_q": qv, "v_s": sv}
        return {"m": zeros, "v": torch.zeros_like(zeros)}
    device = leaves(params)[0].device
    return {"mu": tree_map(one, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _global_norm(grads):
    return torch.sqrt(sum(g.to(F32).square().sum() for g in leaves(grads)))


def _is_moments(x):
    return isinstance(x, dict) and ("m" in x or "m_q" in x)


def update(cfg: AdamWConfig, lr, params, grads, state):
    """One AdamW step; lr: an f32 scalar (schedules resolve outside).
    Updates ``params`` and ``state`` in place and returns
    (params, state, global grad norm)."""
    count = state["count"] + 1
    gn = _global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / gn.clamp_min(1e-12), max=1.0)
    cnt = count.to(F32)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32,
                                      device=cnt.device), cnt)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32,
                                      device=cnt.device), cnt)
    lr = torch.as_tensor(lr, dtype=F32)

    def one(p, g, mu):
        # JAX scales the gradient in its dtype promoted by the f32 scale
        g = g.to(F32) * scale if scale is not None else g.to(F32)
        if cfg.quantized:
            m = _dequantize(mu["m_q"], mu["m_s"])
            v = _dequantize_log(mu["v_q"], mu["v_s"])
        else:
            m, v = mu["m"], mu["v"]
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square().mul_(1 - cfg.b2))
        del g
        upd = (m / c1).div_((v / c2).sqrt_().add_(cfg.eps))
        upd.add_(p.to(F32) * cfg.weight_decay)
        p.copy_(p.to(F32).sub(upd.mul_(lr)))
        if cfg.quantized:
            mu["m_q"], mu["m_s"] = _quantize(m)
            mu["v_q"], mu["v_s"] = _quantize_log(v)

    flat_p, flat_g = leaves(params), leaves(grads)
    flat_mu = []
    _collect_moments(state["mu"], flat_mu)
    if not (len(flat_p) == len(flat_g) == len(flat_mu)):
        raise ValueError(f"{len(flat_p)} parameters, {len(flat_g)} "
                         f"gradients, {len(flat_mu)} moment entries")
    with torch.no_grad():
        for p, g, mu in zip(flat_p, flat_g, flat_mu):
            one(p, g, mu)
        state["count"] = count
    return params, state, gn


def _collect_moments(tree, out):
    """The per-parameter moment dicts of ``tree`` in ``leaves`` order."""
    if _is_moments(tree):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _collect_moments(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _collect_moments(v, out)
