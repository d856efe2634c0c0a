"""Gradient compression for the data-parallel reduction (port of
``repro/train/compress.py``).

``ef_compress`` is int8 quantization with error feedback: the gradient
applied is quantize(g + residual), and the quantization error is carried to
the next step in the train state.  ``int8_psum``, the compressed collective
itself, needs devices to reduce over and waits for multi-GPU placement
(ROADMAP queue 1 item 14).
"""
from __future__ import annotations

import torch

from repro_torch.models.params import leaves, tree_map, unflatten

F32 = torch.float32


def _q(x):
    a = x.abs().amax(dim=-1, keepdim=True) if x.dim() else x.abs()
    a = a.clamp_min(1e-20)
    q = torch.round(x / a * 127.0).clamp(-127, 127).to(torch.int8)
    return q, a.to(F32)


def _dq(q, a):
    return q.to(F32) / 127.0 * a


def init_ef(params, dtype=torch.bfloat16):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                          device=p.device), params)


def ef_compress(grads, ef):
    """-> (compressed grads, new EF residuals)."""
    def one(g, e):
        gf = g.to(F32) + e.to(F32)
        gq = _dq(*_q(gf))
        return gq.to(g.dtype), (gf - gq).to(e.dtype)
    out = [one(g, e) for g, e in zip(leaves(grads), leaves(ef))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(ef, [o[1] for o in out]))


def int8_psum(x, mesh, axis: str):
    """The compressed all-reduce over a device mesh: not ported."""
    raise NotImplementedError(
        "int8_psum reduces over a device mesh; multi-GPU placement is not "
        "ported yet (ROADMAP queue 1 item 14)")
