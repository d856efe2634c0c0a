"""Gradient compression for the data-parallel reduction (port of
``repro/train/compress.py``).

``ef_compress`` is int8 quantization with error feedback: the gradient
applied is quantize(g + residual), and the quantization error is carried to
the next step in the train state.  ``int8_psum`` is the compressed
collective itself: the sum over one mesh axis of each rank's int8-rounded
value.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

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
    """Zero residuals shaped, and on a mesh placed, as ``params``."""
    return tree_map(lambda p: torch.zeros_like(
        p, dtype=dtype, memory_format=torch.contiguous_format), params)


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
    """Compressed all-reduce of a value replicated along ``axis`` of
    ``mesh`` (a ``DeviceMesh``): each rank quantizes its value (``_q``,
    int8 with a per-row absmax scale), dequantizes it, and the results are
    summed over the ranks of ``axis`` (its sub-group), as JAX's
    ``psum(_dq(_q(x)))``.  ``x``: a tensor, or a DTensor whose local
    value is taken; the sum (f32) comes back in the same form."""
    from torch.distributed.tensor import DTensor
    local = x.to_local() if isinstance(x, DTensor) else x
    y = _dq(*_q(local.to(F32)))
    dist.all_reduce(y, group=mesh.get_group(axis))
    if isinstance(x, DTensor):
        return DTensor.from_local(y, x.device_mesh, x.placements,
                                  run_check=False)
    return y
