"""Masks and helpers shared by every engine (counterpart of
``repro.core.spec_utils``)."""
from __future__ import annotations

import torch

from . import types as T


def _as_tensor(x, like=None):
    if isinstance(x, torch.Tensor):
        return x
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def resolve_tb_pack(spec: T.DPKernelSpec, tb_pack) -> int:
    """Validate/resolve a pointers-per-byte request against the kernel's
    declared pointer width (``None`` -> the spec's natural packing)."""
    pack = spec.tb_pack if tb_pack is None else int(tb_pack)
    if pack not in (1, 2, 4, 8):
        raise ValueError(f"tb_pack must be 1, 2, 4 or 8, got {pack}")
    if spec.traceback is not None and 8 // pack < spec.ptr_bits:
        raise ValueError(
            f"tb_pack={pack} leaves {8 // pack}-bit slots but kernel "
            f"{spec.name} declares ptr_bits={spec.ptr_bits}")
    return pack


def band_mask(spec: T.DPKernelSpec, i, j):
    """Fixed banding: keep cells with |i - j| <= W (all cells when unbanded)."""
    i = _as_tensor(i, j)
    j = _as_tensor(j, i)
    shape = torch.broadcast_shapes(i.shape, j.shape)
    if spec.band is None:
        return torch.ones(shape, dtype=torch.bool, device=i.device)
    return (i.to(torch.int32) - j.to(torch.int32)).abs() <= spec.band


def region_mask(spec: T.DPKernelSpec, i, j, q_len, r_len):
    """Objective-region mask: interior cells within the effective lengths
    that the region selects, inside the band."""
    i = _as_tensor(i, j)
    j = _as_tensor(j, i)
    interior = (i >= 1) & (j >= 1) & (i <= q_len) & (j <= r_len)
    if spec.region == T.REGION_CORNER:
        sel = (i == q_len) & (j == r_len)
    elif spec.region == T.REGION_ALL:
        sel = torch.ones_like(interior)
    elif spec.region == T.REGION_LAST_ROW:
        sel = i == q_len
    elif spec.region == T.REGION_LAST_ROW_COL:
        sel = (i == q_len) | (j == r_len)
    else:
        raise ValueError(f"unknown region {spec.region!r}")
    return interior & sel & band_mask(spec, i, j)


def batch_lens(x, n: int, dev):
    """Effective lengths as an (n,) int32 tensor on ``dev``: a scalar is
    broadcast, a sequence of n values kept."""
    t = torch.as_tensor(x, device=dev).to(torch.int32).reshape(-1)
    return t.expand(n).contiguous() if t.numel() == 1 else t.reshape(n)


def params_on_device(params, dev):
    """``params`` with every tensor on ``dev``, so that a PE called once per
    diagonal reads its tables without a host-to-device copy each time."""
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in params.items()}
