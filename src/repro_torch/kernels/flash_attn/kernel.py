"""K3: blockwise online-softmax attention for Hopper, its launcher and its
plain PyTorch version (port of ``repro/kernels/flash_attn/kernel.py`` and of
its wrapper ``ops.py::flash``).

``flash_fill`` takes q (B, S, H, hd) and k/v (B, S, Kh, hd) in the model's
layout, H a multiple of Kh (grouped-query attention), and returns
(B, S, H, hd) in q's dtype.  Any S: the kernel masks the ragged edge
itself.  A CUDA tensor goes to the CUDA kernel in ``csrc/flash_attn.cu``; a
CPU tensor goes to ``flash_attention_plain``.  Nothing falls back from one
to the other.

``p_dtype`` is the type p (the softmax numerator) is rounded to before
p v; ``None`` keeps it in f32, as the Pallas kernel does.  The row sum
always takes p in f32.  On the card each input type has one kernel: f32
keeps p in f32 (the CUDA-core kernel, the correctness path) and bf16 rounds
p to bf16 (the tensor-core kernel, the serving path, as JAX's model path
casts p to v's type); a ``p_dtype`` the kernel does not compute raises.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import aligned16

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attn.cu"
BLOCK = 64                   # the CUDA kernel's q- and k-tile rows
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30

# CUDA kernel launches since import (or since a caller reset it to 0); the
# plain version does not count.
launches = 0


def _check_inputs(q, k, v, window, k_len):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, heads, hd)")
    B, S, H, hd = q.shape
    Kh = k.shape[2]
    if tuple(k.shape) != (B, S, Kh, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B, S, Kh, hd) = ({B}, {S}, Kh, {hd})")
    if Kh < 1 or H % Kh:
        raise ValueError(f"{H} query heads are not a multiple of {Kh} "
                         f"key/value heads")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v differ in dtype: {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be at least 1, not {window}")
    if k_len is not None and int(k_len) < 0:
        raise ValueError(f"k_len must be >= 0, not {k_len}")


def flash_fill(q, k, v, *, causal: bool, window=None, k_len=None,
               scale=None, p_dtype=None):
    """Attention of q over k/v with f32 scores, running max, sum and
    accumulator.  ``causal`` keeps key <= query, ``window`` keeps
    key > query - window, ``k_len`` keeps key < k_len; ``scale`` defaults to
    1/sqrt(hd); ``p_dtype`` as in the module note.  Both the CUDA kernels
    and the plain version work in ``BLOCK``-row tiles."""
    _check_inputs(q, k, v, window, k_len)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     k_len=k_len, scale=scale,
                                     p_dtype=p_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or CPU tensors, not {q.device}")
    if (p_dtype or torch.float32) != q.dtype:
        raise ValueError(f"K3's {q.dtype} kernel rounds p to {q.dtype}; it "
                         f"does not compute p_dtype={p_dtype}")
    return _launch(*map(aligned16, (q, k, v)), bool(causal), window, k_len,
                   scale)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE).lib
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_fill_launch.argtypes = ([i, i] + [p] * 4 + [i] * 7
                                          + [ctypes.c_float, p])
        lib.flash_fill_launch.restype = i
        _LIB = lib
    return _LIB


def _launch(q, k, v, causal, window, k_len, scale):
    global launches
    B, S, H, hd = q.shape
    Kh = k.shape[2]
    if q.dtype not in DTYPES:
        raise ValueError(f"K3 takes {sorted(map(str, DTYPES))}, not "
                         f"{q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"K3 is instantiated for head widths {HEAD_DIMS}, "
                         f"not {hd}")
    lib = _lib()
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    kl = S if k_len is None else min(int(k_len), S)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fill_launch(
            DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, S, H, Kh, kl, int(causal),
            -1 if window is None else int(window), scale, stream)
    if err:
        raise RuntimeError(f"K3 flash_fill launch failed: CUDA error {err} "
                           f"(B={B}, S={S}, H={H}, Kh={Kh}, hd={hd}, "
                           f"{q.dtype})")
    launches += 1
    return out


def live_block(q0: int, k0: int, blk: int, causal: bool, window, k_len):
    """Whether the (q-tile at q0, k-tile at k0) pair has any unmasked
    entry under the tile-level test the kernel uses (Pallas ``_body``'s
    ``live``, plus k-tiles at or past ``k_len``)."""
    live = k0 < k_len
    if causal:
        live = live and k0 <= q0 + blk - 1
    if window is not None:
        live = live and k0 + blk - 1 > q0 - window
    return live


def flash_attention_plain(q, k, v, *, causal: bool, window=None, k_len=None,
                          scale=None, blk: int = BLOCK, p_dtype=None):
    """Plain PyTorch version of ``flash_fill``: the blockwise loop of the
    JAX model path (``layers.py::_flash_fwd``) over ``blk``-row tiles,
    skipping the tiles the kernel skips, with f32 scores, max, sum and
    accumulator.  ``p`` is summed in f32, then rounded to ``p_dtype``
    before p v (``None``: kept in f32, as the Pallas kernel keeps it).
    Keys are zero-padded to whole tiles, as the kernels load them and the
    model path pads them: a row with no live key in a visited tile then
    counts the tile's padded keys too (p = 1 each, as for every key)."""
    _check_inputs(q, k, v, window, k_len)
    B, S, H, hd = q.shape
    Kh = k.shape[2]
    G = H // Kh
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    kl = S if k_len is None else min(int(k_len), S)
    dev = q.device
    qf = q.float().reshape(B, S, Kh, G, hd)
    pad = (0, 0, 0, 0, 0, (-S) % blk)
    kf, vf = (torch.nn.functional.pad(t.float(), pad) for t in (k, v))
    out = torch.zeros((B, S, Kh, G, hd), dtype=torch.float32, device=dev)
    for q0 in range(0, S, blk):
        q1 = min(q0 + blk, S)
        qb = qf[:, q0:q1]
        m = torch.full((B, q1 - q0, Kh, G), NEG_INF, device=dev)
        l = torch.zeros((B, q1 - q0, Kh, G), device=dev)
        acc = torch.zeros((B, q1 - q0, Kh, G, hd), device=dev)
        qpos = torch.arange(q0, q1, device=dev)[:, None]
        for k0 in range(0, S, blk):
            if not live_block(q0, k0, blk, causal, window, kl):
                continue
            k1 = k0 + blk
            s = torch.einsum("bqkgd,bskd->bqkgs", qb, kf[:, k0:k1]) * scale
            kpos = torch.arange(k0, k1, device=dev)[None, :]
            mask = kpos < kl
            if causal:
                mask = mask & (kpos <= qpos)
            if window is not None:
                mask = mask & (kpos > qpos - window)
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            if p_dtype is not None:
                p = p.to(p_dtype).float()
            acc = acc * alpha[..., None] + torch.einsum(
                "bqkgs,bskd->bqkgd", p, vf[:, k0:k1])
            m = m_new
        out[:, q0:q1] = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, S, H, hd).to(q.dtype)
