"""K3: blockwise online-softmax attention for Hopper, its launcher and its
plain PyTorch version (port of ``repro/kernels/flash_attn/kernel.py`` and of
its wrapper ``ops.py::flash``), and its backward: the CUDA kernels of
``csrc/flash_attn_bwd.cu`` with their plain version
``flash_backward_plain`` (a port of the JAX model path's custom_vjp
``layers.py::_flash_core_bwd``), joined to the forward by
``FlashAttnFunction``.

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

``return_lse=True`` also returns each row's log-sum-exp (B, S, H) f32,
m + log(max(l, 1e-30)) of its f32 scores, which the backward recomputes p
from.  A row whose visited tiles hold padded or masked keys counts them in
its forward sum (see ``flash_attention_plain``); the backward follows
``_flash_core_bwd`` and gives every masked key p = exp(-1e30 - lse), which
is 0 wherever the row has a live key (always, under a causal mask).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import aligned16

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attn.cu"
SOURCE_BWD = Path(__file__).resolve().parent / "csrc" / "flash_attn_bwd.cu"
BLOCK = 64                   # the CUDA kernel's q- and k-tile rows
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30

# CUDA kernel launches since import (or since a caller reset it to 0): the
# forward's, and the backward's (one per call of its three launches); the
# plain versions do not count.
launches = 0
bwd_launches = 0


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
               scale=None, p_dtype=None, return_lse: bool = False):
    """Attention of q over k/v with f32 scores, running max, sum and
    accumulator.  ``causal`` keeps key <= query, ``window`` keeps
    key > query - window, ``k_len`` keeps key < k_len; ``scale`` defaults to
    1/sqrt(hd); ``p_dtype`` and ``return_lse`` as in the module note
    (``return_lse``: returns (out, lse)).  Both the CUDA kernels and the
    plain version work in ``BLOCK``-row tiles."""
    _check_inputs(q, k, v, window, k_len)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     k_len=k_len, scale=scale,
                                     p_dtype=p_dtype, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or CPU tensors, not {q.device}")
    if (p_dtype or torch.float32) != q.dtype:
        raise ValueError(f"K3's {q.dtype} kernel rounds p to {q.dtype}; it "
                         f"does not compute p_dtype={p_dtype}")
    out, lse = _launch(*map(aligned16, (q, k, v)), bool(causal), window,
                       k_len, scale, return_lse)
    return (out, lse) if return_lse else out


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE).lib
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_fill_launch.argtypes = ([i, i] + [p] * 5 + [i] * 7
                                          + [ctypes.c_float, p])
        lib.flash_fill_launch.restype = i
        _LIB = lib
    return _LIB


def _check_kernel_args(q):
    if q.dtype not in DTYPES:
        raise ValueError(f"K3 takes {sorted(map(str, DTYPES))}, not "
                         f"{q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"K3 is instantiated for head widths {HEAD_DIMS}, "
                         f"not {q.shape[-1]}")


def _launch(q, k, v, causal, window, k_len, scale, with_lse):
    global launches
    B, S, H, hd = q.shape
    Kh = k.shape[2]
    _check_kernel_args(q)
    lib = _lib()
    out = torch.empty_like(q)
    lse = (torch.empty((B, S, H), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.numel() == 0:
        return out, lse
    kl = S if k_len is None else min(int(k_len), S)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fill_launch(
            DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr() if with_lse else None, B, S, H,
            Kh, kl, int(causal), -1 if window is None else int(window),
            scale, stream)
    if err:
        raise RuntimeError(f"K3 flash_fill launch failed: CUDA error {err} "
                           f"(B={B}, S={S}, H={H}, Kh={Kh}, hd={hd}, "
                           f"{q.dtype})")
    launches += 1
    return out, lse


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
                          scale=None, blk: int = BLOCK, p_dtype=None,
                          return_lse: bool = False):
    """Plain PyTorch version of ``flash_fill``: the blockwise loop of the
    JAX model path (``layers.py::_flash_fwd``) over ``blk``-row tiles,
    skipping the tiles the kernel skips, with f32 scores, max, sum and
    accumulator.  ``p`` is summed in f32, then rounded to ``p_dtype``
    before p v (``None``: kept in f32, as the Pallas kernel keeps it).
    Keys are zero-padded to whole tiles, as the kernels load them and the
    model path pads them: a row with no live key in a visited tile then
    counts the tile's padded keys too (p = 1 each, as for every key).
    ``return_lse``: also each row's m + log(max(l, 1e-30)), (B, S, H) f32."""
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
    lse = torch.zeros((B, S, Kh, G), dtype=torch.float32, device=dev)
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
        l = l.clamp_min(1e-30)
        out[:, q0:q1] = acc / l[..., None]
        lse[:, q0:q1] = m + torch.log(l)
    out = out.reshape(B, S, H, hd).to(q.dtype)
    return (out, lse.reshape(B, S, H)) if return_lse else out


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------
def flash_backward(q, k, v, o, lse, do, *, causal: bool, window=None,
                   k_len=None, scale=None):
    """(dq, dk, dv) of ``flash_fill``'s output ``o`` = attention(q, k, v),
    given its ``lse`` and the output's gradient ``do``, in the inputs'
    dtype: p recomputed in f32 from lse, every product accumulated in f32.
    A CUDA tensor goes to the kernels of ``csrc/flash_attn_bwd.cu`` (three
    launches; ``bwd_launches`` counts the call once): f32 inputs to the
    CUDA-core kernels, every product in f32; bf16 inputs to the
    tensor-core kernels, which multiply p and ds as two bf16 halves each
    (hi + lo, within about 2^-17 of the f32 product).  A CPU tensor goes
    to ``flash_backward_plain``.  Nothing falls back."""
    _check_inputs(q, k, v, window, k_len)
    B, S, H, hd = q.shape
    for name, t, shape in (("o", o, q.shape), ("do", do, q.shape),
                           ("lse", lse, (B, S, H))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} is {tuple(t.shape)}, want "
                             f"{tuple(shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, o, lse, do, causal=causal,
                                    window=window, k_len=k_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or CPU tensors, not {q.device}")
    return _launch_bwd(*map(aligned16, (q, k, v, o.to(q.dtype),
                                        lse.float(), do.to(q.dtype))),
                       bool(causal), window, k_len, scale)


_LIB_BWD = None


def _lib_bwd():
    global _LIB_BWD
    if _LIB_BWD is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE_BWD).lib
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_bwd_launch.argtypes = ([i, i] + [p] * 10 + [i] * 7
                                         + [ctypes.c_float, p])
        lib.flash_bwd_launch.restype = i
        _LIB_BWD = lib
    return _LIB_BWD


def _launch_bwd(q, k, v, o, lse, do, causal, window, k_len, scale):
    global bwd_launches
    B, S, H, hd = q.shape
    Kh = k.shape[2]
    _check_kernel_args(q)
    lib = _lib_bwd()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    kl = S if k_len is None else min(int(k_len), S)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_bwd_launch(
            DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), B, S, H, Kh, kl,
            int(causal), -1 if window is None else int(window), scale,
            stream)
    if err:
        raise RuntimeError(f"K3 backward launch failed: CUDA error {err} "
                           f"(B={B}, S={S}, H={H}, Kh={Kh}, hd={hd}, "
                           f"{q.dtype})")
    bwd_launches += 1
    return dq, dk, dv


def flash_backward_plain(q, k, v, o, lse, do, *, causal: bool, window=None,
                         k_len=None, scale=None, blk: int = BLOCK):
    """Plain PyTorch version of ``flash_backward``: JAX's
    ``_flash_core_bwd`` over ``blk``-row tiles, visiting the (q-tile,
    k-tile) pairs the forward visits, all in f32: delta = rowsum(do * o),
    p = exp(s - lse) with masked scores -1e30, dv += p^T do,
    dp = do v^T, ds = p (dp - delta) * scale, dq += ds k, dk += ds^T q.
    Rows and keys are zero-padded to whole tiles, as the kernels load
    them."""
    _check_inputs(q, k, v, window, k_len)
    B, S, H, hd = q.shape
    Kh = k.shape[2]
    G = H // Kh
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    kl = S if k_len is None else min(int(k_len), S)
    dev = q.device
    pad = (-S) % blk
    Sp = S + pad

    def padded(t):
        return torch.nn.functional.pad(
            t.float(), (0,) * (2 * (t.dim() - 2)) + (0, pad))

    qf, of, dof = (padded(t).reshape(B, Sp, Kh, G, hd) for t in (q, o, do))
    kf, vf = padded(k), padded(v)
    lsef = padded(lse).reshape(B, Sp, Kh, G)
    delta = (dof * of).sum(-1)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0 in range(0, Sp, blk):
        q1 = q0 + blk
        qb, dob = qf[:, q0:q1], dof[:, q0:q1]
        qpos = torch.arange(q0, q1, device=dev)[:, None]
        for k0 in range(0, Sp, blk):
            if not live_block(q0, k0, blk, causal, window, kl):
                continue
            k1 = k0 + blk
            kb, vb = kf[:, k0:k1], vf[:, k0:k1]
            s = torch.einsum("bqkgd,bskd->bqkgs", qb, kb) * scale
            kpos = torch.arange(k0, k1, device=dev)[None, :]
            mask = kpos < kl
            if causal:
                mask = mask & (kpos <= qpos)
            if window is not None:
                mask = mask & (kpos > qpos - window)
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            p = torch.exp(s - lsef[:, q0:q1, ..., None])
            dv[:, k0:k1] += torch.einsum("bqkgs,bqkgd->bskd", p, dob)
            dp = torch.einsum("bqkgd,bskd->bqkgs", dob, vb)
            ds = p * (dp - delta[:, q0:q1, ..., None]) * scale
            dq[:, q0:q1] += torch.einsum("bqkgs,bskd->bqkgd", ds, kb)
            dk[:, k0:k1] += torch.einsum("bqkgs,bqkgd->bskd", ds, qb)
    return (dq[:, :S].reshape(B, S, H, hd).to(q.dtype),
            dk[:, :S].to(k.dtype), dv[:, :S].to(v.dtype))


class FlashAttnFunction(torch.autograd.Function):
    """``flash_fill`` with its gradient: forward keeps q, k, v, the output
    and its lse; backward is ``flash_backward``.  On a CUDA tensor both are
    the kernels, on a CPU tensor both are the plain versions.
    ``apply(q, k, v, causal, window, k_len, scale, p_dtype)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, k_len, scale, p_dtype):
        out, lse = flash_fill(q, k, v, causal=causal, window=window,
                              k_len=k_len, scale=scale, p_dtype=p_dtype,
                              return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window, k_len=k_len,
                        scale=scale)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, do, **ctx.mask)
        return dq, dk, dv, None, None, None, None, None
