"""K3: blockwise online-softmax attention for Hopper, its launcher and its
plain PyTorch version (port of ``repro/kernels/flash_attn/kernel.py`` and of
its wrapper ``ops.py::flash``), and its backward: the CUDA kernels of
``csrc/flash_attn_bwd.cu`` with their plain version
``flash_backward_plain`` (a port of the JAX model path's custom_vjp
``layers.py::_flash_core_bwd``), joined to the forward by
``FlashAttnFunction``.

``flash_fill`` takes q (B, Sq, H, hd), k (B, Sk, Kh, hd) and v (B, Sk, Kh,
hd_v) in the model's layout, H a multiple of Kh (grouped-query attention),
and returns (B, Sq, H, hd_v) in q's dtype, as JAX's model path
``layers.py::flash_attention`` takes and returns them.  Query i sits at
position ``q_start + i`` for the causal and window masks (the last Sq of
the keys' positions when ``q_start = Sk - Sq``); keys sit at 0 .. Sk - 1.
Any Sq and Sk: the kernel masks the ragged edges itself.  A CUDA tensor
goes to the CUDA kernel in ``csrc/flash_attn.cu``, which is built for the
width pairs ``WIDTH_PAIRS`` (hd, hd_v): hd = hd_v for each of
``HEAD_DIMS``, and MLA's q/k of 192 with v of 128 (``VALUE_WIDTHS``); any
other pair raises there.  A CPU tensor goes to ``flash_attention_plain``,
which takes any widths.  Nothing falls back from
one to the other.

``p_dtype`` is the type p (the softmax numerator) is rounded to before
p v; ``None`` keeps it in f32, as the Pallas kernel does.  The row sum
always takes p in f32.  On the card each input type has one kernel: f32
keeps p in f32 (the CUDA-core kernel, the correctness path) and bf16 rounds
p to bf16 (the tensor-core kernel, the serving path, as JAX's model path
casts p to v's type); a ``p_dtype`` the kernel does not compute raises.

``return_lse=True`` also returns each row's log-sum-exp (B, Sq, H) f32,
m + log(max(l, 1e-30)) of its f32 scores, which the backward recomputes p
from.  A row whose visited tiles hold padded or masked keys counts them in
its forward sum (see ``flash_attention_plain``); the backward follows
``_flash_core_bwd`` and gives every masked key p = exp(-1e30 - lse), which
is 0 wherever the row has a live key (always, under a causal mask).

Both directions dispatch an operator of the ``repro_torch`` library
(``repro_torch::flash_fill``, ``repro_torch::flash_backward``; see
``kernels/__init__.py``), counted by ``fill_work`` and ``backward_work``
from shapes alone: 2 (hd + hd_v) FLOPs a live (query, key) pair forward
and 6 hd + 4 hd_v backward, the pairs by ``k3_pairs``.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import Work, aligned16, call, float_key, nbytes, \
    register_work

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attn.cu"
SOURCE_BWD = Path(__file__).resolve().parent / "csrc" / "flash_attn_bwd.cu"
BLOCK = 64                   # the CUDA kernel's q- and k-tile rows
HEAD_DIMS = (16, 32, 64, 128, 160, 256)
VALUE_WIDTHS = ((192, 128),)        # (hd, hd_v) pairs with hd_v != hd
WIDTH_PAIRS = tuple((d, d) for d in HEAD_DIMS) + VALUE_WIDTHS
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30

# CUDA kernel launches since import (or since a caller reset it to 0): the
# forward's, and the backward's (one per call, whatever launches it takes);
# the plain versions do not count.
launches = 0
bwd_launches = 0


def _check_inputs(q, k, v, window, k_len):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, heads, hd)")
    B, _, H, hd = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Sk, Kh, hd) or \
            tuple(v.shape[:3]) != tuple(k.shape[:3]):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B, Sk, Kh, hd) = ({B}, Sk, Kh, {hd}) and "
                         f"(B, Sk, Kh, hd_v)")
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


def _key_len(k, k_len):
    """The live key count: ``k_len`` clipped to Sk (all Sk when None)."""
    Sk = k.shape[1]
    return Sk if k_len is None else min(int(k_len), Sk)


def flash_fill(q, k, v, *, causal: bool, window=None, k_len=None,
               scale=None, p_dtype=None, return_lse: bool = False,
               q_start: int = 0):
    """Attention of q over k/v with f32 scores, running max, sum and
    accumulator.  With query i at position ``q_start + i``: ``causal``
    keeps key <= query, ``window`` keeps key > query - window, ``k_len``
    keeps key < k_len; ``scale`` defaults to 1/sqrt(hd); ``p_dtype`` and
    ``return_lse`` as in the module note (``return_lse``: returns (out,
    lse)).  Both the CUDA kernels and the plain version work in
    ``BLOCK``-row tiles."""
    _check_inputs(q, k, v, window, k_len)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    if q.device.type == "cuda":
        if (p_dtype or torch.float32) != q.dtype:
            raise ValueError(f"K3's {q.dtype} kernel rounds p to {q.dtype}; "
                             f"it does not compute p_dtype={p_dtype}")
    elif q.device.type != "cpu":
        raise ValueError(f"K3 runs on CUDA or CPU tensors, not {q.device}")
    out, lse = call(
        torch.ops.repro_torch.flash_fill, _FILL, (q, k, v), q, k, v,
        bool(causal), None if window is None else int(window),
        None if k_len is None else int(k_len), scale, p_dtype,
        bool(return_lse), int(q_start))
    return (out, lse) if return_lse else out


@torch.library.custom_op("repro_torch::flash_fill", mutates_args=())
def _fill_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: Optional[int], k_len: Optional[int],
             scale: float, p_dtype: Optional[torch.dtype], return_lse: bool,
             q_start: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_fill``'s operator: (out, lse), lse empty unless asked for."""
    raise ValueError(f"K3 runs on CUDA or CPU tensors, not {q.device}")


def _fill_cpu(q, k, v, causal, window, k_len, scale, p_dtype, return_lse,
              q_start):
    out, lse = flash_attention_plain(
        q, k, v, causal=causal, window=window, k_len=k_len, scale=scale,
        p_dtype=p_dtype, return_lse=True, q_start=q_start)
    return out, lse if return_lse else None


def _fill_cuda(q, k, v, causal, window, k_len, scale, p_dtype, return_lse,
               q_start):
    return _launch(*map(aligned16, (q, k, v)), causal, window, k_len,
                   scale, return_lse, q_start)


def _lse_or_empty(fn):
    """``fn`` (lse None unless asked for) as the operator's kernel, whose
    schema returns a tensor: an empty one for a missing lse."""
    def kernel(q, *args):
        out, lse = fn(q, *args)
        return out, lse if lse is not None else _no_lse(q)
    return kernel


_FILL = {"cpu": _fill_cpu, "cuda": _fill_cuda}
for _dev, _fn in _FILL.items():
    _fill_op.register_kernel(_dev, _lse_or_empty(_fn))


@_fill_op.register_fake
def _fill_fake(q, k, v, causal, window, k_len, scale, p_dtype, return_lse,
               q_start):
    B, Sq, H, _ = q.shape
    out = q.new_empty((B, Sq, H, v.shape[-1]))
    lse = (q.new_empty((B, Sq, H), dtype=torch.float32) if return_lse
           else _no_lse(q))
    return out, lse


def _no_lse(q):
    return q.new_empty((0,), dtype=torch.float32)


def k3_pairs(S, causal, window, k_len, Sk=None, q_start=0):
    """Unmasked (query, key) pairs of one head of K3's function, each 4 hd
    operations of work (q . k and p v, an fma counting 2); S queries at
    positions q_start .. q_start + S - 1 over Sk keys (default S)."""
    Sk = S if Sk is None else Sk
    q = np.arange(S) + q_start
    hi = np.full(S, Sk if k_len is None else min(int(k_len), Sk))
    if causal:
        hi = np.minimum(hi, q + 1)
    lo = np.zeros(S, np.int64) if window is None else np.maximum(
        q - int(window) + 1, 0)
    return int(np.maximum(hi - lo, 0).sum())


def fill_work(q, k, v, causal, window, k_len, scale, p_dtype, return_lse,
              q_start) -> Work:
    """K3 forward: 2 (hd + hd_v) FLOPs a live (query, key) pair of each
    head, at q's peak class; q, k, v read and the output (and lse) written
    once.  ``k_len`` is a static key count here (the model path passes
    none), so the count is exact; a caller masking keys by a tensor would
    pass its bound, and the count would be an upper bound."""
    B, Sq, H, hd = q.shape
    Sk, hd_v = k.shape[1], v.shape[-1]
    pairs = k3_pairs(Sq, causal, window, k_len, Sk, q_start)
    out = B * Sq * H * hd_v * q.element_size()
    lse = 4 * B * Sq * H if return_lse else 0
    return Work({float_key(q.dtype): 2 * (hd + hd_v) * pairs * B * H},
                nbytes(q, k, v) + out + lse)


register_work(_fill_op, fill_work)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE).lib
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_fill_launch.argtypes = ([i, i, i] + [p] * 5 + [i] * 9
                                          + [ctypes.c_float, p])
        lib.flash_fill_launch.restype = i
        _LIB = lib
    return _LIB


def _check_kernel_args(q, v):
    if q.dtype not in DTYPES:
        raise ValueError(f"K3 takes {sorted(map(str, DTYPES))}, not "
                         f"{q.dtype}")
    pair = (q.shape[-1], v.shape[-1])
    if pair not in WIDTH_PAIRS:
        raise ValueError(f"K3's CUDA kernels are instantiated for the (hd, "
                         f"hd_v) pairs {WIDTH_PAIRS}, not {pair}")


def _launch(q, k, v, causal, window, k_len, scale, with_lse, q_start):
    global launches
    B, Sq, H, hd = q.shape
    Sk, Kh, hd_v = k.shape[1], k.shape[2], v.shape[3]
    _check_kernel_args(q, v)
    lib = _lib()
    out = q.new_empty((B, Sq, H, hd_v))
    lse = (torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fill_launch(
            DTYPES[q.dtype], hd, hd_v, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, B, Sq, Sk,
            q_start, H, Kh, _key_len(k, k_len), int(causal),
            -1 if window is None else int(window), scale, stream)
    if err:
        raise RuntimeError(f"K3 flash_fill launch failed: CUDA error {err} "
                           f"(B={B}, Sq={Sq}, Sk={Sk}, H={H}, Kh={Kh}, "
                           f"hd={hd}, hd_v={hd_v}, {q.dtype})")
    launches += 1
    return out, lse


def live_block(q0: int, k0: int, blk: int, causal: bool, window, k_len):
    """Whether the (q-tile whose first query sits at position q0, k-tile at
    k0) pair has any unmasked entry under the tile-level test the kernel
    uses (Pallas ``_body``'s ``live`` and JAX's ``_block_pairs``, plus
    k-tiles at or past ``k_len``)."""
    live = k0 < k_len
    if causal:
        live = live and k0 <= q0 + blk - 1
    if window is not None:
        live = live and k0 + blk - 1 > q0 - window
    return live


def _mask(q0, q1, k0, blk, causal, window, k_len, dev):
    """(q1 - q0, blk) mask of the queries at positions q0 .. q1 - 1 over
    the keys k0 .. k0 + blk - 1."""
    qpos = torch.arange(q0, q1, device=dev)[:, None]
    kpos = torch.arange(k0, k0 + blk, device=dev)[None, :]
    mask = kpos < k_len
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_plain(q, k, v, *, causal: bool, window=None, k_len=None,
                          scale=None, blk: int = BLOCK, p_dtype=None,
                          return_lse: bool = False, q_start: int = 0):
    """Plain PyTorch version of ``flash_fill``: the blockwise loop of the
    JAX model path (``layers.py::_flash_fwd``) over ``blk``-row tiles,
    skipping the tiles the kernel skips, with f32 scores, max, sum and
    accumulator.  ``p`` is summed in f32, then rounded to ``p_dtype``
    before p v (``None``: kept in f32, as the Pallas kernel keeps it).
    Keys are zero-padded to whole tiles, as the kernels load them and the
    model path pads them: a row with no live key in a visited tile then
    counts the tile's padded keys too (p = 1 each, as for every key).
    ``return_lse``: also each row's m + log(max(l, 1e-30)), (B, Sq, H)
    f32."""
    _check_inputs(q, k, v, window, k_len)
    B, Sq, H, hd = q.shape
    Sk, Kh, hd_v = k.shape[1], k.shape[2], v.shape[3]
    G = H // Kh
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    kl = _key_len(k, k_len)
    dev = q.device
    qf = q.float().reshape(B, Sq, Kh, G, hd)
    pad = (0, 0, 0, 0, 0, (-Sk) % blk)
    kf, vf = (torch.nn.functional.pad(t.float(), pad) for t in (k, v))
    out = torch.zeros((B, Sq, Kh, G, hd_v), dtype=torch.float32, device=dev)
    lse = torch.zeros((B, Sq, Kh, G), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, blk):
        q1 = min(q0 + blk, Sq)
        qb = qf[:, q0:q1]
        m = torch.full((B, q1 - q0, Kh, G), NEG_INF, device=dev)
        l = torch.zeros((B, q1 - q0, Kh, G), device=dev)
        acc = torch.zeros((B, q1 - q0, Kh, G, hd_v), device=dev)
        for k0 in range(0, Sk, blk):
            if not live_block(q_start + q0, k0, blk, causal, window, kl):
                continue
            k1 = k0 + blk
            s = torch.einsum("bqkgd,bskd->bqkgs", qb, kf[:, k0:k1]) * scale
            mask = _mask(q_start + q0, q_start + q1, k0, blk, causal,
                         window, kl, dev)
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
    out = out.reshape(B, Sq, H, hd_v).to(q.dtype)
    return (out, lse.reshape(B, Sq, H)) if return_lse else out


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------
def flash_backward(q, k, v, o, lse, do, *, causal: bool, window=None,
                   k_len=None, scale=None, q_start: int = 0):
    """(dq, dk, dv) of ``flash_fill``'s output ``o`` = attention(q, k, v),
    given its ``lse`` and the output's gradient ``do``, in the inputs'
    dtype: p recomputed in f32 from lse, every product accumulated in f32.
    Shapes and masks as ``flash_fill``: o and do (B, Sq, H, hd_v), lse
    (B, Sq, H).  A CUDA tensor goes to the kernels of
    ``csrc/flash_attn_bwd.cu`` (three to seven launches, by the widths;
    ``bwd_launches`` counts the call once): f32 inputs to the CUDA-core kernels, every
    product in f32; bf16 inputs to the tensor-core kernels, which multiply
    p and ds as two bf16 halves each (hi + lo, within about 2^-17 of the
    f32 product).  A CPU tensor goes to ``flash_backward_plain``.  Nothing
    falls back."""
    _check_inputs(q, k, v, window, k_len)
    B, Sq, H, hd = q.shape
    o_shape = (B, Sq, H, v.shape[-1])
    for name, t, shape in (("o", o, o_shape), ("do", do, o_shape),
                           ("lse", lse, (B, Sq, H))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} is {tuple(t.shape)}, want "
                             f"{tuple(shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K3 runs on CUDA or CPU tensors, not {q.device}")
    return call(torch.ops.repro_torch.flash_backward, _BWD,
                (q, k, v, o, lse, do), q, k, v, o, lse, do, bool(causal),
                None if window is None else int(window),
                None if k_len is None else int(k_len), scale, int(q_start))


@torch.library.custom_op("repro_torch::flash_backward", mutates_args=())
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
            causal: bool, window: Optional[int], k_len: Optional[int],
            scale: float, q_start: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flash_backward``'s operator: (dq, dk, dv)."""
    raise ValueError(f"K3 runs on CUDA or CPU tensors, not {q.device}")


@_bwd_op.register_kernel("cpu")
def _bwd_cpu(q, k, v, o, lse, do, causal, window, k_len, scale, q_start):
    return flash_backward_plain(q, k, v, o, lse, do, causal=causal,
                                window=window, k_len=k_len, scale=scale,
                                q_start=q_start)


@_bwd_op.register_kernel("cuda")
def _bwd_cuda(q, k, v, o, lse, do, causal, window, k_len, scale, q_start):
    return _launch_bwd(*map(aligned16, (q, k, v, o.to(q.dtype),
                                        lse.float(), do.to(q.dtype))),
                       causal, window, k_len, scale, q_start)


@_bwd_op.register_fake
def _bwd_fake(q, k, v, o, lse, do, causal, window, k_len, scale, q_start):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


_BWD = {"cpu": _bwd_cpu, "cuda": _bwd_cuda}


def backward_work(q, k, v, o, lse, do, causal, window, k_len, scale,
                  q_start) -> Work:
    """K3 backward: 6 hd + 4 hd_v FLOPs a live pair of each head (s, dk, dq
    over hd; dp, dv over hd_v), at q's peak class; q, k, v, o, do and lse
    read and dq, dk, dv written once."""
    B, Sq, H, hd = q.shape
    Sk, Kh, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    pairs = k3_pairs(Sq, causal, window, k_len, Sk, q_start)
    e = q.element_size()
    return Work({float_key(q.dtype): (6 * hd + 4 * hd_v) * pairs * B * H},
                e * (2 * B * Sq * H * (hd + hd_v)
                     + 2 * B * Sk * Kh * (hd + hd_v)) + 4 * B * Sq * H)


register_work(_bwd_op, backward_work)


_LIB_BWD = None


def _lib_bwd():
    global _LIB_BWD
    if _LIB_BWD is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE_BWD).lib
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_bwd_launch.argtypes = ([i, i, i] + [p] * 10 + [i] * 9
                                         + [ctypes.c_float, p])
        lib.flash_bwd_launch.restype = i
        _LIB_BWD = lib
    return _LIB_BWD


def _launch_bwd(q, k, v, o, lse, do, causal, window, k_len, scale, q_start):
    global bwd_launches
    B, Sq, H, hd = q.shape
    Sk, Kh, hd_v = k.shape[1], k.shape[2], v.shape[3]
    _check_kernel_args(q, v)
    lib = _lib_bwd()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_bwd_launch(
            DTYPES[q.dtype], hd, hd_v, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            B, Sq, Sk,
            q_start, H, Kh, _key_len(k, k_len), int(causal),
            -1 if window is None else int(window), scale, stream)
    if err:
        raise RuntimeError(f"K3 backward launch failed: CUDA error {err} "
                           f"(B={B}, Sq={Sq}, Sk={Sk}, H={H}, Kh={Kh}, "
                           f"hd={hd}, hd_v={hd_v}, {q.dtype})")
    bwd_launches += 1
    return dq, dk, dv


def _backward_tiles(q, k, v, o, lse, do, causal, window, k_len, scale, blk,
                    q_start):
    """The tiling ``flash_backward_plain`` walks: q, o and dO in f32 as
    (B, Sq', Kh, G, width), k and v as (B, Sk', Kh, width), rows and keys
    zero-padded to whole tiles as the kernels load them, lse as (B, Sq',
    Kh, G), and the live (q-tile, k-tile) pairs the forward visits, each
    as (q0, q1, k0, k1, p) with p = exp(s - lse) of its f32 scores (masked
    scores -1e30)."""
    _check_inputs(q, k, v, window, k_len)
    B, Sq, H, hd = q.shape
    Sk, Kh, hd_v = k.shape[1], k.shape[2], v.shape[3]
    G = H // Kh
    kl = _key_len(k, k_len)
    dev = q.device

    def padded(t, S):
        return torch.nn.functional.pad(
            t.float(), (0,) * (2 * (t.dim() - 2)) + (0, (-S) % blk))

    qf = padded(q, Sq).reshape(B, -1, Kh, G, hd)
    of, dof = (padded(t, Sq).reshape(B, -1, Kh, G, hd_v) for t in (o, do))
    kf, vf = padded(k, Sk), padded(v, Sk)
    lsef = padded(lse, Sq).reshape(B, -1, Kh, G)

    def pairs():
        for q0 in range(0, qf.shape[1], blk):
            q1 = q0 + blk
            for k0 in range(0, kf.shape[1], blk):
                if not live_block(q_start + q0, k0, blk, causal, window, kl):
                    continue
                k1 = k0 + blk
                s = torch.einsum("bqkgd,bskd->bqkgs", qf[:, q0:q1],
                                 kf[:, k0:k1]) * scale
                mask = _mask(q_start + q0, q_start + q1, k0, blk, causal,
                             window, kl, dev)
                s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
                yield q0, q1, k0, k1, torch.exp(s - lsef[:, q0:q1, ..., None])

    return (qf, kf, vf, of, dof), pairs()


def _scale(q, scale):
    return float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[3])


def flash_backward_plain(q, k, v, o, lse, do, *, causal: bool, window=None,
                         k_len=None, scale=None, blk: int = BLOCK,
                         q_start: int = 0):
    """Plain PyTorch version of ``flash_backward``: JAX's
    ``_flash_core_bwd`` over ``blk``-row tiles, visiting the (q-tile,
    k-tile) pairs the forward visits, all in f32: delta = rowsum(do * o),
    p = exp(s - lse) with masked scores -1e30, dv += p^T do,
    dp = do v^T, ds = p (dp - delta) * scale, dq += ds k, dk += ds^T q.
    Rows and keys are zero-padded to whole tiles, as the kernels load
    them."""
    scale = _scale(q, scale)
    (qf, kf, vf, of, dof), pairs = _backward_tiles(
        q, k, v, o, lse, do, causal, window, k_len, scale, blk, q_start)
    delta = (dof * of).sum(-1)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0, q1, k0, k1, p in pairs:
        qb, dob = qf[:, q0:q1], dof[:, q0:q1]
        kb, vb = kf[:, k0:k1], vf[:, k0:k1]
        dv[:, k0:k1] += torch.einsum("bqkgs,bqkgd->bskd", p, dob)
        dp = torch.einsum("bqkgd,bskd->bqkgs", dob, vb)
        ds = p * (dp - delta[:, q0:q1, ..., None]) * scale
        dq[:, q0:q1] += torch.einsum("bqkgs,bskd->bqkgd", ds, kb)
        dk[:, k0:k1] += torch.einsum("bqkgs,bqkgd->bskd", ds, qb)
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    return (dq[:, :Sq].reshape(B, Sq, H, hd).to(q.dtype),
            dk[:, :Sk].to(k.dtype), dv[:, :Sk].to(v.dtype))


F32_UNIT = 2.0 ** -24        # unit roundoff of f32


def flash_backward_floor(q, k, v, o, lse, do, *, causal: bool, window=None,
                         k_len=None, scale=None, blk: int = BLOCK,
                         q_start: int = 0):
    """The rounding noise two f32 implementations of the backward may
    differ by, entry by entry, as f32 tensors of dq's, dk's and dv's
    shapes: the floor a check of the kernel against
    ``flash_backward_plain`` adds to its relative tolerance.

    ds = p (dp - delta) scale subtracts two f32 sums of hd_v products,
    dp = sum_d dO_d v_d and delta = sum_d dO_d O_d, which are equal where a
    row has one live key (p = 1, O = v): ds is then rounding noise however
    small dq comes out.  A sum of n terms in some order carries a
    first-order error sum_k e_k S_k over its partial sums S_k, |e_k| <= u
    (u = 2^-24); with independent errors of either sign its spread is
    about u sqrt(n / 3) max |S_k| <= u sqrt(n) sum |x|.  Both sums of a row
    and both implementations (the kernel's, in its mma order, and the plain
    version's) each contribute, so

        floor(dq_i) = 2 u sqrt(hd_v) scale sum_j p_ij (A_ij + a_i) |k_j|,
        A_ij = sum_d |dO_id| |v_jd|,   a_i = sum_d |dO_id| |O_id|,

    dk the same with |q_i| over the queries, and dv, whose sum over the
    n_q = Sq G query rows of a key does not subtract two sums,
    floor(dv_j) = 2 u sqrt(n_q) sum_i p_ij |dO_i|.  The floor grows with
    the width of the sums and with the products' sizes, where a constant
    floor does not; rounding of p, of the split halves of p and ds and of
    the outer sums is relative to the gradients' own size and left to the
    check's relative term.  A check helper: nothing on the path calls
    it."""
    scale = _scale(q, scale)
    (qf, kf, vf, of, dof), pairs = _backward_tiles(
        q, k, v, o, lse, do, causal, window, k_len, scale, blk, q_start)
    qa, ka, va, doa = qf.abs(), kf.abs(), vf.abs(), dof.abs()
    a = (doa * of.abs()).sum(-1)
    fq, fk, fv = (torch.zeros_like(t) for t in (qf, kf, vf))
    for q0, q1, k0, k1, p in pairs:
        A = torch.einsum("bqkgd,bskd->bqkgs", doa[:, q0:q1], va[:, k0:k1])
        w = p * (A + a[:, q0:q1, ..., None]) * scale
        fq[:, q0:q1] += torch.einsum("bqkgs,bskd->bqkgd", w, ka[:, k0:k1])
        fk[:, k0:k1] += torch.einsum("bqkgs,bqkgd->bskd", w, qa[:, q0:q1])
        fv[:, k0:k1] += torch.einsum("bqkgs,bqkgd->bskd", p, doa[:, q0:q1])
    B, Sq, H, hd = q.shape
    Sk, hd_v = k.shape[1], v.shape[3]
    cancel = 2 * F32_UNIT * math.sqrt(hd_v)
    return (cancel * fq[:, :Sq].reshape(B, Sq, H, hd),
            cancel * fk[:, :Sk],
            2 * F32_UNIT * math.sqrt(Sq * (H // k.shape[2])) * fv[:, :Sk])


class FlashAttnFunction(torch.autograd.Function):
    """``flash_fill`` with its gradient: forward keeps q, k, v, the output
    and its lse; backward is ``flash_backward``.  On a CUDA tensor both are
    the kernels, on a CPU tensor both are the plain versions.
    ``apply(q, k, v, causal, window, k_len, scale, p_dtype[, q_start])``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, k_len, scale, p_dtype,
                q_start=0):
        out, lse = flash_fill(q, k, v, causal=causal, window=window,
                              k_len=k_len, scale=scale, p_dtype=p_dtype,
                              return_lse=True, q_start=q_start)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window, k_len=k_len,
                        scale=scale, q_start=q_start)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, do, **ctx.mask)
        return dq, dk, dv, None, None, None, None, None, None
