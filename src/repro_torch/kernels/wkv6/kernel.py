"""K4: the chunked WKV6 recurrence for Hopper, its launcher and its plain
PyTorch version (port of ``repro/kernels/wkv6/kernel.py`` and of its
wrapper ``ops.py::wkv6``).

``wkv6_fill`` takes r/k/v/lw (B, S, H, hd) in the model's layout and the
bonus u (H, hd), and returns y (B, S, H, hd) f32 and the final state
(B, H, hd, hd) f32 from a zero initial state.  Any S: steps past S are
state-neutral.  A CUDA tensor goes to the CUDA kernels in
``csrc/wkv6.cu`` (three launches on the current stream: chunk increments,
the scan over chunk states, the output; ``launches`` counts the call
once); a CPU tensor goes to ``wkv6_plain``.  Nothing falls back from one
to the other.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import aligned16

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
CHUNK = 32                   # the CUDA kernel's chunk length
HEAD_DIMS = (16, 32, 64)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Calls that launched the CUDA kernels since import (or since a caller reset
# it to 0), one per call; the plain version does not count.
launches = 0


def _check_inputs(r, k, v, lw, u):
    if r.dim() != 4:
        raise ValueError("r, k, v and lw must be (B, S, H, hd)")
    B, S, H, hd = r.shape
    for name, t in (("k", k), ("v", v), ("lw", lw)):
        if tuple(t.shape) != (B, S, H, hd):
            raise ValueError(f"{name} is {tuple(t.shape)}, r is "
                             f"{(B, S, H, hd)}")
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"u is {tuple(u.shape)}, want {(H, hd)}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r, k and v differ in dtype: {r.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if any(t.device != r.device for t in (k, v, lw, u)):
        raise ValueError("r, k, v, lw and u must be on one device")


def wkv6_fill(r, k, v, lw, u, *, chunk: int = CHUNK):
    """The WKV6 recurrence over the whole sequence: returns (y, state).
    The CUDA kernel works in chunks of ``CHUNK`` steps only, and raises for
    any other ``chunk``."""
    _check_inputs(r, k, v, lw, u)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, lw, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA or CPU tensors, not {r.device}")
    if chunk != CHUNK:
        raise ValueError(f"K4's CUDA kernel works in chunks of {CHUNK}, "
                         f"not {chunk}")
    return _launch(*map(aligned16, (r, k, v, lw.float(), u.float())))


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE).lib
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wkv6_fill_launch.argtypes = [i, i] + [p] * 9 + [i] * 3 + [p]
        lib.wkv6_fill_launch.restype = i
        _LIB = lib
    return _LIB


def _launch(r, k, v, lw, u):
    global launches
    B, S, H, hd = r.shape
    if r.dtype not in DTYPES:
        raise ValueError(f"K4 takes {sorted(map(str, DTYPES))}, not "
                         f"{r.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"K4 is instantiated for head widths {HEAD_DIMS}, "
                         f"not {hd}")
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=r.device)
    nc = -(-S // CHUNK)
    y = torch.empty((B, S, H, hd), **f32)
    state = torch.empty((B, H, hd, hd), **f32)
    # scratch: each chunk's state increment, overwritten by the scan with
    # the chunk's incoming state, and each chunk's decay exp(L[C-1])
    states = torch.empty((B, H, nc, hd, hd), **f32)
    decay = torch.empty((B, H, nc, hd), **f32)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv6_fill_launch(
            DTYPES[r.dtype], hd, r.data_ptr(), k.data_ptr(), v.data_ptr(),
            lw.data_ptr(), u.data_ptr(), y.data_ptr(), state.data_ptr(),
            states.data_ptr(), decay.data_ptr(), B, S, H, stream)
    if err:
        raise RuntimeError(f"K4 wkv6_fill launch failed: CUDA error {err} "
                           f"(B={B}, S={S}, H={H}, hd={hd}, {r.dtype})")
    launches += 1
    return y, state


def wkv6_plain(r, k, v, lw, u, *, chunk: int = CHUNK):
    """Plain PyTorch version of ``wkv6_fill``: the chunk loop of the JAX
    model path (``mixers._wkv_chunk``, over all (b, h) at once), with the
    sequence zero-padded to whole chunks (k = 0, lw = 0: state-neutral)."""
    _check_inputs(r, k, v, lw, u)
    B, S, H, hd = r.shape
    dev = r.device
    pad = (-S) % chunk

    def chunks(t):   # (B, S, H, hd) -> (nc, B, H, c, hd) f32
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
        return t.reshape(B, -1, chunk, H, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = map(chunks, (r, k, v, lw))
    u = u.float()
    tri = (torch.arange(chunk, device=dev)[:, None]
           > torch.arange(chunk, device=dev)[None, :])[..., None]
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=dev)
    ys = []
    for rr, kk, vv, ll in zip(rc, kc, vc, lwc):
        L = torch.cumsum(ll, dim=-2)                      # inclusive
        Lq = L - ll                                       # exclusive
        D = Lq[..., :, None, :] - L[..., None, :, :]      # (B, H, c, c, hd)
        W = torch.where(tri, torch.exp(torch.clamp(D, max=0.0)), 0.0)
        A = (rr[..., :, None, :] * W * kk[..., None, :, :]).sum(-1)
        A = A + torch.diag_embed((rr * u[None, :, None, :] * kk).sum(-1))
        y = A @ vv
        y = y + (rr * torch.exp(Lq)) @ state
        decay = torch.exp(L[..., -1, :])
        k_scaled = kk * torch.exp(L[..., -1:, :] - L)
        state = decay[..., None] * state + k_scaled.transpose(-1, -2) @ vv
        ys.append(y)
    y = torch.stack(ys, 0).permute(1, 0, 3, 2, 4).reshape(B, -1, H, hd)
    return y[:, :S].contiguous(), state
