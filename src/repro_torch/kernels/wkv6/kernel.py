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

Its gradient is ``wkv6_backward``: the CUDA kernels of ``csrc/wkv6_bwd.cu``
(four launches, counted once in ``bwd_launches``), which take each
chunk's incoming state from the forward's scratch, or on a CPU tensor
``wkv6_backward_plain``, ``torch.autograd.grad`` through ``wkv6_plain``.
``WKV6Function`` joins the two for autograd.

Both directions dispatch an operator of the ``repro_torch`` library
(``repro_torch::wkv6_fill``, ``repro_torch::wkv6_backward``; see
``kernels/__init__.py``), counted by ``fill_work`` and ``backward_work``
from shapes alone: ``k4_ops_per_step`` f32 operations a step and head
forward, ``k4_bwd_ops_per_chunk`` a chunk and head backward.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import Work, aligned16, call, nbytes, \
    register_work

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
SOURCE_BWD = Path(__file__).resolve().parent / "csrc" / "wkv6_bwd.cu"
CHUNK = 32                   # the CUDA kernel's chunk length
HEAD_DIMS = (16, 32, 64)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Calls that launched the CUDA kernels since import (or since a caller reset
# it to 0), one per call, forward and backward apart; the plain versions do
# not count.
launches = 0
bwd_launches = 0


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


def wkv6_fill(r, k, v, lw, u, *, chunk: int = CHUNK,
              return_states: bool = False):
    """The WKV6 recurrence over the whole sequence: returns (y, state), and
    with ``return_states`` also each chunk's incoming state (B, H, chunks,
    hd, hd) f32, which ``wkv6_backward`` takes on the card.  The CUDA
    kernel works in chunks of ``CHUNK`` steps only, and raises for any
    other ``chunk``."""
    _check_inputs(r, k, v, lw, u)
    if r.device.type == "cuda":
        if chunk != CHUNK:
            raise ValueError(f"K4's CUDA kernel works in chunks of {CHUNK}, "
                             f"not {chunk}")
    elif r.device.type != "cpu":
        raise ValueError(f"K4 runs on CUDA or CPU tensors, not {r.device}")
    out = call(torch.ops.repro_torch.wkv6_fill, _FILL, (r, k, v, lw, u),
               r, k, v, lw, u, int(chunk))
    return out if return_states else out[:2]


@torch.library.custom_op("repro_torch::wkv6_fill", mutates_args=())
def _fill_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lw: torch.Tensor, u: torch.Tensor, chunk: int
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``wkv6_fill``'s operator: (y, state, each chunk's incoming state)."""
    raise ValueError(f"K4 runs on CUDA or CPU tensors, not {r.device}")


@_fill_op.register_kernel("cpu")
def _fill_cpu(r, k, v, lw, u, chunk):
    return wkv6_plain(r, k, v, lw, u, chunk=chunk, return_states=True)


@_fill_op.register_kernel("cuda")
def _fill_cuda(r, k, v, lw, u, chunk):
    return _launch(*map(aligned16, (r, k, v, lw.float(), u.float())))


@_fill_op.register_fake
def _fill_fake(r, k, v, lw, u, chunk):
    B, S, H, hd = r.shape
    f32 = dict(dtype=torch.float32)
    return (r.new_empty((B, S, H, hd), **f32),
            r.new_empty((B, H, hd, hd), **f32),
            r.new_empty((B, H, -(-S // chunk), hd, hd), **f32))


_FILL = {"cpu": _fill_cpu, "cuda": _fill_cuda}


def k4_ops_per_step(hd):
    """f32 operations of one step of one head of the WKV6 recurrence as the
    function defines it, one step at a time (an fma counts 2, an exp 1):
    y = r . state, hd^2 fmas; the u bonus (r * u) . k, a mul and an fma per
    d, and y += bonus * v, an fma per d; the decay exp(lw), 1 per d; the
    state w * state + k v^T, a mul and an fma per entry."""
    return 5 * hd * hd + 6 * hd


def fill_work(r, k, v, lw, u, chunk) -> Work:
    """K4 forward: ``k4_ops_per_step`` f32 operations a step and head; r,
    k, v, lw (f32) and u read, y and the final state written once (the
    chunk-state scratch the backward keeps is not counted)."""
    B, S, H, hd = r.shape
    return Work({"f32": k4_ops_per_step(hd) * S * B * H},
                nbytes(r, k, v) + 4 * (2 * B * S * H * hd + H * hd
                                       + B * H * hd * hd))


register_work(_fill_op, fill_work)


def _check_kernel_args(r):
    if r.dtype not in DTYPES:
        raise ValueError(f"K4 takes {sorted(map(str, DTYPES))}, not "
                         f"{r.dtype}")
    if r.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"K4 is instantiated for head widths {HEAD_DIMS}, "
                         f"not {r.shape[-1]}")


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
    _check_kernel_args(r)
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
    return y, state, states


def wkv6_plain(r, k, v, lw, u, *, chunk: int = CHUNK,
               return_states: bool = False):
    """Plain PyTorch version of ``wkv6_fill``: the chunk loop of the JAX
    model path (``mixers._wkv_chunk``, over all (b, h) at once), with the
    sequence zero-padded to whole chunks (k = 0, lw = 0: state-neutral).
    ``return_states``: also each chunk's incoming state, (B, H, chunks,
    hd, hd), as the CUDA kernel's scratch holds them."""
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
    ys, incoming = [], []
    for rr, kk, vv, ll in zip(rc, kc, vc, lwc):
        incoming.append(state)
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
    if not return_states:
        return y[:, :S].contiguous(), state
    states = (torch.stack(incoming, 2) if incoming else
              state.new_zeros((B, H, 0, hd, hd)))
    return y[:, :S].contiguous(), state, states


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------
def wkv6_backward(r, k, v, lw, u, dy, dstate=None, *, states=None):
    """(dr, dk, dv, dlw, du) of ``wkv6_fill``'s (y, state) given dy (B, S,
    H, hd) and the final state's gradient ``dstate`` (B, H, hd, hd; None:
    zero), dr/dk/dv in r's dtype, dlw and du f32.  On a CUDA tensor the
    kernels need ``states``, the incoming state of every chunk as the
    forward's scratch holds it after a launch (``wkv6_fill(...,
    return_states=True)``'s third result); a CPU tensor goes to ``wkv6_backward_plain``."""
    _check_inputs(r, k, v, lw, u)
    if tuple(dy.shape) != tuple(r.shape):
        raise ValueError(f"dy is {tuple(dy.shape)}, r is {tuple(r.shape)}")
    if r.device.type == "cuda":
        if states is None:
            raise ValueError("K4's backward on the card takes the forward's "
                             "chunk states (states=)")
    elif r.device.type != "cpu":
        raise ValueError(f"K4 runs on CUDA or CPU tensors, not {r.device}")
    return call(torch.ops.repro_torch.wkv6_backward, _BWD,
                [t for t in (r, k, v, lw, u, dy, dstate, states)
                 if t is not None], r, k, v, lw, u, dy, dstate, states)


@torch.library.custom_op("repro_torch::wkv6_backward", mutates_args=())
def _bwd_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lw: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
            dstate: Optional[torch.Tensor], states: Optional[torch.Tensor]
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor]:
    """``wkv6_backward``'s operator: (dr, dk, dv, dlw, du)."""
    raise ValueError(f"K4 runs on CUDA or CPU tensors, not {r.device}")


_PLAIN_THREAD = None


@_bwd_op.register_kernel("cpu")
def _bwd_cpu(r, k, v, lw, u, dy, dstate, states):
    # The operator's autograd layer runs its kernels with autograd's
    # dispatch keys excluded on the calling thread, and the plain backward
    # differentiates through wkv6_plain: it runs on a thread of its own,
    # whose dispatch state is fresh.
    global _PLAIN_THREAD
    if _PLAIN_THREAD is None:
        from concurrent.futures import ThreadPoolExecutor
        _PLAIN_THREAD = ThreadPoolExecutor(1, "wkv6-plain-backward")
    return _PLAIN_THREAD.submit(wkv6_backward_plain, r, k, v, lw, u, dy,
                                dstate).result()


@_bwd_op.register_kernel("cuda")
def _bwd_cuda(r, k, v, lw, u, dy, dstate, states):
    return _launch_bwd(*map(aligned16, (r, k, v, lw.float(), u.float(),
                                        dy.float())),
                       None if dstate is None else aligned16(dstate.float()),
                       states)


@_bwd_op.register_fake
def _bwd_fake(r, k, v, lw, u, dy, dstate, states):
    f32 = dict(dtype=torch.float32)
    return (r.new_empty(r.shape), k.new_empty(k.shape), v.new_empty(v.shape),
            r.new_empty(r.shape, **f32), u.new_empty(u.shape, **f32))


_BWD = {"cpu": _bwd_cpu, "cuda": _bwd_cuda}


def k4_bwd_ops_per_chunk(hd, C=32):
    """f32 operations K4's backward needs per (chunk, head), counted from
    the work of csrc/wkv6_bwd.cu and not from what one design recomputes
    (an fma counts 2, an exp, a min or a compare 1).  Increments: the
    cumulative sum, r exp(Lq), exp(Lc), R~^T dy.  Scan: one fma per state
    entry.  Gradients: the cumulative sums, R~ and K~, dA over j <= i; per
    pair j < i and column: W once (difference, min, exp), A's two
    multiplies and add, and dr's and dk's multiply and two fmas each (16);
    A on the diagonal; per (i, d): dR~, dK~ and K~ G (an fma per n each),
    A^T dy over i' >= i and the combination (24); per column: G . S, dLc,
    du's partial and the reverse sum."""
    inc = 3 * C * hd + hd + 2 * C * hd * hd
    scan = 2 * hd * hd
    grad = (2 * C * hd + 2 * C * hd + 3 * C * hd + C * (C + 1) * hd
            + 8 * C * (C - 1) * hd + 3 * C * hd
            + C * hd * 6 * hd + hd * C * (C + 1)
            + 24 * C * hd + hd * (2 * hd + 4 * C + 2))
    return inc + scan + grad


def backward_work(r, k, v, lw, u, dy, dstate, states) -> Work:
    """K4 backward: ``k4_bwd_ops_per_chunk`` f32 operations a chunk of
    ``CHUNK`` steps and head; r, k, v, lw, dy (f32) and u read, dr, dk, dv,
    dlw (f32) and du written once."""
    B, S, H, hd = r.shape
    e = r.element_size()
    return Work({"f32": k4_bwd_ops_per_chunk(hd) * -(-S // CHUNK) * B * H},
                (6 * e + 12) * B * S * H * hd + 8 * H * hd)


register_work(_bwd_op, backward_work)


_LIB_BWD = None


def _lib_bwd():
    global _LIB_BWD
    if _LIB_BWD is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE_BWD).lib
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wkv6_bwd_launch.argtypes = [i, i] + [p] * 16 + [i] * 3 + [p]
        lib.wkv6_bwd_launch.restype = i
        _LIB_BWD = lib
    return _LIB_BWD


def _launch_bwd(r, k, v, lw, u, dy, dstate, states):
    global bwd_launches
    B, S, H, hd = r.shape
    _check_kernel_args(r)
    nc = -(-S // CHUNK)
    if tuple(states.shape) != (B, H, nc, hd, hd):
        raise ValueError(f"states is {tuple(states.shape)}, want "
                         f"{(B, H, nc, hd, hd)}")
    lib = _lib_bwd()
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dlw = torch.empty((B, S, H, hd), **f32)
    du = torch.empty((H, hd), **f32)
    if S == 0 or B == 0:
        return dr, dk, dv, dlw, du.zero_()
    gstates = torch.empty((B, H, nc, hd, hd), **f32)
    decay = torch.empty((B, H, nc, hd), **f32)
    du_part = torch.empty((B, H, nc, hd), **f32)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv6_bwd_launch(
            DTYPES[r.dtype], hd, r.data_ptr(), k.data_ptr(), v.data_ptr(),
            lw.data_ptr(), u.data_ptr(), dy.data_ptr(),
            None if dstate is None else dstate.data_ptr(),
            states.data_ptr(), gstates.data_ptr(), decay.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(),
            du.data_ptr(), du_part.data_ptr(), B, S, H, stream)
    if err:
        raise RuntimeError(f"K4 backward launch failed: CUDA error {err} "
                           f"(B={B}, S={S}, H={H}, hd={hd}, {r.dtype})")
    bwd_launches += 1
    return dr, dk, dv, dlw, du


def wkv6_backward_plain(r, k, v, lw, u, dy, dstate=None, *,
                        chunk: int = CHUNK):
    """Plain PyTorch version of ``wkv6_backward``: ``torch.autograd.grad``
    through ``wkv6_plain`` (torch's clamp passes its gradient where the
    log-difference is <= 0)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (r, k, v, lw, u)]
        y, state = wkv6_plain(*ins, chunk=chunk)
        outs, grads = [y], [dy.float()]
        if dstate is not None:
            outs.append(state)
            grads.append(dstate.float())
        got = torch.autograd.grad(outs, ins, grads, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for t, g in zip(ins, got))


class WKV6Function(torch.autograd.Function):
    """``wkv6_fill`` with its gradient.  ``apply(r, k, v, lw, u)`` returns
    (y, state); backward is ``wkv6_backward`` (the kernels on a CUDA
    tensor, keeping the forward's chunk states; the plain versions on a
    CPU tensor)."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u):
        y, state, states = wkv6_fill(r, k, v, lw, u, return_states=True)
        ctx.save_for_backward(r, k, v, lw, u, states)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dstate):
        r, k, v, lw, u, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        dr, dk, dv, dlw, du = wkv6_backward(r, k, v, lw, u, dy, dstate,
                                            states=states)
        return dr, dk, dv, dlw.to(lw.dtype), du.to(u.dtype)
