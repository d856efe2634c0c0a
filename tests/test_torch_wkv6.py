"""K4 of the PyTorch port: its plain version against the JAX package's
Pallas WKV6 kernel (interpret mode) and its per-token oracle
``repro.kernels.wkv6.ref.run`` (rtol/atol 2e-4, and 5e-4 under strong
decay: the tolerances of ``tests/test_wkv_pallas_kernel.py``), its final
state against a loop over the model's chunk math
``repro.models.mixers._wkv_chunk_bh``, its backward (``WKV6Function`` on the
CPU, autograd through the plain version) against ``jax.vjp`` through the
model path's checkpointed chunk scan, and, on a GPU only, the CUDA kernels,
forward and backward, against their plain versions.

The JAX package is imported inside the CPU tests only, so that
``pytest -m gpu`` runs this file on a GPU machine without JAX."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.wkv6 import kernel as K4


def _inputs(rng, B, S, H, hd, decay_scale=1.0):
    r = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    lw = -np.exp(rng.normal(size=(B, S, H, hd)) * decay_scale
                 ).astype(np.float32)
    u = rng.normal(size=(H, hd)).astype(np.float32)
    return r, k, v, lw, u


def _port(inputs, chunk=K4.CHUNK):
    y, state = K4.wkv6_fill(*(torch.as_tensor(t) for t in inputs),
                            chunk=chunk)
    return y.numpy(), state.numpy()


def _oracle(inputs):
    import jax.numpy as jnp
    from repro.kernels.wkv6 import ref as wref
    r, k, v, lw, u = inputs
    B, S, H, hd = r.shape

    def flat(t):
        return jnp.asarray(t.transpose(0, 2, 1, 3).reshape(B * H, S, hd))
    y = wref.run(flat(r), flat(k), flat(v), flat(lw),
                 jnp.asarray(np.broadcast_to(u[None], (B, H, hd))
                             .reshape(-1, hd)))
    return np.asarray(y).reshape(B, H, S, hd).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,S,H,hd,chunk,s_blk", [
    (2, 64, 2, 16, 16, 64),
    (1, 128, 3, 32, 32, 64),
    (2, 96, 2, 16, 16, 96),
])
def test_plain_matches_pallas_kernel_and_oracle(B, S, H, hd, chunk, s_blk,
                                                rng):
    import jax.numpy as jnp
    from repro.kernels.wkv6 import ops as wops
    inputs = _inputs(rng, B, S, H, hd)
    got, _ = _port(inputs, chunk=chunk)
    pallas = wops.wkv6(*map(jnp.asarray, inputs), chunk=chunk, s_blk=s_blk,
                       interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got, _oracle(inputs), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S", [64, 77])
def test_plain_strong_decay(S, rng):
    """Fast decays (the cumulative log-decay of a chunk reaches about
    -236 at scale 2) still match the per-token oracle."""
    inputs = _inputs(rng, 1, S, 2, 16, decay_scale=2.0)
    got, _ = _port(inputs)
    np.testing.assert_allclose(got, _oracle(inputs), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("S", [1, 31, 77, 128])
def test_plain_ragged_lengths(S, rng):
    """Any S: steps past S are state-neutral and cut from y."""
    inputs = _inputs(rng, 2, S, 2, 16)
    got, _ = _port(inputs)
    assert got.shape == (2, S, 2, 16)
    np.testing.assert_allclose(got, _oracle(inputs), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S,chunk", [(64, 16), (70, 32)])
def test_plain_state_matches_model_chunk_loop(S, chunk, rng):
    """y and the final state equal a loop over the model path's chunk math
    (``mixers._wkv_chunk_bh``), zero-padded to whole chunks as
    ``rwkv6_apply`` pads; 2e-4 as against the oracle, since XLA and torch
    sum the same f32 terms in other orders."""
    import jax.numpy as jnp
    from repro.models import mixers
    B, H, hd = 2, 2, 16
    inputs = _inputs(rng, B, S, H, hd)
    got_y, got_state = _port(inputs, chunk=chunk)
    r, k, v, lw, u = inputs
    pad = (-S) % chunk
    nc = (S + pad) // chunk

    def to_chunks(t):
        t = np.pad(t, ((0, 0), (0, pad), (0, 0), (0, 0)))
        return jnp.asarray(t.reshape(B, nc, chunk, H, hd)
                           .transpose(1, 0, 3, 2, 4))
    rc, kc, vc, lwc = map(to_chunks, (r, k, v, lw))
    st = jnp.zeros((B, H, hd, hd), jnp.float32)
    ys = []
    for i in range(nc):
        y, st = mixers._wkv_chunk_bh(rc[i], kc[i], vc[i], lwc[i],
                                     jnp.asarray(u), st)
        ys.append(y)
    want_y = np.asarray(jnp.stack(ys).transpose(1, 0, 3, 2, 4)
                        .reshape(B, -1, H, hd))[:, :S]
    np.testing.assert_allclose(got_y, want_y, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_state, np.asarray(st), rtol=2e-4,
                               atol=2e-4)


def test_plain_does_not_count_launches(rng):
    before = K4.launches
    _port(_inputs(rng, 1, 8, 1, 16))
    assert K4.launches == before


def test_rejects_bad_shapes():
    r = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        K4.wkv6_fill(r, r, r, r, torch.zeros(3, 16))
    with pytest.raises(ValueError):
        K4.wkv6_fill(r, r, torch.zeros(1, 9, 2, 16), r, torch.zeros(2, 16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(dtype):
    """K4 on the card against its plain version on the same card, y and
    the final state, rtol/atol 5e-4 (the strong-decay tolerance), over
    S in {1, 31, 32, 33, 1499} (one step, a chunk and its neighbours, many
    chunks) at decay scales 1 and 2, hd 16-64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 is CUDA C++ with no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(4)
    for scale in (1.0, 2.0):
        for B, S, H, hd in [(2, 1, 4, 64), (2, 31, 3, 16), (1, 32, 2, 32),
                            (2, 33, 4, 64), (1, 1499, 3, 64),
                            (1, 77, 2, 32), (1, 64, 3, 16)]:
            r, k, v, lw, u = (torch.as_tensor(t, device="cuda")
                              for t in _inputs(rng, B, S, H, hd, scale))
            r, k, v = (t.to(dtype) for t in (r, k, v))
            before = K4.launches
            got = K4.wkv6_fill(r, k, v, lw, u)
            assert K4.launches == before + 1
            want = K4.wkv6_plain(r, k, v, lw, u)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=5e-4, atol=5e-4)
    with pytest.raises(ValueError):     # the kernel's chunk is fixed
        K4.wkv6_fill(r, k, v, lw, u, chunk=16)


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------
def _jax_scan(r, k, v, lw, u, chunk=32):
    """(y, final state) of the JAX model path's train branch
    (``mixers.rwkv6_apply``): zero-padded chunks through
    ``jax.checkpoint``-ed ``_wkv_chunk_bh`` under ``lax.scan``."""
    import jax
    import jax.numpy as jnp
    from repro.models import mixers
    B, S, H, hd = r.shape
    pad = (-S) % chunk
    nc = (S + pad) // chunk

    def to_chunks(t):
        t = jnp.pad(t, ((0, 0), (0, pad), (0, 0), (0, 0)))
        return t.reshape(B, nc, chunk, H, hd).transpose(1, 0, 3, 2, 4)

    def step(st, inp):
        y, st = mixers._wkv_chunk_bh(*inp, u, st)
        return st, y

    state, ys = jax.lax.scan(jax.checkpoint(step),
                             jnp.zeros((B, H, hd, hd), jnp.float32),
                             tuple(map(to_chunks, (r, k, v, lw))))
    return ys.transpose(1, 0, 3, 2, 4).reshape(B, -1, H, hd)[:, :S], state


def _norm_close(got, want, tol):
    """max |got - want| within ``tol`` of the tensor's largest |entry|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("S,scale,with_state", [(1, 1.0, False),
                                                (45, 1.0, True),
                                                (77, 2.0, False),
                                                (96, 1.0, True)])
def test_backward_matches_jax_vjp(S, scale, with_state, rng):
    """dr, dk, dv, dlw and du of y (and of the final state) through
    ``WKV6Function`` on CPU tensors against ``jax.vjp`` of the model path's
    chunk scan, y within 5e-4 (the forward's strong-decay tolerance) and
    each gradient within 5e-4 of its tensor's largest entry (dlw needs a norm-scaled bound: JAX's
    jnp.minimum passes half its gradient at the adjacent entries where the
    log-difference is 0, torch's clamp all of it, and the two paths cancel
    there only up to rounding)."""
    import jax
    import jax.numpy as jnp
    inputs = _inputs(rng, 2, S, 3, 16, decay_scale=scale)
    dy = rng.normal(size=inputs[0].shape).astype(np.float32)
    dst = rng.normal(size=(2, 3, 16, 16)).astype(np.float32)
    (jy, jst), vjp = jax.vjp(_jax_scan, *map(jnp.asarray, inputs))
    want = vjp((jnp.asarray(dy), jnp.asarray(dst if with_state else
                                             np.zeros_like(dst))))
    ts = [torch.tensor(t, requires_grad=True) for t in inputs]
    y, st = K4.WKV6Function.apply(*ts)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=5e-4, atol=5e-4)
    outs, gouts = [y], [torch.as_tensor(dy)]
    if with_state:
        outs.append(st)
        gouts.append(torch.as_tensor(dst))
    got = torch.autograd.grad(outs, ts, gouts)
    for name, g, w in zip(("dr", "dk", "dv", "dlw", "du"), got, want):
        assert g.shape == w.shape, name
        assert _norm_close(g.numpy(), w, 5e-4), name


def test_backward_plain_is_autograd_of_plain(rng):
    """``wkv6_backward`` on CPU tensors is ``wkv6_backward_plain`` and
    counts no launch; a missing state gradient is zero."""
    r, k, v, lw, u = map(torch.as_tensor, _inputs(rng, 1, 40, 2, 16))
    dy = torch.randn(r.shape)
    before = K4.bwd_launches
    got = K4.wkv6_backward(r, k, v, lw, u, dy)
    assert K4.bwd_launches == before
    want = K4.wkv6_backward_plain(r, k, v, lw, u, dy,
                                  torch.zeros(1, 2, 16, 16))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)
    with pytest.raises(ValueError):
        K4.wkv6_backward(r, k, v, lw, u, dy[:, :3])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_matches_plain(dtype):
    """K4's backward kernels (through ``WKV6Function``, on the forward's
    own chunk states) against autograd through ``wkv6_plain`` on the card,
    over S in {1, 31, 32, 33, 1499} at decay scales 1 and 2, hd 16-64,
    with and without a state gradient, a second backward on the same
    graph giving the same bits: each gradient within 1e-3 of its
    tensor's largest entry (f32 sums over a chunk and a reverse scan over
    up to 47 chunks in other orders, under strong decay), and in bf16 one
    bf16 ulp more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 is CUDA C++ with no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(6)
    for scale in (1.0, 2.0):
        for B, S, H, hd in [(2, 1, 4, 64), (2, 31, 3, 16), (1, 32, 2, 32),
                            (2, 33, 4, 64), (1, 1499, 3, 64)]:
            ins = [torch.as_tensor(t, device="cuda")
                   for t in _inputs(rng, B, S, H, hd, scale)]
            ins[:3] = [t.to(dtype) for t in ins[:3]]
            dy = torch.randn((B, S, H, hd), device="cuda")
            for dst in (None, torch.randn((B, H, hd, hd), device="cuda")):
                live = [t.clone().requires_grad_() for t in ins]
                before = (K4.launches, K4.bwd_launches)
                y, st = K4.WKV6Function.apply(*live)
                outs, gouts = [y], [dy]
                if dst is not None:
                    outs.append(st)
                    gouts.append(dst)
                got = torch.autograd.grad(outs, live, gouts, retain_graph=True)
                assert (K4.launches, K4.bwd_launches) == (before[0] + 1,
                                                          before[1] + 1)
                again = torch.autograd.grad(outs, live, gouts)
                assert all(torch.equal(g, a) for g, a in zip(got, again)), \
                    ("a second call differs", S, hd, scale)
                want = K4.wkv6_backward_plain(*ins, dy, dst)
                torch.cuda.synchronize()
                for name, g, w in zip(("dr", "dk", "dv", "dlw", "du"), got,
                                      want):
                    assert g.dtype == w.dtype, name
                    g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
                    tol = 1e-3 * np.abs(w).max()
                    if g.dtype == np.float32 and dtype == torch.bfloat16 \
                            and name in ("dr", "dk", "dv"):
                        big = np.maximum(abs(g), abs(w))
                        tol = tol + np.exp2(np.floor(np.log2(
                            np.maximum(big, 1e-38))) - 7)
                    assert np.all(np.abs(g - w) <= tol), (name, S, hd,
                                                          scale)
