"""K4 of the PyTorch port: its plain version against the JAX package's
Pallas WKV6 kernel (interpret mode) and its per-token oracle
``repro.kernels.wkv6.ref.run`` (rtol/atol 2e-4, and 5e-4 under strong
decay: the tolerances of ``tests/test_wkv_pallas_kernel.py``), its final
state against a loop over the model's chunk math
``repro.models.mixers._wkv_chunk_bh``, and, on a GPU only, the CUDA kernel
against its plain version.

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
