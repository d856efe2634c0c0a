"""K3 of the PyTorch port: its plain version against the JAX package's
Pallas flash kernel (interpret mode) and its oracle
``repro.kernels.flash_attn.ref.run``, over the shape and mask sweep of
``tests/test_flash_pallas_kernel.py`` (rtol/atol 2e-5, the tolerance of
those tests); ragged lengths against the JAX model path
``repro.models.layers.flash_attention``; and, on a GPU only, the CUDA
kernel against its plain version.

The JAX package is imported inside the CPU tests only, so that
``pytest -m gpu`` runs this file on a GPU machine without JAX."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attn import kernel as K3

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(rng, B, S, H, K, hd):
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, K, hd)).astype(np.float32),
            rng.normal(size=(B, S, K, hd)).astype(np.float32))


def _port(q, k, v, blk=K3.BLOCK, **kw):
    """The plain K3 over ``blk``-row tiles (``flash_fill`` on a CPU tensor
    is the plain version over the kernel's ``BLOCK``-row tiles)."""
    out = K3.flash_attention_plain(*(torch.as_tensor(t) for t in (q, k, v)),
                                   blk=blk, **kw)
    return out.float().numpy()


def _oracle(q, k, v, **kw):
    """``ref.run`` on the flattened (B*H, S, hd) layout, k/v repeated per
    query head as the Pallas wrapper repeats them."""
    import jax.numpy as jnp
    from repro.kernels.flash_attn import ref as fref
    B, S, H, hd = q.shape

    def flat(t):
        t = np.repeat(t, H // t.shape[2], axis=2)
        return jnp.asarray(t.transpose(0, 2, 1, 3).reshape(B * H, S, hd))
    out = fref.run(flat(q), flat(k), flat(v), **kw)
    return np.asarray(out).reshape(B, H, S, hd).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
@pytest.mark.parametrize("B,S,H,K,hd,blk", [(2, 128, 4, 4, 32, 64),
                                            (1, 256, 4, 2, 16, 64)])
def test_plain_matches_pallas_kernel_and_oracle(causal, window, B, S, H, K,
                                                hd, blk, rng):
    import jax.numpy as jnp
    from repro.kernels.flash_attn import flash
    q, k, v = _qkv(rng, B, S, H, K, hd)
    got = _port(q, k, v, causal=causal, window=window, blk=blk)
    pallas = flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=window, blk=blk, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(
        got, _oracle(q, k, v, causal=causal, window=window), **TOL)


@pytest.mark.parametrize("k_len", [1, 50, 128])
def test_plain_key_length_mask(k_len, rng):
    """``k_len`` masks keys at and past it, as the Pallas kernel's
    ``k_len`` does (non-causal, so every row sees the same keys)."""
    import jax.numpy as jnp
    from repro.kernels.flash_attn import kernel as jk
    q, k, v = _qkv(rng, 1, 128, 2, 2, 16)
    got = _port(q, k, v, causal=False, k_len=k_len)

    def flat(t):
        return jnp.asarray(t.transpose(0, 2, 1, 3).reshape(2, 128, 16))
    pallas = jk.flash_fill(flat(q), flat(k), flat(v), causal=False, blk=64,
                           k_len=k_len, interpret=True)
    pallas = np.asarray(pallas).reshape(1, 2, 128, 16).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(
        got, _oracle(q, k, v, causal=False, k_len=k_len), **TOL)


@pytest.mark.parametrize("S,window,chunk", [(77, None, 32), (100, 24, 32),
                                            (33, None, 512)])
def test_plain_ragged_matches_model_path(S, window, chunk, rng):
    """Any S: the JAX model path pads to whole blocks and masks; the port
    masks the ragged edge itself."""
    import jax.numpy as jnp
    from repro.models.layers import flash_attention
    q, k, v = _qkv(rng, 2, S, 4, 2, 16)
    got = _port(q, k, v, causal=True, window=window, blk=chunk)
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=window, chunk=chunk)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _bf16_close(got, want):
    """Within the f32 tolerance plus one bf16 ulp of the output: two f32
    results within 2e-5 can round to bf16 values one ulp apart (and an
    output that cancels to near 0 has an ulp far below 2e-5)."""
    big = np.maximum(np.maximum(abs(got), abs(want)),
                     np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(big)) - 7)
    return np.all(np.abs(got - want) <= 2e-5 + 2e-5 * abs(want) + ulp)


def test_plain_bf16_within_one_ulp_of_pallas(rng):
    """bf16 in and out, p kept in f32 by both: the outputs differ by the
    f32 tolerance plus at most one bf16 ulp (the last rounding of values
    that differ in f32 sum order only)."""
    import jax.numpy as jnp
    from repro.kernels.flash_attn import flash
    q, k, v = (torch.as_tensor(t).bfloat16() for t in _qkv(rng, 1, 128, 4,
                                                          2, 32))
    got = K3.flash_fill(q, k, v, causal=True).float().numpy()
    jx = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)]
    want = np.asarray(flash(*jx, causal=True, blk=64, interpret=True)
                      .astype(jnp.float32))
    assert _bf16_close(got, want)


def test_plain_does_not_count_launches(rng):
    q, k, v = (torch.as_tensor(t) for t in _qkv(rng, 1, 8, 2, 1, 16))
    before = K3.launches
    K3.flash_fill(q, k, v, causal=True)
    assert K3.launches == before


@pytest.mark.parametrize("shapes", [((1, 8, 3, 16), (1, 8, 2, 16)),
                                    ((1, 8, 2, 16), (1, 9, 2, 16))])
def test_rejects_bad_shapes(shapes):
    q = torch.zeros(shapes[0])
    k = torch.zeros(shapes[1])
    with pytest.raises(ValueError):
        K3.flash_fill(q, k, k, causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(dtype):
    """K3 on the card against its plain version on the same card: 2e-5 in
    f32, and one bf16 ulp more in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3 is CUDA C++ with no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(3)
    for causal, window in [(True, None), (True, 64), (False, None)]:
        for S, H, Kh, hd in [(77, 4, 4, 64), (200, 8, 2, 128),
                             (64, 4, 1, 16), (130, 2, 2, 32)]:
            q, k, v = (torch.as_tensor(t, device="cuda").to(dtype)
                       for t in _qkv(rng, 2, S, H, Kh, hd))
            before = K3.launches
            got = K3.flash_fill(q, k, v, causal=causal, window=window)
            assert K3.launches == before + 1
            want = K3.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            torch.cuda.synchronize()
            g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
            if dtype == torch.float32:
                np.testing.assert_allclose(g, w, **TOL)
            else:
                assert _bf16_close(g, w)
