"""K3 of the PyTorch port: its plain version against the JAX package's
Pallas flash kernel (interpret mode) and its oracle
``repro.kernels.flash_attn.ref.run``, over the shape and mask sweep of
``tests/test_flash_pallas_kernel.py`` (rtol/atol 2e-5, the tolerance of
those tests); ragged lengths, rows without a live key and p rounded to
bf16 against the JAX model path ``repro.models.layers.flash_attention``;
and, on a GPU only, the CUDA kernels against their plain version.

The JAX package is imported inside the CPU tests only, so that
``pytest -m gpu`` runs this file on a GPU machine without JAX."""
from __future__ import annotations

import itertools

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


def _bf16_close(got, want, pv=None):
    """Within the f32 tolerance plus one bf16 ulp of the output: two f32
    results within 2e-5 can round to bf16 values one ulp apart (and an
    output that cancels to near 0 has an ulp far below 2e-5).

    With p in bf16 and scores whose sums ran in another order, an f32 p
    that lies next to a bf16 rounding boundary can round to the neighbour
    (one bf16 ulp, at most 2^-7 p), and that moves the output by far more
    than 2e-5; ``pv`` (the attention of |v|: sum_j p_j |v_j| / l, per
    output) then adds that bound, one ulp of every p carried through p v.
    Scores that are exact in f32 (integer q and k) round p alike on both
    sides and need no ``pv``."""
    big = np.maximum(np.maximum(abs(got), abs(want)),
                     np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(big)) - 7)
    tol = 2e-5 + 2e-5 * abs(want) + ulp
    if pv is not None:
        tol = tol + 2.0 ** -7 * pv
    return np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("S,window,kind", [(77, None, "normal"),
                                           (100, 24, "normal"),
                                           (128, None, "normal"),
                                           (300, None, "exact"),
                                           (513, 64, "exact")])
def test_plain_p_bf16_matches_model_path(S, window, kind, rng):
    """bf16 in and out with p rounded to bf16 before p v, as the model
    path casts it: within 2e-5 plus one bf16 ulp of JAX's
    ``flash_attention`` over 64-row tiles, causal, with a window and
    ragged S.  "exact" draws integer q and k, so every score is exact in
    f32 whatever the sum order."""
    import jax.numpy as jnp
    from repro.models.layers import flash_attention
    q, k, v = _qkv(rng, 2, S, 4, 2, 32)
    if kind == "exact":
        q, k = (np.round(t * 1.5).clip(-3, 3) for t in (q, k))
    q, k, v = (torch.as_tensor(t).bfloat16() for t in (q, k, v))
    got = K3.flash_attention_plain(q, k, v, causal=True, window=window,
                                   p_dtype=torch.bfloat16)
    jx = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)]
    want = flash_attention(*jx, causal=True, window=window, chunk=64)
    assert _bf16_close(got.float().numpy(),
                       np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("p_dtype", [None, torch.bfloat16])
def test_p_rounding_under_another_sum_order(p_dtype, rng):
    """Why ``_bf16_close`` takes ``pv``: the same scores summed in another
    order (the head dimension of q and k permuted alike) stay within 2e-5
    plus one bf16 ulp with p in f32, while with p rounded to bf16 a p next
    to a rounding boundary rounds the other way and some outputs leave
    that bound; all stay within one bf16 ulp of each p."""
    q, k, v = (torch.as_tensor(t).bfloat16() for t in _qkv(rng, 1, 512, 4,
                                                          4, 128))
    perm = torch.as_tensor(rng.permutation(128))
    a, b = (K3.flash_attention_plain(qq, kk, v, causal=True,
                                     p_dtype=p_dtype).float().numpy()
            for qq, kk in ((q, k), (q[..., perm], k[..., perm])))
    pv = K3.flash_attention_plain(q.float(), k.float(), v.abs().float(),
                                  causal=True).numpy()
    assert _bf16_close(a, b, pv)
    assert _bf16_close(a, b) == (p_dtype is None)


def test_plain_p_dtype_none_keeps_p_in_f32(rng):
    """``p_dtype=None`` is the plain version as before (p in f32, as the
    Pallas kernel keeps it, which the tests above hold): the same bits as
    ``p_dtype=float32``, and not those of p rounded to bf16."""
    q, k, v = (torch.as_tensor(t).bfloat16() for t in _qkv(rng, 1, 96, 4,
                                                          2, 32))
    base = K3.flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(base, K3.flash_attention_plain(
        q, k, v, causal=True, p_dtype=torch.float32))
    assert not torch.equal(base, K3.flash_attention_plain(
        q, k, v, causal=True, p_dtype=torch.bfloat16))


def test_plain_rows_without_live_keys_match_model_path(rng):
    """Rows whose keys are all masked (window 16 and k_len 70: rows 85-99)
    see p = 1 on every key of each visited tile, the tile's padded keys
    included, as in the kernels and the model path, which pads S = 100 to
    128 keys.  The plain version once summed only the S - k0 real keys of
    the last tile there, and differed from the model path by 0.049."""
    import jax.numpy as jnp
    from repro.models.layers import flash_attention
    q, k, v = _qkv(rng, 1, 100, 4, 2, 16)
    got = _port(q, k, v, causal=True, window=16, k_len=70)
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=16, k_len=70, chunk=64)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


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
    """K3 on the card against its plain version on the same card, over
    G 1 and 4, S in {1, 63, 64, 65, 1000}, hd 16-128, and causal, causal
    with a window, and non-causal with k_len masks.  f32 (p in f32):
    2e-5.  bf16 (p in bf16 on both sides): one bf16 ulp more, on integer
    q and k (exact scores); on normal q and k also one ulp of each p
    (``_bf16_close``'s ``pv``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3 is CUDA C++ with no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(3)
    kinds = ("normal",) if dtype == torch.float32 else ("exact", "normal")
    for S in (1, 63, 64, 65, 1000):
        masks = [(True, None, None), (True, 16, None),
                 (False, None, S // 2 + 1), (True, 64, S // 3 + 1)]
        for G in (1, 4):
            for hd in K3.HEAD_DIMS:
                for (causal, window, k_len), kind in itertools.product(
                        masks, kinds):
                    q, k, v = _qkv(rng, 2, S, 4 * G, 4, hd)
                    if kind == "exact":
                        q, k = (np.round(t * 1.5).clip(-3, 3)
                                for t in (q, k))
                    q, k, v = (torch.as_tensor(t, device="cuda").to(dtype)
                               for t in (q, k, v))
                    kw = dict(causal=causal, window=window, k_len=k_len,
                              p_dtype=dtype)
                    before = K3.launches
                    got = K3.flash_fill(q, k, v, **kw)
                    assert K3.launches == before + 1
                    want = K3.flash_attention_plain(q, k, v, **kw)
                    torch.cuda.synchronize()
                    g, w = (t.float().cpu().numpy() for t in (got, want))
                    what = str((S, G, hd, causal, window, k_len, kind))
                    if dtype == torch.float32:
                        np.testing.assert_allclose(g, w, **TOL, err_msg=what)
                        continue
                    pv = None if kind == "exact" else \
                        K3.flash_attention_plain(
                            q.float(), k.float(), v.abs().float(),
                            causal=causal, window=window,
                            k_len=k_len).cpu().numpy()
                    assert _bf16_close(g, w, pv), what
