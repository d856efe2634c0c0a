"""DeepSeek's multi-head latent attention and multi-token prediction in the
port against the JAX package, f32, every parameter moved off its initial
value by N(0, 0.1) noise: ``mixers.mla_apply`` in train and prefill
(decompressed k and v through ``layers.flash_attention`` with q/k of width
hd + rope_dim and v of width hd; K3's plain version here) and the
absorbed-projection decode over the latent cache (``ckv``, ``krope``), on
deepseek-v3-671b's reduced config and at its full widths' ratio (q/k 192
over v 128, 2 heads); and the MTP head's logits (``lm.forward``'s
``mtp_logits``) on olmo-1b's reduced config with ``mtp=True``, whose block
is the first mixer kind with a dense FFN, and on deepseek's, whose block
is MLA with a dense FFN (``first_dense``).

Tolerances: the mixer tolerance of ``tests/test_torch_lm.py`` (1e-4; f32
sums in other orders), and its whole-model forward tolerance for the
logits (2e-4 / 1e-4)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import mixers as jmixers
from repro.models import params as jparams
from repro_torch import configs as pconfigs
from repro_torch.models import lm, mixers
from repro_torch.models.params import from_jax

MIXER_TOL = dict(rtol=1e-4, atol=1e-4)
# deepseek-v3's reduced MLA, and its full widths' head shapes (head_dim 128,
# rope_dim 64: q/k 192 over v 128) on 2 heads of a narrow model
MLA_CASES = {"reduced": {},
             "full-head-widths": dict(d_model=128, n_heads=2, n_kv_heads=2,
                                      head_dim=128, rope_dim=64, q_lora=48,
                                      kv_lora=32)}


def _cfgs(arch, **changes):
    j = dataclasses.replace(jconfigs.get(arch, reduced=True), **changes)
    p = dataclasses.replace(pconfigs.get(arch, reduced=True), **changes)
    return j, p


def _noisy(defs, seed):
    p = jparams.init_params(jax.random.PRNGKey(seed), defs, jnp.float32)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32)),
        p)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _ctx(mode, S, conv, k_len=None):
    ctx = {"mode": mode,
           "positions": conv(np.arange(S, dtype=np.int32)[None])}
    if k_len is not None:
        ctx["k_len"] = conv(k_len)
    return ctx


@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_mla_train_prefill_decode_match_jax(case, rng):
    """Train on S positions; prefill of S - 1 (its latent cache equal to
    JAX's), the cache grown by 3 zero positions, and an absorbed decode of
    the last position, equal to JAX's decode and to the train output there."""
    jc, pc = _cfgs("deepseek-v3-671b", **MLA_CASES[case])
    jp = _noisy(jmixers.mla_defs(jc), 7)
    pp = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), jp)
    B, S = 2, 37
    x = rng.normal(size=(B, S, jc.d_model)).astype(np.float32)
    want, _ = jmixers.mla_apply(jc, jp, jnp.asarray(x),
                                _ctx("train", S, jnp.asarray), None)
    got, none = mixers.mla_apply(pc, pp, torch.as_tensor(x),
                                 _ctx("train", S, torch.as_tensor), None)
    assert none is None and tuple(got.shape) == (B, S, jc.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **MIXER_TOL)

    jy, jcache = jmixers.mla_apply(jc, jp, jnp.asarray(x[:, :S - 1]),
                                   _ctx("prefill", S - 1, jnp.asarray), None)
    py, pcache = mixers.mla_apply(pc, pp, torch.as_tensor(x[:, :S - 1]),
                                  _ctx("prefill", S - 1, torch.as_tensor),
                                  None)
    np.testing.assert_allclose(_np(py), _np(jy), **MIXER_TOL)
    assert tuple(pcache["ckv"].shape) == (B, S - 1, jc.kv_lora)
    assert tuple(pcache["krope"].shape) == (B, S - 1, jc.rope_dim)
    for k in ("ckv", "krope"):
        np.testing.assert_allclose(_np(pcache[k]), _np(jcache[k]),
                                   **MIXER_TOL)
    jcache = {k: jnp.pad(v, ((0, 0), (0, 3), (0, 0)))
              for k, v in jcache.items()}
    pcache = {k: torch.nn.functional.pad(v, (0, 0, 0, 3))
              for k, v in pcache.items()}
    k_len = np.full((B,), S - 1, np.int32)
    jd, jnew = jmixers.mla_apply(jc, jp, jnp.asarray(x[:, S - 1:]),
                                 _ctx("decode", 1, jnp.asarray, k_len),
                                 jcache)
    pd, pnew = mixers.mla_apply(pc, pp, torch.as_tensor(x[:, S - 1:]),
                                _ctx("decode", 1, torch.as_tensor, k_len),
                                pcache)
    np.testing.assert_allclose(_np(pd), _np(jd), **MIXER_TOL)
    np.testing.assert_allclose(_np(pd), _np(got)[:, S - 1:], **MIXER_TOL)
    for k in ("ckv", "krope"):
        np.testing.assert_allclose(_np(pnew[k]), _np(jnew[k]), **MIXER_TOL)


def test_mla_runs_k3_at_its_widths(monkeypatch, rng):
    """Train-mode MLA hands K3 q and k of width hd + rope_dim and v of
    width hd, causal, with the scale 1/sqrt(hd + rope_dim)."""
    from repro_torch.models import layers
    _, pc = _cfgs("deepseek-v3-671b", **MLA_CASES["full-head-widths"])
    seen = []
    real = layers.K3.flash_fill

    def spy(q, k, v, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], kw))
        return real(q, k, v, **kw)
    monkeypatch.setattr(layers.K3, "flash_fill", spy)
    pp = jax.tree.map(lambda a: torch.as_tensor(np.array(a)),
                      _noisy(jmixers.mla_defs(
                          _cfgs("deepseek-v3-671b",
                                **MLA_CASES["full-head-widths"])[0]), 1))
    x = torch.as_tensor(rng.normal(size=(1, 5, pc.d_model)), dtype=torch.float32)
    with torch.no_grad():
        mixers.mla_apply(pc, pp, x, _ctx("prefill", 5, torch.as_tensor),
                         None)
    ((hq, hk, hv, kw),) = seen
    assert (hq, hk, hv) == (192, 192, 128)
    assert kw["causal"] and kw["window"] is None
    assert kw["scale"] == pytest.approx(1 / 192 ** 0.5)


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v3-671b"])
def test_mtp_logits_match_jax(arch, rng):
    """``lm.forward``'s ``mtp_logits`` (B, S - 1, V) against JAX's, weights
    carried by ``from_jax`` (which carries the ``mtp`` subtree: norm_h,
    norm_e, proj and the block), every leaf moved by N(0, 0.1)."""
    jc, pc = _cfgs(arch, mtp=True)
    jp = _noisy(jlm.param_defs(jc), 11)
    pp = from_jax(pc, jax.tree.map(np.asarray, jp), "cpu")
    assert set(pp["mtp"]) == {"norm_h", "norm_e", "proj", "block"}
    toks = rng.integers(0, jc.vocab_size, (2, 24)).astype(np.int32)
    jout = jlm.forward(jc, jp, {"tokens": jnp.asarray(toks)})
    pout = lm.forward(pc, pp, {"tokens": torch.as_tensor(toks)})
    assert tuple(pout["mtp_logits"].shape) == (2, 23, jc.vocab_size)
    for k in ("logits", "mtp_logits"):
        np.testing.assert_allclose(_np(pout[k]), _np(jout[k]), atol=2e-4,
                                   rtol=1e-4, err_msg=k)
