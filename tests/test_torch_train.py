"""Training on the PyTorch port against the JAX package, on the reduced
olmo-1b and rwkv6-3b in f32: the loss (with the padded-vocab mask), AdamW's
``update`` (f32 and int8 moments) on identical inputs, EF compression, the
schedules, ``LMBatcher``'s tokens, three ``make_train_step`` steps from a
state carried by ``state_from_jax``, accumulation 2 against 1, and ports
of ``tests/test_train_infra.py``'s checkpoint tests (plus a bf16 leaf that
round-trips bit for bit and a JAX-written checkpoint read by the port).

Tolerances, each stated where it is used: f32 elementwise work 1e-6; a
loss over a few steps 2e-4 relative (JAX's whole-model gradients move by
up to 1.5e-4 of a leaf's largest entry when only their attention chunk
changes, and Adam's first steps carry that into the parameters)."""
from __future__ import annotations

import dataclasses
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro import train as jtrain
from repro.data import LMBatcher as JLMBatcher
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro.optim import constant as jconstant
from repro.optim import cosine_with_warmup as jcosine
from repro.train import compress as jC
from repro.train.loss import lm_loss as jlm_loss
from repro_torch import checkpoint, configs
from repro_torch import train as train_mod
from repro_torch.data import LMBatcher
from repro_torch.launch.train import train_loop
from repro_torch.models.params import leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw, constant, \
    cosine_with_warmup
from repro_torch.train import compress as C
from repro_torch.train.loss import lm_loss

ARCHS = ["olmo-1b", "rwkv6-3b"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _cfgs(arch, **changes):
    j = jconfigs.get(arch, reduced=True)
    p = configs.get(arch, reduced=True)
    return (dataclasses.replace(j, **changes),
            dataclasses.replace(p, **changes))


def _jax_state(jc, opt, seed=0):
    return jtrain.make_state(jc, opt, jax.random.PRNGKey(seed))


def _carried(pc, opt, jstate):
    return train_mod.state_from_jax(pc, opt, jax.tree.map(np.asarray,
                                                          jstate), "cpu")


def _batch(cfg, rng, B=4, S=32):
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pad", [0, 64])
def test_lm_loss_matches_jax(pad, rng):
    """ce, z-loss and total on random logits (1e-6 relative), with and
    without vocabulary padding."""
    jc, pc = _cfgs("olmo-1b", pad_vocab_to=256 + pad if pad else None)
    logits = rng.normal(size=(2, 9, jc.vocab_eff)).astype(np.float32) * 3
    tokens = rng.integers(0, jc.vocab_size, (2, 9))
    jl, jm = jlm_loss(jc, {"logits": jnp.asarray(logits), "prefix": 0},
                      {"tokens": jnp.asarray(tokens)})
    pl, pm = lm_loss(pc, {"logits": torch.as_tensor(logits), "prefix": 0},
                     {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    for k in ("ce", "z_loss", "loss"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-6)


def test_loss_masks_padded_vocab(rng):
    """Logits in the padded vocab range must not leak probability (port of
    the JAX test)."""
    _, cfg = _cfgs("olmo-1b")
    cfg = dataclasses.replace(cfg, pad_vocab_to=cfg.vocab_size + 64)
    logits = torch.zeros((2, 8, cfg.vocab_eff))
    logits[..., cfg.vocab_size + 3] = 100.0
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 8)))
    loss, _ = lm_loss(cfg, {"logits": logits, "prefix": 0},
                      {"tokens": tokens}, z_coef=0.0)
    assert float(loss) == pytest.approx(np.log(cfg.vocab_size), rel=1e-3)


# ---------------------------------------------------------------------------
# AdamW, EF compression, schedules, data
# ---------------------------------------------------------------------------
def _param_tree(rng):
    shapes = {"a": (4, 33), "b": {"c": (7,), "d": (3, 5, 16)}}
    return jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                        shapes, is_leaf=lambda s: isinstance(s, tuple))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_update_matches_jax(quantized, clip, rng):
    """Three updates on identical parameters and gradients: parameters and
    the moments within 1e-6 relative plus 1e-6 of the leaf's largest entry
    (f32 elementwise work in JAX's order, though XLA may fuse
    b1 m + (1 - b1) g into one fma where torch rounds the product first),
    int8 codes equal, the grad norm within 1e-6."""
    opt = dict(quantized=quantized, clip_norm=clip, weight_decay=0.1)
    jopt, popt = JAdamWConfig(**opt), AdamWConfig(**opt)
    params = _param_tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    pp = jax.tree.map(torch.as_tensor, params)
    js = jadamw.init_state(jopt, jp)
    ps = adamw.init_state(popt, pp)
    for step in range(3):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            np.float32) * 10 ** step, params)
        lr = 1e-2 * (step + 1)
        jp, js, jgn = jadamw.update(jopt, jnp.float32(lr), jp,
                                    jax.tree.map(jnp.asarray, grads), js)
        pp, ps, pgn = adamw.update(popt, torch.tensor(lr), pp,
                                   jax.tree.map(torch.as_tensor, grads), ps)
        np.testing.assert_allclose(float(pgn), float(jgn), rtol=1e-6)
    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(pp)):
        close(b, a)
    jmu, pmu = js["mu"], ps["mu"]
    for key in ("a",):   # the other leaves take the same code
        if quantized:
            for n in ("m_q", "v_q"):
                np.testing.assert_array_equal(_np(pmu[key][n]),
                                              np.asarray(jmu[key][n]))
            for n in ("m_s", "v_s"):
                close(pmu[key][n], jmu[key][n])
        else:
            for n in ("m", "v"):
                close(pmu[key][n], jmu[key][n])
    assert int(ps["count"]) == int(js["count"]) == 3


def test_adamw_bf16_params_round_like_jax(rng):
    """bf16 parameters: the update runs on their f32 copy and is rounded
    back to bf16 once, bit for bit as JAX's astype."""
    params = {"w": rng.normal(size=(8, 64)).astype(np.float32)}
    grads = {"w": rng.normal(size=(8, 64)).astype(np.float32)}
    jp = {"w": jnp.asarray(params["w"]).astype(jnp.bfloat16)}
    pp = {"w": torch.as_tensor(params["w"]).bfloat16()}
    jopt, popt = JAdamWConfig(), AdamWConfig()
    jp, _, _ = jadamw.update(jopt, jnp.float32(1e-3), jp, {
        "w": jnp.asarray(grads["w"]).astype(jnp.bfloat16)},
        jadamw.init_state(jopt, jp))
    pp, _, _ = adamw.update(popt, torch.tensor(1e-3), pp, {
        "w": torch.as_tensor(grads["w"]).bfloat16()},
        adamw.init_state(popt, pp))
    np.testing.assert_array_equal(
        pp["w"].view(torch.int16).numpy(),
        np.asarray(jp["w"]).view(np.int16))


def test_ef_compress_matches_jax(rng):
    """Ten rounds of compression with error feedback: compressed grads and
    residuals (bf16) bit-equal to JAX's."""
    g = {"x": rng.normal(size=(8, 64)).astype(np.float32),
         "y": rng.normal(size=(5,)).astype(np.float32)}
    jef = jC.init_ef(jax.tree.map(jnp.asarray, g))
    pef = C.init_ef(jax.tree.map(torch.as_tensor, g))
    for _ in range(10):
        jq, jef = jC.ef_compress(jax.tree.map(jnp.asarray, g), jef)
        pq, pef = C.ef_compress(jax.tree.map(torch.as_tensor, g), pef)
        for k in g:
            np.testing.assert_array_equal(_np(pq[k]), np.asarray(jq[k]))
            np.testing.assert_array_equal(
                pef[k].view(torch.int16).numpy(),
                np.asarray(jef[k]).view(np.int16))


def test_ef_compress_error_feedback(rng):
    """Quantization error is carried, not lost (port of the JAX test)."""
    g = torch.as_tensor(rng.normal(size=(8, 64)).astype(np.float32))
    ef = torch.zeros(g.shape, dtype=torch.bfloat16)
    applied = torch.zeros_like(g)
    for _ in range(50):
        gq, ef = C.ef_compress({"g": g}, {"g": ef})
        gq, ef = gq["g"], ef["g"]
        applied = applied + gq
    total_err = float((applied - 50 * g).abs().max())
    assert total_err < 5 * float(g.abs().max()) / 127 + 0.02


def test_int8_psum_is_refused():
    with pytest.raises(NotImplementedError, match="item 14"):
        C.int8_psum(torch.zeros(3), None, "pod")


def test_schedules_match_jax():
    """cosine_with_warmup and constant at every step of a short run, 1e-6
    relative (f32 cos on both sides)."""
    for args in ((1.0, 10, 110), (3e-4, 5, 8), (2e-3, 0, 50)):
        j, p = jcosine(*args), cosine_with_warmup(*args)
        for s in range(0, args[2] + 3):
            np.testing.assert_allclose(float(p(torch.tensor(s))),
                                       float(j(s)), rtol=1e-6, atol=1e-12)
    lr = cosine_with_warmup(1.0, 10, 110)
    assert float(lr(0)) == 0.0 and abs(float(lr(10)) - 1.0) < 1e-6
    assert float(lr(110)) <= 0.11 and float(lr(5)) == pytest.approx(0.5)
    assert float(constant(0.25)(7)) == float(jconstant(0.25)(7)) == 0.25


def test_lm_batcher_tokens_equal_jax():
    """The same seed gives the same token batches as JAX's LMBatcher."""
    for vocab, batch, seq, seed in ((256, 4, 32, 0), (50304, 2, 100, 3)):
        got = iter(LMBatcher(vocab=vocab, batch=batch, seq=seq, seed=seed))
        want = iter(JLMBatcher(vocab=vocab, batch=batch, seq=seq,
                               seed=seed))
        for _ in range(3):
            g, w = next(got), next(want)
            assert set(g) == set(w) == {"tokens"}
            np.testing.assert_array_equal(g["tokens"], w["tokens"])


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_jax(arch, rng):
    """Three ``make_train_step`` steps from one state carried by
    ``state_from_jax``, on the same batches: every step's loss within 2e-4
    relative (module note), ce and z-loss likewise, the grad norm within
    1e-3 relative, lr equal."""
    jc, pc = _cfgs(arch)
    opt = dict(weight_decay=0.01)
    jopt, popt = JAdamWConfig(**opt), AdamWConfig(**opt)
    jstate = _jax_state(jc, jopt)
    pstate = _carried(pc, popt, jstate)
    jstep = jax.jit(jtrain.make_train_step(jc, jopt, jcosine(3e-3, 1, 3)))
    pstep = train_mod.make_train_step(pc, popt, cosine_with_warmup(3e-3, 1,
                                                                   3))
    for _ in range(3):
        toks = _batch(jc, rng)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        pstate, pm = pstep(pstate, {"tokens": torch.as_tensor(toks)})
        for k in ("loss", "ce", "z_loss"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=2e-4)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
        assert float(pm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(pstate["step"]) == int(jstate["step"]) == 3
    assert int(pstate["opt"]["count"]) == 3


def test_state_from_jax_carries_every_leaf():
    """Parameters, moments (f32 and int8), count, step and the bf16 EF
    residuals arrive bit for bit; a moment of the wrong shape is refused."""
    jc, pc = _cfgs("olmo-1b")
    for quantized in (False, True):
        jopt = JAdamWConfig(quantized=quantized)
        popt = AdamWConfig(quantized=quantized)
        js = jtrain.make_state(jc, jopt, jax.random.PRNGKey(1), use_ef=True)
        ps = _carried(pc, popt, js)
        want = {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_flatten_with_path(js)[0]}
        got = checkpoint.manager._paths(ps)
        assert sorted(k for k, _ in got) == sorted(want)
        for key, t in got:
            w = np.asarray(want[key])
            if t.dtype == torch.bfloat16:
                np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                              w.view(np.int16))
            else:
                np.testing.assert_array_equal(t.numpy(), w)
    tree = jax.tree.map(np.asarray, _jax_state(jc, JAdamWConfig()))
    tree["opt"]["mu"]["embed"]["table"]["m"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="moment"):
        train_mod.state_from_jax(pc, AdamWConfig(), tree, "cpu")


def test_grad_accum_equivalence(rng):
    """accum=2 over the same global batch == accum=1 (port of the JAX test:
    loss 1e-5 relative, parameters 1e-5 absolute)."""
    _, cfg1 = _cfgs("olmo-1b")
    cfg2 = dataclasses.replace(cfg1, accum_steps=2)
    opt = AdamWConfig(clip_norm=None, weight_decay=0.0)
    state1 = train_mod.make_state(cfg1, opt, torch.Generator().manual_seed(0),
                                  "cpu")
    state2 = tree_map(lambda t: t.clone(), state1)
    b = {"tokens": torch.as_tensor(_batch(cfg1, rng))}
    s1, m1 = train_mod.make_train_step(cfg1, opt, constant(1e-3))(state1, b)
    s2, m2 = train_mod.make_train_step(cfg2, opt, constant(1e-3))(state2, b)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, c in zip(leaves(s1["params"]), leaves(s2["params"])):
        np.testing.assert_allclose(_np(a), _np(c), atol=1e-5)


def test_ef_train_step_matches_jax(rng):
    """One step with EF compression from a carried state: loss within 2e-4
    relative; the new EF residuals equal JAX's up to an int8 code that a
    gradient at a rounding boundary flips: each within one quantization
    step (twice the leaf's largest residual), and at most 5 % of them
    beyond one bf16 ulp of the leaf's largest: the gradients differ from
    JAX's by up to about 1e-4 of a row's largest entry (module note), which
    flips a code with a chance of about 2 x 127 x 1e-4 = 2.5 %."""
    jc, pc = _cfgs("olmo-1b")
    jopt, popt = JAdamWConfig(), AdamWConfig()
    js = jtrain.make_state(jc, jopt, jax.random.PRNGKey(0), use_ef=True)
    ps = _carried(pc, popt, js)
    toks = _batch(jc, rng)
    js, jm = jax.jit(jtrain.make_train_step(jc, jopt, jconstant(1e-3),
                                            use_ef=True))(
        js, {"tokens": jnp.asarray(toks)})
    ps, pm = train_mod.make_train_step(pc, popt, constant(1e-3),
                                       use_ef=True)(
        ps, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=2e-4)
    for a, b in zip(jax.tree.leaves(js["ef"]), _jax_order(ps["ef"])):
        a = np.asarray(a).astype(np.float32)
        b = b.float().numpy()
        diff, top = np.abs(a - b), np.abs(a).max()
        assert diff.max() <= 2.05 * top
        assert (diff > 2 ** -8 * top).mean() <= 0.05


def _jax_order(tree):
    return [t for _, t in checkpoint.manager._paths(tree)]


# ---------------------------------------------------------------------------
# Checkpoints (ports of tests/test_train_infra.py)
# ---------------------------------------------------------------------------
def _state(quantized=False):
    _, cfg = _cfgs("olmo-1b")
    return train_mod.make_state(cfg, AdamWConfig(quantized=quantized),
                                torch.Generator().manual_seed(0), "cpu")


def _equal_trees(a, b):
    pa, pb = checkpoint.manager._paths(a), checkpoint.manager._paths(b)
    assert [k for k, _ in pa] == [k for k, _ in pb]
    for (_, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.dim() else x,
                           y.view(torch.uint8) if y.dim() else y)


def test_checkpoint_roundtrip_and_resume(tmp_path):
    state = _state()
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 3, state)
    checkpoint.save(d, 7, state)
    assert checkpoint.latest_step(d) == 7
    restored, at = checkpoint.restore_latest(d, state)
    assert at == 7
    _equal_trees(state, restored)
    _equal_trees(state, checkpoint.restore(d, 3, state, verify=True))


def test_checkpoint_skips_partial(tmp_path):
    state = _state()
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 1, state)
    os.makedirs(os.path.join(d, "step_00000002"))      # no manifest
    assert checkpoint.latest_step(d) == 1
    os.makedirs(os.path.join(d, "step_00000003.tmp"))  # a .tmp leftover
    assert checkpoint.latest_step(d) == 1


def test_checkpoint_gc(tmp_path):
    state = _state()
    d = str(tmp_path / "ckpt")
    for s in range(1, 6):
        checkpoint.save(d, s, state, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]


def test_checkpoint_bf16_and_int8_leaves_bit_exact(tmp_path):
    """bf16 leaves (stored as their uint16 bits, "bfloat16" in the
    manifest), including NaN, inf and subnormal patterns, and the int8
    moments come back bit for bit; verify= checks each sha."""
    state = _state(quantized=True)
    bits = torch.tensor([0x7FC1, 0x7F80, 0xFF80, 0x0001, 0x8000, 0x3F80,
                         0x1234, 0xABCD], dtype=torch.int32).to(torch.int16)
    state["ef"] = {"odd": bits.view(torch.bfloat16).reshape(2, 4)}
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 5, state)
    import json
    with open(os.path.join(d, "step_00000005", "manifest.json")) as f:
        recs = {r["key"]: r for r in json.load(f)["leaves"]}
    assert recs["['ef']['odd']"]["dtype"] == "bfloat16"
    restored = checkpoint.restore(d, 5, state, verify=True)
    _equal_trees(state, restored)
    assert torch.equal(restored["ef"]["odd"].view(torch.int16).reshape(-1),
                       bits)


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    """The same layout: a JAX train state saved by ``repro.checkpoint``
    restores into the port's state of the same config, leaf for leaf."""
    jc, pc = _cfgs("olmo-1b")
    jstate = _jax_state(jc, JAdamWConfig(), seed=2)
    d = str(tmp_path / "ckpt")
    jckpt.save(d, 4, jstate)
    like = _state()
    restored, at = checkpoint.restore_latest(d, like)
    assert at == 4
    _equal_trees(restored, _carried(pc, AdamWConfig(), jstate))


def test_preemption_checkpoint(tmp_path):
    """SIGTERM mid-run writes a checkpoint and a fresh run resumes (port of
    the JAX test, on the CPU)."""
    _, cfg = _cfgs("olmo-1b")
    d = str(tmp_path / "ckpt")
    timer = threading.Timer(2.0, lambda: signal.raise_signal(signal.SIGTERM))
    timer.start()
    try:
        train_loop(cfg, steps=4000, batch=2, seq=32, ckpt_dir=d,
                   ckpt_every=10_000, log_every=10_000, device="cpu")
    finally:
        timer.cancel()
    at = checkpoint.latest_step(d)
    assert at is not None and at >= 1
    state, metrics = train_loop(cfg, steps=at + 2, batch=2, seq=32,
                                ckpt_dir=d, ckpt_every=10_000,
                                log_every=10_000, device="cpu")
    assert int(state["step"]) == at + 2
    assert np.isfinite(float(metrics["loss"]))


def test_train_loop_refuses_a_mesh():
    _, cfg = _cfgs("olmo-1b")
    with pytest.raises(NotImplementedError, match="item 14"):
        train_loop(cfg, steps=1, batch=2, seq=8, device="cpu", mesh=object())


def test_train_loop_loss_falls_on_the_cpu():
    """The reduced olmo-1b learns LMBatcher's bigrams: the mean loss of the
    last 5 of 40 steps is below the first step's."""
    _, cfg = _cfgs("olmo-1b")
    losses = []
    train_loop(cfg, steps=40, batch=4, seq=32, lr=3e-3, log_every=1,
               device="cpu",
               on_metrics=lambda i, m: losses.append(float(m["loss"])))
    assert len(losses) == 40 and np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < losses[0]
