"""LM serving on the PyTorch port: ``repro_torch.serve.ServeSession`` and
``repro_torch.launch.serve.serve_lm`` give the JAX package's greedy tokens
exactly, on the reduced configs in f32 with weights carried across by
``from_jax`` (one slot, and five requests queued on two slots).  The seeds
are fixed before the first run."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import ServeSession as JSession
from repro_torch import configs as pconfigs
from repro_torch.launch.serve import serve_lm
from repro_torch.models.params import from_jax, init_params, tree_map
from repro_torch.serve import Request, ServeSession

ARCHS = ["olmo-1b", "rwkv6-3b", "stablelm-12b", "phi3-medium-14b",
         "command-r-plus-104b", "qwen3-moe-30b-a3b", "llava-next-mistral-7b",
         "recurrentgemma-9b", "deepseek-v3-671b"]


def _models(arch, seed=0):
    """Both packages' reduced model on one set of weights: JAX's init, or
    for recurrentgemma the port's (its reduced groups repeat once, and
    JAX's init divides a stacked leaf by the square root of the layer
    count, ROADMAP queue 3, so every projection would be N(0, 1))."""
    jc = jconfigs.get(arch, reduced=True)
    pc = pconfigs.get(arch, reduced=True)
    if arch == "recurrentgemma-9b":
        tree = tree_map(lambda t: t.numpy(), init_params(
            pc, torch.Generator().manual_seed(seed), "cpu"))
        jp = jax.tree.map(jnp.asarray, tree)
    else:
        jp = jlm.init(jc, jax.random.PRNGKey(seed))
    return jc, jp, pc, from_jax(pc, jax.tree.map(np.asarray, jp), "cpu")


def _prompts(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _serve_both(arch, prompts, max_new, slots, max_len):
    jc, jp, pc, pp = _models(arch)
    jreqs = [JRequest(rid=i, prompt=p, max_new=max_new)
             for i, p in enumerate(prompts)]
    preqs = [Request(rid=i, prompt=p, max_new=max_new)
             for i, p in enumerate(prompts)]
    jdone = JSession(jc, jp, batch_slots=slots, max_len=max_len).run(jreqs)
    pdone = ServeSession(pc, pp, batch_slots=slots, max_len=max_len,
                         device="cpu").run(preqs)
    return jdone, pdone


@pytest.mark.parametrize("arch", ARCHS)
def test_one_slot_greedy_tokens_equal_jax(arch):
    (prompt,) = _prompts(1, [9], 256)
    jdone, pdone = _serve_both(arch, [prompt], max_new=8, slots=1,
                               max_len=32)
    assert [r.out for r in pdone] == [r.out for r in jdone]
    assert len(pdone[0].out) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_five_requests_on_two_slots_equal_jax(arch):
    """More requests than slots: queued requests take freed slots, whose
    cache rows hold the previous request's values until the splice."""
    prompts = _prompts(2, [4, 5, 6, 4, 5], 256)
    jdone, pdone = _serve_both(arch, prompts, max_new=4, slots=2,
                               max_len=24)
    assert len(pdone) == 5
    assert [(r.rid, r.out) for r in pdone] == \
        [(r.rid, r.out) for r in jdone]


def test_serve_lm_equals_jax_launcher():
    """The launcher with weights carried from JAX's ``model.init`` of the
    same seed serves JAX's ``serve_lm`` tokens."""
    from repro.launch.serve import serve_lm as jserve_lm
    _, _, pc, pp = _models("olmo-1b", seed=0)
    want = jserve_lm("olmo-1b", n_requests=3, max_new=4, slots=2)
    got = serve_lm("olmo-1b", n_requests=3, max_new=4, slots=2,
                   device="cpu", params=pp)
    assert [(r.rid, r.out) for r in got] == [(r.rid, r.out) for r in want]


def test_session_records_logits_and_stats():
    """``record_logits`` keeps every prefill's and decode step's logits;
    the stats count prompt and generated tokens."""
    _, _, pc, pp = _models("rwkv6-3b")
    prompts = _prompts(3, [5, 7], 256)
    sess = ServeSession(pc, pp, batch_slots=2, max_len=16, device="cpu",
                        record_logits=True)
    done = sess.run([Request(rid=i, prompt=p, max_new=3)
                     for i, p in enumerate(prompts)])
    assert [len(r.out) for r in done] == [3, 3]
    assert sess.stats["prefill_tokens"] == 12
    assert sess.stats["decode_tokens"] == 4
    kinds = [slot for slot, _ in sess.logits_log]
    assert kinds == [0, 1, None, None]
    assert sess.logits_log[2][1].shape == (2, pc.vocab_eff)
    for r in done:
        assert r.t_first <= r.t_done


def test_sampling_is_seeded():
    _, _, pc, pp = _models("olmo-1b")
    prompts = _prompts(4, [6, 6], 256)

    def run(seed):
        sess = ServeSession(pc, pp, batch_slots=2, max_len=16,
                            temperature=1.0, seed=seed, device="cpu")
        return [r.out for r in sess.run([Request(rid=i, prompt=p, max_new=6)
                                         for i, p in enumerate(prompts)])]
    assert run(7) == run(7)
    assert all(0 <= t < pc.vocab_eff for out in run(8) for t in out)


def test_prompt_must_fit_the_cache():
    _, _, pc, pp = _models("olmo-1b")
    sess = ServeSession(pc, pp, batch_slots=1, max_len=8, device="cpu")
    with pytest.raises(ValueError):
        sess.add(Request(rid=0, prompt=np.zeros(8, np.int32), max_new=2))


def test_session_refuses_encoder_decoder():
    """An encoder-decoder config is refused at construction, as JAX's
    session asserts ("use whisper-specific driver for enc-dec")."""
    pc = pconfigs.get("whisper-medium", reduced=True)
    with pytest.raises(ValueError, match="encoder-decoder"):
        ServeSession(pc, {}, batch_slots=1, max_len=8, device="cpu")
    jc = jconfigs.get("whisper-medium", reduced=True)
    with pytest.raises(AssertionError, match="enc-dec"):
        JSession(jc, {}, batch_slots=1, max_len=8)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, _, pc, pp = _models("olmo-1b")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeSession(pc, pp, batch_slots=1, max_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_lm("olmo-1b", n_requests=1)
