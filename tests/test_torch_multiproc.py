"""The port's placement layer across processes: 2-4 ranks a test over gloo
on the CPU (``torch_mp_worker``), held to the JAX package's multi-device
tests (``tests/test_multidevice.py``), whose reference values the parent
computes and hands over as files.

* the sharded train step on a (2, 2) data x model mesh under TRAIN_RULES:
  olmo-1b, rwkv6-3b, qwen3-moe-30b-a3b (experts over 'model') and
  stablelm-12b (GQA), from JAX's state, within 1e-4 of JAX's unsharded
  loss (JAX's own rule); gradients and updated parameters within 1e-3 of
  each leaf's largest entry of the port's unsharded step; every state leaf
  placed and shaped as resolved.  The other six configs are held to the
  port's unsharded step the same way (their losses to JAX's are held by
  ``test_torch_train.py``), and so are olmo-1b at ``accum_steps=2``,
  stablelm-12b on (1, 4), where its key/value heads stay whole, and a
  12-over-3-head variant on (1, 4), where all its heads do.  A fresh
  state placed leaf by leaf equals the whole state placed.
* ``int8_psum`` over 'pod' of a (2, 2) pod x data mesh, ``pipeline_apply``
  over 4 stages, the elastic restore from (2, 2) onto (4, 1), and the
  sharded alignment service on a 4-rank 'data' mesh.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mp_worker as mp
from repro import checkpoint as jcheckpoint
from repro import configs as jconfigs
from repro import train as jtrain
from repro.models import get_model as jget_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.sharding.pipeline import sequential_reference
from repro.train.compress import _dq, _q
from repro.train.loss import lm_loss as jlm_loss

HELD_TO_JAX = ["olmo-1b", "qwen3-moe-30b-a3b", "rwkv6-3b", "stablelm-12b"]
OTHERS = sorted(set(jconfigs.ARCH_NAMES) - set(HELD_TO_JAX))
ACCUM = "olmo-1b:accum2"
# stablelm-12b's 4 query heads over 2 key/value heads on 4 'model' ranks:
# the key/value heads stay whole and each rank takes the one it reads
GQA_REPLICATED = "stablelm-12b@1x4"
# 12 query heads over 3 on 4 'model' ranks: a rank's 3 query heads would
# straddle the groups of 4 unevenly, so every rank keeps all the heads
GQA_STRADDLING = "stablelm-12b+12x3@1x4"
# olmo-1b with the int8 wire format and its error feedback (use_ef=True)
EF = "olmo-1b!ef"


def _batch(cfg, rng):
    """JAX's multi-device test batch: (8, 32) tokens, with a frontend's
    frames (audio) or an 8-position prefix (vlm)."""
    b = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32))}
    if cfg.frontend == "audio":
        b["frames"] = rng.normal(size=(8, 32, cfg.d_model)).astype(
            np.float32)
    if cfg.frontend == "vlm":
        b["prefix_embeds"] = rng.normal(size=(8, 8, cfg.d_model)).astype(
            np.float32)
    return b


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """One 4-rank run of every registered config; JAX's unsharded losses
    of the four held to JAX, from the states handed to the children."""
    wd = tmp_path_factory.mktemp("train")
    opt = JAdamWConfig(weight_decay=0.01)
    jax_loss = {}
    for arch in sorted(jconfigs.ARCH_NAMES):
        cfg = jconfigs.get(arch, reduced=True)
        b = _batch(cfg, np.random.default_rng(0))
        np.savez(wd / f"batch_{arch}.npz", **b)
        if arch in HELD_TO_JAX:
            state = jtrain.make_state(cfg, opt, jax.random.PRNGKey(0))
            jcheckpoint.save(str(wd / f"jax_{arch}"), 0, state)
            model = jget_model(cfg)
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            loss, _ = jax.jit(lambda p, bb: jlm_loss(
                cfg, model.forward(cfg, p, bb), bb))(state["params"], jb)
            jax_loss[arch] = float(loss)
    for extra in (ACCUM, GQA_REPLICATED, GQA_STRADDLING, EF):
        cfg = jconfigs.get(extra.split(":")[0].split("@")[0].split("+")[0]
                           .split("!")[0], reduced=True)
        np.savez(wd / f"batch_{extra}.npz",
                 **_batch(cfg, np.random.default_rng(0)))
    (wd / "archs.json").write_text(json.dumps(
        sorted(jconfigs.ARCH_NAMES) + [ACCUM, GQA_REPLICATED,
                                       GQA_STRADDLING, EF]))
    mp.run("train", 4, wd, timeout=420)
    return json.loads((wd / "result.json").read_text()), jax_loss


def _held_to_unsharded(r):
    assert r["grad_rel"] < 1e-3, r
    assert r["param_rel"] < 1e-3, r
    assert r["placements"] and r["local_shapes"], r


@pytest.mark.parametrize("arch", HELD_TO_JAX)
def test_sharded_step_matches_jax(arch, train_runs):
    results, jax_loss = train_runs
    r = results[arch]
    assert "error" not in r, r
    assert abs(r["loss_sharded"] - jax_loss[arch]) < 1e-4, (r, jax_loss)
    _held_to_unsharded(r)


@pytest.mark.parametrize("arch", OTHERS)
def test_sharded_step_other_configs(arch, train_runs):
    """Either the sharded step agrees with the port's unsharded one, or
    the config is refused by name (ROADMAP item 14b)."""
    r = train_runs[0][arch]
    if "error" in r:
        assert "14b" in r["error"], r
        return
    assert abs(r["loss_sharded"] - r["loss_plain"]) < 1e-4, r
    _held_to_unsharded(r)


def test_sharded_step_with_accumulation(train_runs):
    """Two microbatches (``accum_steps=2``), each split from the placed
    batch in JAX's contiguous rows and placed again: the same step as the
    unsharded one's."""
    r = train_runs[0][ACCUM]
    assert "error" not in r, r
    assert abs(r["loss_sharded"] - r["loss_plain"]) < 1e-4, r
    _held_to_unsharded(r)


def test_sharded_step_with_error_feedback(train_runs):
    """``make_train_step(..., use_ef=True)``, JAX's train step's int8 wire
    format with error feedback (``train/step.py``), inside the sharded
    step: loss, gradients, grad norm and updated parameters as the
    unsharded step's; ``ef_compress`` on the sharded gradients quantizes
    against the same row scales (global over a split row) and keeps
    g + e within 1e-3, its int8 codes at most one quantum from the
    unsharded ones where f32 noise tips a rounding (under 1e-3 of them);
    and the step carries exactly those residuals."""
    r = train_runs[0][EF]
    assert "error" not in r, r
    assert abs(r["loss_sharded"] - r["loss_plain"]) < 1e-4, r
    _held_to_unsharded(r)
    g_s, g_p = r["grad_norm"]
    assert abs(g_s - g_p) <= 1e-3 * abs(g_p), r
    assert r["ef_scale_rel"] < 1e-3 and r["ef_sum_rel"] < 1e-3, r
    assert r["ef_quanta"] <= 1.001 and r["ef_flipped"] < 1e-3, r
    assert r["step_carries"], r


def test_sharded_step_gqa_kv_heads_replicated(train_runs):
    """On a (1, 4) mesh stablelm-12b's 2 key/value heads do not divide the
    4 'model' ranks (``resolve_spec`` replicates them) while its 4 query
    heads do: each rank runs K3 on its query head with the key/value head
    it reads, and the key/value weights' gradients come back whole."""
    r = train_runs[0][GQA_REPLICATED]
    assert "error" not in r, r
    assert abs(r["loss_sharded"] - r["loss_plain"]) < 1e-4, r
    _held_to_unsharded(r)


def test_sharded_step_gqa_heads_straddling_groups(train_runs):
    """On a (1, 4) mesh 12 query heads over 3 key/value heads: a rank's 3
    query heads would read parts of two groups of 4, which K3's local
    call cannot take, so the heads stay whole on every rank and the step
    is still the unsharded one's."""
    r = train_runs[0][GQA_STRADDLING]
    assert "error" not in r, r
    assert abs(r["loss_sharded"] - r["loss_plain"]) < 1e-4, r
    _held_to_unsharded(r)


def test_fresh_state_placed_leaf_by_leaf(tmp_path):
    """``make_state(shardings=)``, which places each parameter as it is
    drawn and makes the moments and residuals on each rank's own blocks,
    equals the whole unplaced state placed afterwards, with f32 and with
    int8 moments."""
    mp.run("fresh_state", 4, tmp_path, timeout=120)
    r = json.loads((tmp_path / "result.json").read_text())
    for kind in ("quantized=False", "quantized=True"):
        assert r[kind]["leaves"] > 0, r
        assert r[kind]["placements"] and r[kind]["blocks"], r


def test_int8_psum_matches_psum(tmp_path):
    """Over 'pod' of a (2, 2) pod x data mesh: 2 x JAX's _dq(_q(x)) within
    1e-6 relative, and 2 x within the int8 bound of 2 %."""
    x = np.random.default_rng(0).normal(size=(16, 64)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    mp.run("int8_psum", 4, tmp_path, timeout=120)
    got = np.load(tmp_path / "result.npy")
    want = 2 * np.asarray(_dq(*_q(jnp.asarray(x))))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert np.abs(got - 2 * x).max() / np.abs(2 * x).max() < 0.02


def test_pipeline_parallel_matches_sequential(tmp_path):
    """JAX's test: 4 stages, 6 microbatches of 3 x 16, against JAX's
    sequential_reference on the same numpy inputs, on every rank."""
    rng = np.random.default_rng(0)
    P_, M, mb, D = 4, 6, 3, 16
    w = (rng.normal(size=(P_, D, D)) / np.sqrt(D)).astype(np.float32)
    b = rng.normal(size=(P_, D)).astype(np.float32)
    xs = rng.normal(size=(M, mb, D)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", w=w, b=b, xs=xs)
    mp.run("pipeline", 4, tmp_path, timeout=120)
    want = np.asarray(sequential_reference(
        lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(xs), P_))
    for rank in range(4):
        got = np.load(tmp_path / f"result_{rank}.npy")
        assert got.shape == (M, mb, D)
        assert np.abs(got - want).max() < 1e-5


def test_elastic_reshard_roundtrip(tmp_path):
    """A checkpoint written from a (2, 2) mesh (``plan_mesh(4, 2)``)
    restored onto (4, 1) through ``resume_on`` and with no mesh, every
    leaf bit-equal to the state saved."""
    mp.run("elastic", 4, tmp_path, timeout=120)
    r = json.loads((tmp_path / "result.json").read_text())
    assert r["at"] == 5 and r["mesh_a"] == [2, 2]
    assert r["layout_changed"]
    assert r["restored_sharded"] and r["restored_plain"]


def test_sharded_alignment_service(tmp_path):
    """JAX's 16 local_affine requests through the port's
    ``AlignmentService(mesh=)`` on a 4-rank 'data' mesh equal JAX's
    unsharded service on ``reference``, with one placement,
    'data@data=4'."""
    from repro.serve import AlignmentService, AlignRequest
    rng = np.random.default_rng(0)
    qs, rs = [], []
    for _ in range(16):
        qs.append(rng.integers(0, 4, 32).astype(np.uint8))
        rs.append(rng.integers(0, 4, 40).astype(np.uint8))
    q, r = np.stack(qs), np.stack(rs)
    np.savez(tmp_path / "requests.npz", q=q, r=r)
    svc = AlignmentService(max_len=64, block=8, engine_name="reference")
    futs = [svc.submit(AlignRequest(rid=i, kernel="local_affine",
                                    query=q[i], ref=r[i]))
            for i in range(16)]
    assert svc.drain() == 16
    want = [f.result() for f in futs]
    mp.run("service", 4, tmp_path, timeout=180)
    got = json.loads((tmp_path / "result.json").read_text())
    assert got["drained"] == 16
    assert got["placements"] == ["data@data=4"]
    for w, g in zip(want, got["results"]):
        assert g["score"] == pytest.approx(w["score"], abs=0)
        assert tuple(g["end"]) == tuple(w["end"])
        assert g["cigar"] == w["cigar"]


DECODE = ["olmo-1b@2x2", "stablelm-12b@1x4", "rwkv6-3b@2x2",
          "recurrentgemma-9b@2x2"]


@pytest.fixture(scope="module")
def decode_runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("decode")
    (wd / "archs.json").write_text(json.dumps(DECODE))
    mp.run("decode", 4, wd, timeout=300)
    return json.loads((wd / "result.json").read_text())


@pytest.mark.parametrize("entry", DECODE)
def test_sharded_decode_matches_unsharded(entry, decode_runs):
    """Two decode steps on a cache placed as the dry run's decode cells
    place it (INFER_RULES) equal the unsharded steps within 1e-4 of the
    logits' scale, and the cache keeps its placements: the cache write on
    each rank's blocks and the decode attention over a cache whose slots
    are split (stablelm-12b's 2 key/value heads over 4 'model' ranks) or
    whose heads are, the RWKV state step and the ring cache of local
    attention with the RG-LRU."""
    r = decode_runs[entry]
    assert r["rel"] < 1e-4 and r["kept"], r
