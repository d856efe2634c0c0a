#!/usr/bin/env python3
"""Multi-GPU smoke of the port's placement path, over NCCL on every card
of one machine:

    torchrun --nproc-per-node=<cards> scripts/multigpu_smoke.py

``<cards>`` must be even.  Each rank drives one card; rank 0 builds the
kernels first (one ``nvcc`` per source, all at once), the others load
them.  In order:

1. the sharded aligner (``core.batch.make_sharded_aligner``, #2 with
   traceback) on 8192 windows of 128-256 bases of a random 1 Mb reference,
   8 % mutated, in padded blocks of 1024, over a ``data`` mesh of every
   card: each block bit-equal (score, end cell, moves) to ``align_batch``
   on the rank's own card;
2. olmo-1b at full width (bf16, remat), 3 AdamW steps of 4 x 2048 tokens
   through ``train_loop(mesh=)`` on a (cards / 2, 2) data x model mesh
   under TRAIN_RULES, beside the unsharded ``train_loop`` on each card:
   the losses within 1e-4 relative (JAX's multi-device rule) and the
   gradient norms within 1e-2, so a gradient reduced wrongly over NCCL
   fails; K3's launches a step, step times, and peak memory over the
   whole run and over steps 2-3;
3. ``int8_psum`` over 'pod' of a (2, cards / 2) pod x data mesh: 2 x the
   rank's int8 round trip within 1e-6 relative;
4. ``pipeline_apply`` over every card as a stage, 6 microbatches of
   3 x 16, against ``sequential_reference`` within 1e-5;
5. the elastic restore: step 2's trained parameters saved from the
   (cards / 2, 2) mesh and restored through ``ft.elastic.resume_on`` onto
   (cards, 1), bit-equal.

Rank 0 prints each part's numbers and, last, one JSON line; the exit code
is 0 only if every check passed.  ``--device cpu --reduced`` rehearses
the same path on the CPU (gloo, reduced configs, ``--pairs 256``):
``torchrun --nproc-per-node=4 scripts/multigpu_smoke.py --device cpu
--reduced --pairs 256``.
"""
from __future__ import annotations

import argparse
import datetime
import json
import logging
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

FAILED = []
BLOCK = 1024          # padded aligner block
STEPS, BATCH, SEQ = 3, 4, 2048
LOSS_RTOL = 1e-4      # JAX's tests/test_multidevice.py rule
GNORM_RTOL = 1e-2


def check(cond, what):
    if not cond:
        FAILED.append(what)
        print(f"rank {dist.get_rank()}: FAILED: {what}", flush=True)


def say(*a):
    if dist.get_rank() == 0:
        print(*a, flush=True)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh(dev, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=names)


def build_kernels(dev):
    """Rank 0 builds K1, K3 and K3's backward (one nvcc each, at once);
    every rank then loads them from the shared build directory."""
    if dev.type != "cuda":
        return
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import kernel as K3
    from repro_torch.kernels.wavefront import kernel as K1
    sources = (K1.SOURCE, K3.SOURCE, K3.SOURCE_BWD)
    if dist.get_rank() == 0:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(sources)) as pool:
            list(pool.map(build.load, sources))
        say(f"built K1, K3 and K3's backward in "
            f"{time.perf_counter() - t0:.1f} s")
    dist.barrier()


def padded_blocks(pairs, block):
    """The padded blocks run_pairs forms: (qs, rs, ql, rl)."""
    from repro_torch.runtime import bucketing
    batches, _ = bucketing.pack_by_bucket(
        [(len(q), len(r)) for q, r in pairs], block=block)
    out = []
    for b in batches:
        bq, br = b.bucket
        qs = np.zeros((block, bq), np.uint8)
        rs = np.zeros((block, br), np.uint8)
        ql = np.ones((block,), np.int32)
        rl = np.ones((block,), np.int32)
        for row, idx in enumerate(b.indices):
            q, r = pairs[idx]
            ql[row], rl[row] = len(q), len(r)
            qs[row, :len(q)] = q
            rs[row, :len(r)] = r
        out.append((qs, rs, ql, rl))
    return out


def part_aligner(dev, n_pairs, block):
    from repro_torch.core import alphabets, kernels_zoo
    from repro_torch.core import batch as core_batch
    from repro_torch.core.spec_utils import params_on_device
    from repro_torch.kernels.wavefront import kernel as K1
    world = dist.get_world_size()
    rng = np.random.default_rng(0)
    genome = alphabets.random_dna(rng, 1_000_000)
    pairs = []
    for _ in range(n_pairs):
        w = int(rng.integers(128, 257))
        s = int(rng.integers(0, len(genome) - w))
        ref = genome[s:s + w]
        q = alphabets.mutate(rng, ref, 0.08)[:256]
        pairs.append((q if len(q) else ref[:1], ref))
    block = min(block, n_pairs)
    block -= block % world
    blocks = padded_blocks(pairs, block)
    spec, params = kernels_zoo.make(2)
    params = params_on_device(params, dev)
    aligner = core_batch.make_sharded_aligner(
        spec, mesh(dev, (world,), ("data",)), device=dev)
    want = [core_batch.align_batch(spec, params, *b, device=dev)
            for b in blocks]
    K1.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    got = [aligner(params, *b) for b in blocks]
    sync(dev)
    wall = time.perf_counter() - t0
    launches = K1.launches
    if dev.type == "cuda":
        check(launches == len(blocks), f"K1 launched {launches} times for "
              f"{len(blocks)} blocks")
    for g, w in zip(got, want):
        for f in ("score", "end_i", "end_j", "moves", "n_moves"):
            check(torch.equal(getattr(g, f), getattr(w, f)),
                  f"sharded aligner: {f} differs from align_batch")
    say(f"[1] sharded aligner #2, {n_pairs} windows in {len(blocks)} blocks "
        f"of {block} over data={world}: {wall:.3f} s wall, K1 launches "
        f"{launches} a rank ({block // world} rows a block each); "
        f"bit-equal to align_batch")
    return {"pairs": n_pairs, "blocks": len(blocks), "wall_s": wall,
            "k1_launches_per_rank": launches}


def part_train(dev, reduced, seq):
    import statistics
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.kernels.flash_attn import kernel as K3
    from repro_torch.launch.train import train_loop
    from repro_torch.models.params import leaves
    world = dist.get_world_size()
    cfg = configs.get("olmo-1b", reduced=reduced)
    runs = {}
    state = None
    for name, m in (("plain", None),
                    ("sharded", mesh(dev, (world // 2, 2),
                                     ("data", "model")))):
        del state
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        losses, gnorms, stamps, counts = [], [], [time.perf_counter()], []
        peak = {}

        def on_metrics(i, metrics):
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
            stamps.append(time.perf_counter())
            counts.append((K3.launches, K3.bwd_launches))
            if i == 1 and dev.type == "cuda":   # init and step 1 behind
                peak["run"] = torch.cuda.max_memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
        K3.launches = K3.bwd_launches = 0
        state, _ = train_loop(cfg, steps=STEPS, batch=BATCH, seq=seq,
                              log_every=1, device=dev.type, mesh=m,
                              on_metrics=on_metrics)
        sync(dev)
        step_s = [b - a for a, b in zip(stamps, stamps[1:])]
        steps_peak = (torch.cuda.max_memory_allocated(dev)
                      if dev.type == "cuda" else None)
        runs[name] = {
            "losses": losses, "grad_norms": gnorms,
            "step_s": statistics.median(step_s[1:]),
            "peak_gib": (max(peak["run"], steps_peak) / 2**30
                         if dev.type == "cuda" else None),
            "steps_peak_gib": (steps_peak / 2**30 if dev.type == "cuda"
                               else None),
            "k3_per_step": [b[0] - a[0] for a, b in
                            zip([(0, 0)] + counts, counts)]}

    def rel_of(key):
        return max(abs(a - b) / abs(b) for a, b in
                   zip(runs["sharded"][key], runs["plain"][key]))
    rel, gn_rel = rel_of("losses"), rel_of("grad_norms")
    check(rel <= LOSS_RTOL, f"sharded losses {runs['sharded']['losses']} "
          f"vs unsharded {runs['plain']['losses']}: rel {rel:.3g}")
    check(gn_rel <= GNORM_RTOL, f"sharded grad norms "
          f"{runs['sharded']['grad_norms']} vs unsharded "
          f"{runs['plain']['grad_norms']}: rel {gn_rel:.3g}")
    check(all(isinstance(t, DTensor) for t in leaves(state)),
          "a sharded state leaf is not a DTensor")
    if dev.type == "cuda":
        check(runs["sharded"]["k3_per_step"] == runs["plain"]["k3_per_step"],
              f"K3 launches a step {runs['sharded']['k3_per_step']} vs "
              f"{runs['plain']['k3_per_step']}")
    say(f"[2] {cfg.name} through train_loop on ({world // 2}, 2) data x "
        f"model, {STEPS} steps of {BATCH} x {seq}: losses "
        f"{runs['sharded']['losses']} vs unsharded {runs['plain']['losses']}"
        f" (max rel {rel:.3g}), grad norms max rel {gn_rel:.3g}; step "
        f"{runs['sharded']['step_s']:.3f} s vs "
        f"{runs['plain']['step_s']:.3f} s; peak {runs['sharded']['peak_gib']}"
        f" vs {runs['plain']['peak_gib']} GiB a card over the run, "
        f"{runs['sharded']['steps_peak_gib']} vs "
        f"{runs['plain']['steps_peak_gib']} over steps 2-3; K3 a step "
        f"{runs['sharded']['k3_per_step']}")
    return dict(runs, loss_rel=rel, grad_norm_rel=gn_rel), state, cfg


def part_int8(dev):
    from repro_torch.train.compress import _dq, _q, int8_psum
    world = dist.get_world_size()
    m = mesh(dev, (2, world // 2), ("pod", "data"))
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(16, 64)).astype(np.float32), device=dev)
    got = int8_psum(x, m, "pod")
    want = 2 * _dq(*_q(x))
    rel = float((got - want).abs().max() / want.abs().max())
    rel_x = float((got - 2 * x).abs().max() / (2 * x).abs().max())
    check(rel <= 1e-6, f"int8_psum: rel {rel:.3g} to 2 x _dq(_q(x))")
    check(rel_x < 0.02, f"int8_psum: rel {rel_x:.3g} to 2 x")
    say(f"[3] int8_psum over pod=2 of (2, {world // 2}): rel {rel:.3g} to "
        f"2 x the int8 round trip, {rel_x:.3g} to 2 x")
    return {"rel": rel, "rel_to_2x": rel_x}


def part_pipeline(dev):
    from repro_torch.sharding import pipeline_apply, sequential_reference
    world = dist.get_world_size()
    rng = np.random.default_rng(0)
    M, mb, D = 6, 3, 16
    params = {"w": torch.as_tensor((rng.normal(size=(world, D, D))
                                    / np.sqrt(D)).astype(np.float32),
                                   device=dev),
              "b": torch.as_tensor(rng.normal(size=(world, D)).astype(
                  np.float32), device=dev)}
    xs = torch.as_tensor(rng.normal(size=(M, mb, D)).astype(np.float32),
                         device=dev)

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])
    got = pipeline_apply(mesh(dev, (world,), ("pipe",)), "pipe", stage,
                         params, xs)
    err = float((got - sequential_reference(stage, params, xs,
                                            world)).abs().max())
    check(err < 1e-5, f"pipeline_apply: max |diff| {err:.3g}")
    say(f"[4] pipeline_apply over {world} stages, {M} microbatches of "
        f"{mb} x {D}: max |diff| {err:.3g} to sequential_reference")
    return {"max_abs_err": err}


def part_elastic(dev, state, cfg):
    from repro_torch import checkpoint
    from repro_torch.ft import elastic
    from repro_torch.launch.shardctx import ShardCtx
    from repro_torch.models import get_model
    from repro_torch.models.params import leaves
    from repro_torch.sharding import TRAIN_RULES
    world = dist.get_world_size()
    model = get_model(cfg)
    tmp = tempfile.mkdtemp(prefix="elastic_") if dist.get_rank() == 0 \
        else None
    box = [tmp]
    dist.broadcast_object_list(box, src=0)
    tmp = box[0]
    params = state["params"]
    t0 = time.perf_counter()
    checkpoint.save(tmp, 1, {"params": params})
    like = {"params": model.abstract(cfg)}
    target = elastic.make_mesh(list(range(world)), (world, 1),
                               device=dev.type)
    back, at = elastic.resume_on(
        target, tmp, like, lambda m: {"params": ShardCtx(
            m, TRAIN_RULES).tree(model.abstract(cfg), model.logical(cfg))})
    secs = time.perf_counter() - t0
    same = at == 1
    for a, b in zip(leaves(params), leaves(back["params"])):
        same &= bool(torch.equal(a.full_tensor(), b.full_tensor()))
    check(same, "elastic restore: a leaf differs")
    moved = any(a.to_local().shape != b.to_local().shape
                for a, b in zip(leaves(params), leaves(back["params"])))
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"[5] parameters saved from ({world // 2}, 2) and restored onto "
        f"({world}, 1) through resume_on: bit-equal, local blocks "
        f"{'re-cut' if moved else 'unchanged'} ({secs:.1f} s)")
    return {"bit_equal": same, "seconds": secs}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced olmo-1b (a CPU rehearsal)")
    ap.add_argument("--pairs", type=int, default=8192)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("multigpu_smoke: no CUDA device (pass --device cpu)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    backend = "nccl" if args.device == "cuda" else "gloo"
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=300))
    try:
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dev = torch.device("cuda", torch.cuda.current_device())
        else:
            torch.set_num_threads(1)
            dev = torch.device("cpu")
        world = dist.get_world_size()
        if world % 2:
            raise SystemExit(f"multigpu_smoke: {world} ranks; an even "
                             f"number is needed")
        seq = min(SEQ, 64) if args.reduced else SEQ
        t0 = time.perf_counter()
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else "cpu"
        say(f"multigpu_smoke: {world} ranks, {backend}, {name}")
        build_kernels(dev)
        out = {"world": world, "backend": backend,
               "aligner": part_aligner(dev, args.pairs, BLOCK)}
        train, state, cfg = part_train(dev, args.reduced, seq)
        out["train"] = train
        out["int8_psum"] = part_int8(dev)
        out["pipeline"] = part_pipeline(dev)
        out["elastic"] = part_elastic(dev, state, cfg)
        out["seconds"] = time.perf_counter() - t0
        n_failed = torch.tensor([len(FAILED)], device=dev)
        dist.all_reduce(n_failed)
        out["ok"] = int(n_failed) == 0
        say(json.dumps(out))
        return 0 if out["ok"] else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
