"""Training launcher: checkpointed and preemption-tolerant (port of
``repro/launch/train.py``).

``train_loop`` runs on the card unless the caller passes ``device="cpu"``.
Resume-from-latest is automatic: a fresh process picks up at the last valid
atomic checkpoint in ``ckpt_dir``, and SIGTERM ends the run after the step
in progress with a checkpoint.  As in JAX, a resumed run's data stream
starts from its first batch.  ``mesh=`` (a ``DeviceMesh`` with 'data'
and 'model' axes; every rank of it runs the loop) places the state by
``ShardCtx(mesh, TRAIN_RULES)``, splits each batch on its batch axis and
resumes through ``restore_latest(shardings=)``; ``mesh=None`` is the
unsharded run.

``python -m repro_torch.launch.train --arch olmo-1b --steps 20 --device
cpu`` trains the reduced config on the CPU (drop ``--device`` on the
card).
"""
from __future__ import annotations

import argparse
import signal
import time

import torch

from repro_torch import checkpoint, configs
from repro_torch import train as train_mod
from repro_torch.configs.llava_next_mistral_7b import LLAVA_PATCHES
from repro_torch.data import LMBatcher
from repro_torch.launch.shardctx import ShardCtx
from repro_torch.optim import AdamWConfig, cosine_with_warmup
from repro_torch.serve.engine import resolve_device
from repro_torch.sharding import TRAIN_RULES, logical_sharding, place


def batches(cfg, batch: int, seq: int, seed: int = 0):
    """The training stream of ``cfg``: ``LMBatcher(seed=seed)`` batches of
    ``batch`` x ``seq`` positions, with JAX's launcher's frontend prefix (a
    vlm config's first ``min(LLAVA_PATCHES, seq // 2)`` positions are patch
    embeddings and the rest tokens; an audio config takes ``seq`` frames
    beside ``seq`` tokens)."""
    prefix = (min(LLAVA_PATCHES, seq // 2) if cfg.frontend == "vlm"
              else (seq if cfg.frontend == "audio" else 0))
    return iter(LMBatcher(
        vocab=cfg.vocab_size, batch=batch,
        seq=(seq - prefix) if cfg.frontend == "vlm" else seq, seed=seed,
        frontend=cfg.frontend, d_model=cfg.d_model, prefix=prefix))


def train_loop(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
               ckpt_dir=None, ckpt_every: int = 50, device="cuda",
               opt_cfg=None, log_every: int = 10, seed: int = 0,
               on_metrics=None, mesh=None):
    """Train ``cfg`` for ``steps`` steps of ``batches(cfg, batch, seq,
    seed)``, AdamW (``opt_cfg``, default weight decay 0.01) under
    ``cosine_with_warmup(lr, max(steps // 20, 5), steps)``.
    ``on_metrics(step, metrics)`` is called at every logged step.  Returns
    (state, last metrics).  With ``mesh`` the state holds DTensors and
    rank 0 alone prints; the metrics are plain tensors on every rank."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(weight_decay=0.01)
    lr_fn = cosine_with_warmup(lr, max(steps // 20, 5), steps)

    sc = shardings = None
    if mesh is not None:
        sc = ShardCtx(mesh, TRAIN_RULES)
        shardings = sc.tree(train_mod.abstract_state(cfg, opt_cfg),
                            train_mod.state_logical(cfg, opt_cfg))
    loud = mesh is None or torch.distributed.get_rank() == 0
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = train_mod.make_state(cfg, opt_cfg, gen, dev,
                                 shardings=shardings)
    start = 0
    if ckpt_dir:
        restored, at = checkpoint.restore_latest(ckpt_dir, state, dev,
                                                 shardings=shardings)
        if restored is not None:
            state, start = restored, at
            if loud:
                print(f"resumed from step {at}", flush=True)

    step_fn = train_mod.make_train_step(cfg, opt_cfg, lr_fn, sc=sc)
    data = batches(cfg, batch, seq, seed)

    def put(v):
        t = torch.as_tensor(v, device=dev)
        if mesh is None:
            return t
        return place(t, logical_sharding(
            t.shape, ("batch",) + (None,) * (t.ndim - 1), TRAIN_RULES, mesh))

    stop = {"now": False}

    def _sigterm(signum, frame):   # checkpoint-on-preemption
        stop["now"] = True
    old = signal.signal(signal.SIGTERM, _sigterm)

    metrics = {}
    t0 = time.time()
    try:
        for i in range(start, steps):
            b = {k: put(v) for k, v in next(data).items()}
            state, metrics = step_fn(state, b)
            if (i + 1) % log_every == 0 or i == start:
                if loud:
                    print(f"step {i + 1:5d} "
                          f"loss {float(metrics['loss']):.4f} "
                          f"lr {float(metrics['lr']):.2e} "
                          f"gnorm {float(metrics['grad_norm']):.2f} "
                          f"({(time.time() - t0):.1f}s)", flush=True)
                if on_metrics:
                    on_metrics(i + 1, metrics)
            if ckpt_dir and ((i + 1) % ckpt_every == 0 or stop["now"]):
                checkpoint.save(ckpt_dir, i + 1, state)
            if stop["now"]:
                if loud:
                    print("preemption checkpoint written; exiting",
                          flush=True)
                break
    finally:
        signal.signal(signal.SIGTERM, old)
    return state, metrics


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=sorted(configs.ARCH_NAMES))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = configs.get(args.arch, reduced=args.reduced)
    train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
               lr=args.lr, ckpt_dir=args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
