"""Training launcher: checkpointed and preemption-tolerant (port of
``repro/launch/train.py``).

``train_loop`` runs on the card unless the caller passes ``device="cpu"``.
Resume-from-latest is automatic: a fresh process picks up at the last valid
atomic checkpoint in ``ckpt_dir``, and SIGTERM ends the run after the step
in progress with a checkpoint.  As in JAX, a resumed run's data stream
starts from its first batch.  ``mesh=`` (the sharded run) waits for
multi-GPU placement (ROADMAP queue 1 item 14).

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
from repro_torch.data import LMBatcher
from repro_torch.optim import AdamWConfig, cosine_with_warmup
from repro_torch.serve.engine import resolve_device


def train_loop(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
               ckpt_dir=None, ckpt_every: int = 50, device="cuda",
               opt_cfg=None, log_every: int = 10, seed: int = 0,
               on_metrics=None, mesh=None):
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens from
    ``LMBatcher(seed=seed)``, AdamW (``opt_cfg``, default weight decay
    0.01) under ``cosine_with_warmup(lr, max(steps // 20, 5), steps)``.
    ``on_metrics(step, metrics)`` is called at every logged step.  Returns
    (state, last metrics)."""
    if mesh is not None:
        raise NotImplementedError(
            "train_loop(mesh=...): multi-GPU placement is not ported yet "
            "(ROADMAP queue 1 item 14)")
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(weight_decay=0.01)
    lr_fn = cosine_with_warmup(lr, max(steps // 20, 5), steps)

    gen = torch.Generator(device=dev).manual_seed(seed)
    state = train_mod.make_state(cfg, opt_cfg, gen, dev)
    start = 0
    if ckpt_dir:
        restored, at = checkpoint.restore_latest(ckpt_dir, state, dev)
        if restored is not None:
            state, start = restored, at
            print(f"resumed from step {at}", flush=True)

    step_fn = train_mod.make_train_step(cfg, opt_cfg, lr_fn)
    data = iter(LMBatcher(vocab=cfg.vocab_size, batch=batch, seq=seq,
                          seed=seed, frontend=cfg.frontend,
                          d_model=cfg.d_model))

    stop = {"now": False}

    def _sigterm(signum, frame):   # checkpoint-on-preemption
        stop["now"] = True
    old = signal.signal(signal.SIGTERM, _sigterm)

    metrics = {}
    t0 = time.time()
    try:
        for i in range(start, steps):
            b = {k: torch.as_tensor(v, device=dev)
                 for k, v in next(data).items()}
            state, metrics = step_fn(state, b)
            if (i + 1) % log_every == 0 or i == start:
                loss = float(metrics["loss"])
                print(f"step {i + 1:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"({(time.time() - t0):.1f}s)", flush=True)
                if on_metrics:
                    on_metrics(i + 1, metrics)
            if ckpt_dir and ((i + 1) % ckpt_every == 0 or stop["now"]):
                checkpoint.save(ckpt_dir, i + 1, state)
            if stop["now"]:
                print("preemption checkpoint written; exiting", flush=True)
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
