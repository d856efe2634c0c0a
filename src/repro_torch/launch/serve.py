"""Serving launcher (port of ``repro/launch/serve.py``): LM slot-based
decode or the DP alignment service.

``python -m repro_torch.launch.serve --arch olmo-1b`` serves a few random
requests with the reduced config on the card; ``--mode align [--kernel
global_affine]`` drains 32 read pairs of 128 bases through the alignment
service instead.  ``--device cpu`` runs either on the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.data import genomics_pairs
from repro_torch.models.params import init_params
from repro_torch.serve import (AlignmentService, AlignRequest, Request,
                               ServeSession)
from repro_torch.serve.engine import resolve_device


def serve_lm(arch: str, n_requests: int = 8, max_new: int = 16,
             slots: int = 4, seed: int = 0, device="cuda", params=None):
    """Serve ``n_requests`` random prompts of 4-16 tokens (the JAX
    launcher's traffic, from the same numpy seed) on a ``slots``-slot
    session of 128 positions.  ``params`` overrides the random weights
    (e.g. carried across with ``models.params.from_jax``)."""
    cfg = configs.get(arch, reduced=True)
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, gen, dev)
    rng = np.random.default_rng(seed)
    sess = ServeSession(cfg, params, batch_slots=slots, max_len=128,
                        device=dev)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, rng.integers(4, 17)
                                        ).astype(np.int32),
                    max_new=max_new)
            for i in range(n_requests)]
    done = sess.run(reqs)
    for r in done:
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")
    return done


def serve_alignments(kernel: str = "global_affine", n: int = 32,
                     length: int = 128, seed: int = 0, device="cuda"):
    """Drain ``n`` mutated read pairs of ``length`` bases
    (``genomics_pairs``: the JAX launcher's pairs from the same seed)
    through an ``AlignmentService(max_len=length, block=8)`` on ``device``,
    one ``kernel`` request a pair; returns the drained service."""
    qs, rs, ql, rl = genomics_pairs(n, length, seed=seed)
    svc = AlignmentService(max_len=length, block=8, device=device)
    for i in range(n):
        svc.submit(AlignRequest(rid=i, kernel=kernel,
                                query=qs[i, : ql[i]], ref=rs[i, : rl[i]]))
    svc.drain()
    return svc


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["lm", "align"], default="lm")
    ap.add_argument("--arch", default="olmo-1b",
                    choices=sorted(configs.ARCH_NAMES))
    ap.add_argument("--kernel", default="global_affine")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.mode == "lm":
        serve_lm(args.arch, device=args.device)
    else:
        serve_alignments(args.kernel, device=args.device)
        print("alignment service drained OK")


if __name__ == "__main__":
    main()
