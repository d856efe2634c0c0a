#!/usr/bin/env python
"""Training step times of this checkout and another one, in turns, on one GPU.

    PYTHONPATH=src python scripts/train_in_turns.py --other DIR \
        [--arch olmo-1b,rwkv6-3b] [--steps 6]

DIR is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``).  For each architecture the script
runs ``train_loop`` at full width (4 x 2048 tokens a step, seed 0) in a
fresh process per run, in the order other, this, this, other, each
process importing ``repro_torch`` from its own checkout and building that
checkout's kernels.  A run's step time is the median of its steps after
the first, from the host clock between logged steps (each ends in a
synchronising read of the loss).  Prints each run, then per architecture
the medians of the two runs of each checkout and their ratio, beside the
card's name and power limit.  Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

RUN = r"""
import json, statistics, sys, time
import torch
from repro_torch import configs
from repro_torch.launch.train import train_loop
cfg = configs.get(sys.argv[1])
stamps, losses = [], []
def on_metrics(step, metrics):
    losses.append(float(metrics["loss"]))
    stamps.append(time.perf_counter())
stamps.append(time.perf_counter())
train_loop(cfg, steps=int(sys.argv[2]), batch=4, seq=2048, log_every=1,
           device="cuda", on_metrics=on_metrics)
steps = [b - a for a, b in zip(stamps, stamps[1:])]
print(json.dumps({"step_s": statistics.median(steps[1:]), "steps_s": steps,
                  "losses": losses}))
"""


def run(checkout: Path, arch: str, steps: int) -> dict:
    env = {**os.environ, "PYTHONPATH": str(checkout / "src")}
    proc = subprocess.run([sys.executable, "-c", RUN, arch, str(steps)],
                          cwd=checkout, env=env, capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"{arch} in {checkout} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--arch", default="olmo-1b,rwkv6-3b")
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_in_turns: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    other = args.other.resolve()
    for arch in args.arch.split(","):
        times = {"this": [], "other": []}
        for who in ("other", "this", "this", "other"):
            got = run(ROOT if who == "this" else other, arch, args.steps)
            times[who].append(got["step_s"])
            print(f"{arch} {who}: step {got['step_s']:.4f} s (steps "
                  f"{', '.join(f'{t:.4f}' for t in got['steps_s'])}; losses "
                  f"{', '.join(f'{x:.4f}' for x in got['losses'])})",
                  flush=True)
        this, oth = (statistics.median(times[w]) for w in ("this", "other"))
        print(f"{arch}: this {this:.4f} s a step, other {oth:.4f} s "
              f"({8192 / this:.0f} and {8192 / oth:.0f} tokens/s); this / "
              f"other {this / oth:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
