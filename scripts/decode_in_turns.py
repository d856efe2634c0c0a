#!/usr/bin/env python
"""olmo-1b's decode step and K3's host time of this checkout and another
one, in turns, on one GPU.

    PYTHONPATH=src python scripts/decode_in_turns.py --other DIR

DIR is another checkout of the repository (for example the parent commit,
unpacked with ``git archive``).  Each run is a fresh process importing
``repro_torch`` and ``chip_smoke`` from its own checkout and building that
checkout's kernels, in the order other, this, this, other.  A run serves
``chip_smoke.py``'s phase 12 traffic (olmo-1b at full width from seed 0:
16 requests of 256-1536 tokens, 32 new tokens each, on 8 slots of 2048)
through ``chip_smoke._serve`` and reports its decode ms a step (the
session's decode seconds over its steps), then the host microseconds of
one K3 forward call (``flash_fill`` at (1, 128, 16, 128) bf16 causal, the
mean over 2000 calls issued back to back, the device kept ahead of by a
shape this small) and the device ms of the same call (CUDA events over
200 calls).  Prints each run, then the medians of the two runs of each
checkout beside the card's name and power limit.  Exits 2 without a CUDA
device.
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
import json, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch import configs
from repro_torch.kernels.flash_attn import kernel as K3
cfg = configs.get("olmo-1b")
params = cs._full_params(cfg)
out = cs._serve(cfg, params)
st = out["stats"]
decode_ms = st["decode_s"] / st["steps"] * 1e3
del out, params
torch.cuda.empty_cache()
q = torch.randn((1, 128, 16, 128), device="cuda", dtype=torch.bfloat16)
call = lambda: K3.flash_fill(q, q, q, causal=True, p_dtype=q.dtype)
for _ in range(50):
    call()
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(2000):
    call()
host_us = (time.perf_counter() - t0) / 2000 * 1e6
torch.cuda.synchronize()
a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
a.record()
for _ in range(200):
    call()
b.record()
torch.cuda.synchronize()
print(json.dumps({"decode_ms": decode_ms, "steps": st["steps"],
                  "k3_host_us": host_us,
                  "k3_device_ms": a.elapsed_time(b) / 200}))
"""


def run(checkout: Path) -> dict:
    env = {**os.environ, "PYTHONPATH": str(checkout / "src")}
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=checkout,
                          env=env, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"run in {checkout} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("decode_in_turns: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    other = args.other.resolve()
    got = {"this": [], "other": []}
    for who in ("other", "this", "this", "other"):
        r = run(ROOT if who == "this" else other)
        got[who].append(r)
        print(f"{who}: decode {r['decode_ms']:.3f} ms a step over "
              f"{r['steps']} steps; K3 call {r['k3_host_us']:.2f} us on the "
              f"host, {r['k3_device_ms']:.4f} ms on the device", flush=True)
    for key, unit in (("decode_ms", "ms a decode step"),
                      ("k3_host_us", "us a K3 call on the host")):
        this, oth = (statistics.median(x[key] for x in got[w])
                     for w in ("this", "other"))
        spread = [x[key] for w in got for x in got[w]]
        print(f"{unit}: this {this:.3f}, other {oth:.3f} (this - other "
              f"{this - oth:+.3f}; all four runs {min(spread):.3f}-"
              f"{max(spread):.3f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
