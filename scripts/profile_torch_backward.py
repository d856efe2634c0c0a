#!/usr/bin/env python
"""Device time of each launch of the port's two backward kernels, on a GPU.

    PYTHONPATH=src python scripts/profile_torch_backward.py [--calls 5]

K3's backward (``flash_backward``: delta, dk/dv, dq) at (4, 2048, 16, 128)
bf16 causal and K4's (``wkv6_backward``: increments, reverse scan,
gradients, du) at (4, 2048, 48, 64), the olmo-1b and rwkv6-3b training
shapes, with inputs from seed 0.  Builds the kernels if needed, then
records ``--calls`` calls of each under ``torch.profiler`` (after one
warm-up call) and prints each kernel's device ms per call, beside the
card's name and power limit.  Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

K3_SHAPE = (4, 2048, 16, 128)
K4_SHAPE = (4, 2048, 48, 64)


def per_launch_ms(fn, calls):
    """{kernel name: device ms per call} of ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / calls / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_backward: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attn import kernel as K3
    from repro_torch.kernels.wkv6 import kernel as K4
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator("cuda").manual_seed(0)
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=gen)
    q, k, v, do = (torch.randn(K3_SHAPE, **bf) for _ in range(4))
    out, lse = K3.flash_fill(q, k, v, causal=True, p_dtype=torch.bfloat16,
                             return_lse=True)
    k3 = per_launch_ms(lambda: K3.flash_backward(q, k, v, out, lse, do,
                                                 causal=True), args.calls)
    r, kk, vv = (torch.randn(K4_SHAPE, **bf) for _ in range(3))
    lw = -torch.rand(K4_SHAPE, device="cuda", generator=gen)
    u = torch.randn(K4_SHAPE[2:], device="cuda", generator=gen)
    _, _, states = K4.wkv6_fill(r, kk, vv, lw, u, return_states=True)
    dy = torch.randn(K4_SHAPE, device="cuda", generator=gen)
    k4 = per_launch_ms(lambda: K4.wkv6_backward(r, kk, vv, lw, u, dy,
                                                states=states), args.calls)
    print(smi)
    for what, shape, rows in (("K3 backward", K3_SHAPE, k3),
                              ("K4 backward", K4_SHAPE, k4)):
        print(f"{what} at {shape}: {sum(rows.values()):.4f} ms of kernels a "
              f"call ({args.calls} calls)")
        for name, ms in sorted(rows.items(), key=lambda x: -x[1]):
            name = name.replace("(anonymous namespace)::", "")
            print(f"    {ms:.4f} ms  {name.split('(')[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
