"""The readings a cell's limits are set from, at the cell's own size, in
one process: for each seed, the numbers the check compares for the
program (each block of the seed's pool run once through the window's
entry) and for the control (the plain reference in the program's place at
the precision below the configuration's).

    python3 bench/readings.py --workload pairhmm_hc.sites_b32768 \
        --seeds 11,12,13 [--control] [--program] [--dtype int16]

Prints one JSON line a seed and reading.  ``--dtype`` reads the reference
at another precision in the program's place as well.  The benchmark's own
runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def program_answers(cell, pool, device):
    """Each block of the pool once through align_batch, harvested."""
    from bench import harness
    caller = harness.make_caller(
        cell, harness.Blocks(pool, pin=device.type == "cuda"), device)
    return dict(caller.harvest(caller.submit(k)) for k in range(len(pool)))


def control(cell, device, dtype=None):
    """The plain reference in the program's place, at the control
    precision or at ``dtype``: a function of the sampled inputs."""
    import torch
    from bench import harness
    ref = harness.load_module("reference", cell.config["reference"])
    if dtype is None:
        return lambda inputs: harness.reference_answers(
            ref, cell.config, inputs, device, "control")

    def at_dtype(inputs):
        q, r, ql, rl = inputs
        return ref.reference(cell.config, q, r, ql, rl, device=device,
                             dtype=getattr(torch, dtype))
    return at_dtype


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--dtype", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from bench import harness, traffic as traffic_mod
    cell = harness.resolve(harness.load_benchmark(ROOT), args.workload)
    harness.apply_host(cell.config)
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        pool = traffic_mod.make_pool(cell.traffic, seed)
        runs = []
        if args.program:
            runs.append(("program", lambda: program_answers(cell, pool, dev)))
        if args.control:
            runs.append(("control", lambda: control(cell, dev)))
        if args.dtype:
            runs.append((args.dtype, lambda: control(cell, dev,
                                                     args.dtype)))
        for what, make in runs:
            t = time.perf_counter()
            answers = make()
            numbers, bad, n = harness.check(cell.config, cell.traffic, pool,
                                            answers, seed, dev)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "reading": what, "numbers": numbers,
                              "bad_pairs": int(bad.sum()), "compared": n,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
