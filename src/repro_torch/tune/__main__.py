"""Sweep K1's schedule knobs and write the winners to the port's tuning
table (counterpart of ``scripts/autotune.py``).

    PYTHONPATH=src python -m repro_torch.tune --kernels global_affine \
        --buckets 256 --batches 1024 --mode fill

Each (kernel, engine, bucket, batch) point enumerates the engine's legal
grid, ranks it with the analytic H100 model (``tune.cost``), times the
top-K and the hand-picked default through the plan cache, each held
bit-equal to the default first, and records the fastest.  The table
(``TUNE_TABLE_TORCH.json`` at the repository root unless ``--out``) is read
by ``get_plan`` when a caller passes no schedule option;
``REPRO_TORCH_TUNE_TABLE=off`` disables it.  Entries are keyed by device
name and torch version, so an upgrade refreshes rather than poisons.  An
existing table is merged into unless ``--fresh``.  ``--device cpu`` sweeps
the plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="autotune K1's schedule knobs into the port's table")
    ap.add_argument("--kernels", default="global_affine,local_affine",
                    help="comma-separated kernels_zoo names")
    ap.add_argument("--engines", default="wavefront",
                    help="comma-separated engine names")
    ap.add_argument("--buckets", default="256",
                    help="comma-separated square bucket lengths")
    ap.add_argument("--batches", default="1024",
                    help="comma-separated batch sizes ('single' = "
                         "un-batched plan)")
    ap.add_argument("--mode", default="fill", choices=("fill", "align"),
                    help="time the fill alone (default) or fill+traceback")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="table path (default: repo-root "
                         "TUNE_TABLE_TORCH.json)")
    ap.add_argument("--top-k", type=int, default=4,
                    help="candidates the cost model keeps per point")
    ap.add_argument("--iters", type=int, default=3,
                    help="timing repeats per candidate (median)")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore an existing table instead of merging")
    args = ap.parse_args(argv)

    # the sweep measures against the hand-picked defaults, never an
    # installed table
    os.environ["REPRO_TORCH_TUNE_TABLE"] = "off"

    from repro_torch import tune
    from repro_torch.runtime import plan as plan_mod

    out = args.out or str(tune.default_path())
    table = None
    if not args.fresh and os.path.isfile(out):
        table = tune.TuningTable.load(out)
        print(f"# merging into {out} ({len(table)} entries)")

    def batch(tok: str):
        return None if tok.strip() == "single" else int(tok)

    points = [(k.strip(), e.strip(), (int(b), int(b)), batch(n))
              for k in args.kernels.split(",")
              for e in args.engines.split(",")
              for b in args.buckets.split(",")
              for n in args.batches.split(",")]
    print(f"# sweeping {len(points)} points on {args.device} "
          f"(top_k={args.top_k}, iters={args.iters}, mode={args.mode})")
    try:
        table = tune.run_sweep(points, table=table, top_k=args.top_k,
                               iters=args.iters, device=args.device,
                               mode=args.mode, log=lambda m: print(f"# {m}"))
    except (RuntimeError, ValueError, KeyError) as e:
        print(f"repro_torch.tune: {e}", file=sys.stderr)
        return 2
    table.save(out)
    print(f"# wrote {out} ({len(table)} entries)")
    totals = plan_mod.plan_cache_info()["totals"]
    print(f"# {totals['compiled']} plans dispatched cold, "
          f"{totals['compile_s']:.1f} s of first dispatches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
