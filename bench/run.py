"""Run one cell of ``BENCHMARK.json`` on the card.

    python3 bench/run.py --workload sw_affine_dna.short_b262144 --seed 7 \
        --seconds 10 --trace 0

From the root of a checkout.  Prints progress and, as its last lines on
standard error, each compared number beside its limit; the last line of
standard output is the result as one JSON object.  With ``--trace 0`` the
metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (the window, then a traced segment of about two
seconds).  Exits non-zero, printing no result, where no card (or too few)
is present, where the program cannot be imported, or where JAX or the JAX
package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import harness
    cell = harness.resolve(harness.load_benchmark(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  trace=bool(args.trace), device="cuda",
                                  t0=T0)
    except harness.ForbiddenModules as e:
        print(str(e), file=sys.stderr)
        return 4
    found = harness.forbidden_modules()
    if found:
        print(str(harness.ForbiddenModules(found)), file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
