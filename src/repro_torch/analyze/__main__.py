"""Lint the port's registered kernel x engine plan space without a card
(counterpart of ``scripts/lint_plans.py``).

Sweeps every (kernel, engine) pair the registry admits at a representative
bucket and batch through the rules of ``repro_torch.analyze`` and exits 1
iff an error-severity finding survives (2 on a bad selector or kernel).

    PYTHONPATH=src python -m repro_torch.analyze            # full sweep
    PYTHONPATH=src python -m repro_torch.analyze --json
    PYTHONPATH=src python -m repro_torch.analyze --rules R4 R101
    PYTHONPATH=src python -m repro_torch.analyze --no-hlo   # skip R303
    PYTHONPATH=src python -m repro_torch.analyze --kernels 11 12 \\
        --engines banded --bucket 48x64 --batch 8
    PYTHONPATH=src python -m repro_torch.analyze --list-rules
"""
from __future__ import annotations

import argparse
import sys


def parse_bucket(text):
    try:
        q, r = text.lower().split("x")
        return int(q), int(r)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"bucket must look like 64x64, got {text!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernels", nargs="+", default=None,
                    help="kernel ids or names (default: whole zoo)")
    ap.add_argument("--engines", nargs="+", default=None,
                    help="engine names (default: all registered)")
    ap.add_argument("--bucket", type=parse_bucket, default=(64, 64),
                    metavar="QxR", help="bucket shape (default 64x64)")
    ap.add_argument("--batch", type=int, default=4,
                    help="batch size; 0 means single-pair plans")
    ap.add_argument("--rules", nargs="+", default=None, metavar="ID",
                    help="only these rule IDs/prefixes (e.g. R4 R101)")
    ap.add_argument("--ignore", nargs="+", default=None, metavar="ID",
                    help="drop these rule IDs/prefixes")
    ap.add_argument("--device", default=None,
                    help="device the options resolve for (default: cuda "
                         "when present, else cpu)")
    ap.add_argument("--no-hlo", action="store_true",
                    help="skip R303, which runs each point's program "
                         "once on the CPU")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON")
    ap.add_argument("--verbose", "-v", action="store_true",
                    help="include info-severity findings in text output")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    from repro_torch import analyze

    if args.list_rules:
        for rule in analyze.ALL_RULES:
            print(f"{rule.id}  {rule.severity:7s} {rule.scope:6s} "
                  f"{rule.title:14s} {rule.doc}")
        return 0

    kernels = None
    if args.kernels is not None:
        kernels = [int(k) if k.isdigit() else k for k in args.kernels]
    try:
        report = analyze.lint_all(
            kernels=kernels, engines=args.engines, bucket=args.bucket,
            batch_size=args.batch or None, rules=args.rules,
            ignore=args.ignore,
            config=analyze.LintConfig(device=args.device,
                                      hlo_rules=not args.no_hlo))
    except (ValueError, KeyError) as e:         # bad selector / kernel
        print(f"repro_torch.analyze: {e}", file=sys.stderr)
        return 2
    print(report.to_json() if args.json
          else report.format_text(verbose=args.verbose))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
