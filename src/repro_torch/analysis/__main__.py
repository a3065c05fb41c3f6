"""CLI for the static analysis suite: ``python -m repro_torch.analysis``.

Modes
-----
default            human-readable report of all three analyses
--check            same, but exit 1 if any ERROR finding (the gate)
--certificates P   additionally write per-algorithm overflow
                   certificates as JSON to path ``P``
--root DIR         lint this tree instead of the installed package

The report covers:
  1. the architecture linter over the source tree,
  2. the ``cuda`` kernels' launch checks (KC001-KC004) over every
     DEFAULT_CANDIDATES config x registry algorithm x representative
     workload,
  3. one overflow/bit-width certificate per registry algorithm
     (8/8-bit), including the plan-time safe-C_in bound.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__)
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero on any ERROR finding")
    ap.add_argument("--certificates", metavar="PATH", default=None,
                    help="write per-algorithm certificates JSON here")
    ap.add_argument("--root", metavar="DIR", default=None,
                    help="source tree to lint (default: installed "
                         "repro_torch)")
    ap.add_argument("--bits-act", type=int, default=8)
    ap.add_argument("--bits-weight", type=int, default=8)
    args = ap.parse_args(argv)

    from repro_torch.analysis import kernel_checks, lint, ranges

    errors = 0

    root = (pathlib.Path(args.root) if args.root is not None
            else lint.source_root())
    lint_findings = lint.run_lint(root)
    print(f"[lint] {root}: {len(lint_findings)} finding(s)")
    for f in lint_findings:
        print(f"  {f}")
    errors += sum(f.severity == kernel_checks.ERROR for f in lint_findings)

    kc_findings = kernel_checks.default_candidate_report(
        bits_act=args.bits_act, bits_weight=args.bits_weight)
    print(f"[kernel] default candidate sweep: "
          f"{len(kc_findings)} finding(s)")
    for f in kc_findings:
        print(f"  {f}")
    errors += sum(f.severity == kernel_checks.ERROR for f in kc_findings)

    certs = ranges.all_certificates(bits_act=args.bits_act,
                                    bits_weight=args.bits_weight)
    print(f"[ranges] {len(certs)} algorithm certificate(s) at "
          f"{args.bits_act}/{args.bits_weight} bits")
    hdr = (f"  {'algorithm':<12} {'kind':<9} {'tx_bits':>7} "
           f"{'prod_bits':>9} {'safe_cin':>9} {'acc_bits':>8} "
           f"{'exact_cin':>9}")
    print(hdr)
    for name in sorted(certs):
        c = certs[name]
        print(f"  {name:<12} {c.kind:<9} {c.transform_bits:>7} "
              f"{c.product_bits:>9} {c.safe_cin:>9} "
              f"{c.acc_bits_at_safe_cin:>8} {c.dequant_exact_cin:>9}")
        if not c.integer_transform:
            print(f"    note: non-integer B^T — transform bound uses "
                  f"exact L1 row norms ({c.bt_row_l1})")

    if args.certificates:
        out = pathlib.Path(args.certificates)
        out.write_text(json.dumps(
            {name: certs[name].to_json() for name in sorted(certs)},
            indent=2, sort_keys=True) + "\n", encoding="utf-8")
        print(f"[ranges] wrote {out}")

    if args.check and errors:
        print(f"FAILED: {errors} ERROR finding(s)")
        return 1
    print("OK" if not errors else f"{errors} ERROR finding(s) (advisory)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
