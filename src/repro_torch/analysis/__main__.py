"""CLI: ``python -m repro_torch.analysis`` — the port's gate and lint loop.

Exit code 0 iff every check passed: no unsuppressed findings, no parse
errors, (with ``--strict``) no pragma-hygiene findings, and (with
``--contracts``/``--contracts-only``) no kernel-contract failures.  The
contract lane runs on ``--device meta`` (shapes and dtypes, any host) or
``--device cuda`` (the Hopper kernels on the card).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.engine import all_rules, analyze_paths, render_json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static invariant checker")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyze (default: src/repro_torch)")
    ap.add_argument("--strict", action="store_true",
                    help="pragma hygiene also gates: every suppression "
                         "needs a reason, a known rule id, and a finding")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--rules", help="comma-separated rule ids to run")
    ap.add_argument("--contracts", action="store_true",
                    help="also run the kernel-contract checker")
    ap.add_argument("--contracts-only", action="store_true",
                    help="only the kernel-contract checker")
    ap.add_argument("--device", choices=("meta", "cuda"), default="meta",
                    help="the contract checker's device (default meta)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in sorted(all_rules().values(), key=lambda r: r.id):
            print(f"{r.id}  {r.title}")
            print(f"      invariant: {r.invariant}")
            print(f"      origin:    {r.origin}")
        return 0

    contracts = None
    if args.contracts or args.contracts_only:
        from repro_torch.analysis.contracts import run_contracts

        contracts = run_contracts(device=args.device)

    if args.contracts_only:
        if args.json:
            print(json.dumps(contracts, indent=2))
        else:
            print(f"contracts: {contracts['checks']} checks on device "
                  f"{contracts['device']}")
            for msg in contracts["failures"]:
                print(f"  FAIL {msg}")
            if not contracts["failures"]:
                print("  all kernel contracts hold")
        return 0 if not contracts["failures"] else 1

    rules = args.rules.split(",") if args.rules else None
    report = analyze_paths(paths=args.paths or None, rules=rules)

    if args.json:
        print(render_json(report, args.strict, contracts))
    else:
        gating = report.gating(args.strict)
        for f in gating:
            print(f.format())
        for e in report.parse_errors:
            print(f"parse error: {e}")
        summary = (f"{report.files_scanned} files, "
                   f"{len(gating)} finding(s), "
                   f"{len(report.suppressed)} suppressed")
        if contracts is not None:
            summary += (f"; contracts: {len(contracts['failures'])} "
                        f"failure(s) over {contracts['checks']} checks on "
                        f"{contracts['device']}")
            for msg in contracts["failures"]:
                print(f"  FAIL {msg}")
        print(summary)

    ok = report.ok(args.strict) and not (contracts or {}).get("failures")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
