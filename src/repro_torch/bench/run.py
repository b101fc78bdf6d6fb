"""Runs the port's benches one after another (the port of
``benchmarks/run.py``).

    PYTHONPATH=src python -m repro_torch.bench.run [--fast] [--only NAME] [--device cuda|cpu]

``--fast`` skips the retraining-based fig7.  ``--device`` (default
``cuda``) goes to every bench that touches a device; the paper's figure
and table benches other than fig7 and fig14's plan-wire lane are host
arithmetic.  Each bench writes ``artifacts/torch/<name>.json``;
``roofline`` reads the dry run's cells (``python -m
repro_torch.launch.dryrun``).  The reference's ``mixed_zoo``, which
``benchmarks/run.py`` does not list, runs as ``python -m
repro_torch.bench.mixed_zoo``.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time
import traceback

# (name, whether its run() takes the device), in the reference's order
BENCHES = (
    ("table1_memory", False),
    ("table2_times", False),
    ("fig3_nexus", False),
    ("fig4_commonality", False),
    ("fig5_potential", False),
    ("fig9_powerlaw", False),
    ("fig10_e2e", False),
    ("fig11_savings", False),
    ("fig12_baselines", False),
    ("fig13_incremental", False),
    ("fig14_bandwidth", True),
    ("table3_sweeps", False),
    ("serve_throughput", True),
    ("plan_search", True),
    ("lm_merging", True),
    ("decode_serve", True),
    ("drift_adapt", True),
    ("overload", True),
    ("ablation_ordering", False),
    ("roofline", False),
    ("shard_serve", True),
)


def modules(fast: bool) -> list:
    """[(name, (module, takes_device))] in run order; fig7 (minutes of
    retraining on the CPU) goes after fig9 unless ``fast``."""
    names = list(BENCHES)
    if not fast:
        names.insert(6, ("fig7_sharing_accuracy", True))
    return [(n, (importlib.import_module(f"repro_torch.bench.{n}"), dev)) for n, dev in names]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)

    failures = []
    for name, (mod, takes_device) in modules(args.fast):
        if args.only and name != args.only:
            continue
        t0 = time.monotonic()
        try:
            if takes_device:
                mod.run(device=args.device)
            else:
                mod.run()
            print(f"# [{name}] ok in {time.monotonic() - t0:.1f}s")
        except Exception as e:  # noqa: BLE001 — report every bench, then fail
            failures.append(name)
            print(f"# [{name}] FAILED: {e}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} benchmark(s) failed: {failures}")
        sys.exit(1)
    print("\nall benchmarks ok")


if __name__ == "__main__":
    main()
