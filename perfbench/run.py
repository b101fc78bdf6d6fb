#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The card's name and power limit open standard error.  The last (and only)
line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number the check compared, with
its limit.  The same numbers close standard error.  Without a CUDA device,
or with fewer than the cell asks for, it prints no result and exits 2.
"""
import os
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench import common  # noqa: E402

common.put_src_on_path()


def since_process_start() -> float:
    """Seconds since this process started (from /proc), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    t_process = T_START - since_process_start()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    chips = next(w["chips"] for w in common.benchmark()["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    print(json.dumps({"device": torch.cuda.get_device_name(0), "power_limit_w": power_limit()}),
          file=sys.stderr)

    from perfbench.harness import run_cell

    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_process=t_process)
    bad = common.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, v in out["compared"].items():
        print(f"compared {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


def power_limit():
    """The card's power limit in W as ``nvidia-smi`` reads it (None where it
    cannot)."""
    import subprocess

    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20)
        return float(got.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


if __name__ == "__main__":
    sys.exit(main())
