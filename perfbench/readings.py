#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from: the program's
numbers over many seeds and, on some of them, the control's (the reference
in fp8, put in the program's place and read at the same prompts and
tokens).

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds 8 [--out FILE]

Each seed is a whole run of the cell (its set-up, a short window at the
cell's own load, the check) in this one process; one JSON line per seed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench import common  # noqa: E402

common.put_src_on_path()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import run_cell

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        res = run_cell(args.workload, seed, args.seconds, False, control=seed in controls)
        line = {"workload": args.workload, "seed": seed, "correct": res["correct"],
                "numbers": {k: v["value"] for k, v in res["compared"].items()},
                "control": res.get("control"), "attempted": res["attempted"],
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
