#!/usr/bin/env python3
"""Find the highest rate a serve cell sustains, and set the cell's rate.

On the card (one process, one set-up, one window per rate):

    python3 perfbench/sweep.py --workload <cell> --rates 20,25,30 --seconds 15 \
        --seed 5 --out sweep_<cell>.jsonl

A rate is sustained when the backlog does not grow through the window: the
median latency of the last quarter of the requests (by due time) is at most
1.5 times that of the second quarter plus 50 ms, and every request
completes.  Then, where the cell's files are kept:

    python3 perfbench/sweep.py --apply sweep_<cell>.jsonl

writes 0.8 of the highest sustained rate into the cell's file as
``rate_per_s``, with the sweep under ``sweep``, and the same lines into
``PERF.md`` under "Rate sweeps".
"""
import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench import common  # noqa: E402

common.put_src_on_path()

SHARE = 0.8  # the cell runs at this share of the highest sustained rate
PERF_HEADING = "### Rate sweeps"


def sustained(latencies: list) -> bool:
    """(due s, latency s) of every request: no failures, and the last
    quarter's median latency within 1.5 x the second quarter's + 50 ms."""
    if not latencies or any(x == float("inf") for _, x in latencies):
        return False
    lat = [x for _, x in sorted(latencies)]
    q = max(1, len(lat) // 4)
    second, last = lat[q:2 * q] or lat[:q], lat[-q:]
    return statistics.median(last) <= 1.5 * statistics.median(second) + 0.05


def sweep(name: str, rates: list, seconds: float, seed: int, out) -> None:
    import torch

    from perfbench import harness, serve

    ctx = harness.make_context(name, seed, seconds, False)
    with torch.no_grad():
        harness.build(ctx)
        for rate in rates:
            ctx.cell["rate_per_s"] = rate
            serve.run(ctx)
            lat = ctx.latencies
            line = {"workload": name, "rate_per_s": rate, "seconds": seconds, "seed": seed,
                    "requests": len(lat), "sustained": sustained(lat),
                    "p50_ms": statistics.median(x for _, x in lat) * 1e3,
                    "p95_ms": ctx.e2e["serve_p95_ms"],
                    "card": torch.cuda.get_device_name(0)}
            print(json.dumps(line), flush=True)
            out.write(json.dumps(line) + "\n")
            out.flush()


def apply(path: str) -> None:
    lines = [json.loads(x) for x in open(path) if x.strip()]
    name = lines[0]["workload"]
    ok = [x["rate_per_s"] for x in lines if x["sustained"]]
    if not ok:
        raise SystemExit(f"{path}: no rate was sustained")
    rate = round(SHARE * max(ok), 1)
    cell_path = common.HERE / "workloads" / f"{name}.json"
    cell = json.loads(cell_path.read_text())
    cell["rate_per_s"] = rate
    cell["sweep"] = {"highest_sustained_per_s": max(ok), "share": SHARE,
                     "rates": [{k: x[k] for k in ("rate_per_s", "sustained", "p50_ms",
                                                  "p95_ms", "requests")} for x in lines]}
    cell_path.write_text(json.dumps(cell, indent=1) + "\n")
    rows = ", ".join(f"{x['rate_per_s']:g}/s {'kept' if x['sustained'] else 'grew'} "
                     f"(p95 {x['p95_ms']:.0f} ms)" for x in lines)
    text = (f"- `{name}` ({lines[0]['card']}, {lines[0]['seconds']:g} s windows, seed "
            f"{lines[0]['seed']}): {rows}; highest sustained {max(ok):g}/s, the cell runs "
            f"at {rate:g}/s.\n")
    perf = common.ROOT / "PERF.md"
    body = perf.read_text()
    if PERF_HEADING not in body:
        body = body.rstrip("\n") + f"\n\n{PERF_HEADING}\n\n"
    head, _, tail = body.partition(PERF_HEADING + "\n\n")
    perf.write_text(head + PERF_HEADING + "\n\n" + text + tail)
    print(text, end="")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload")
    ap.add_argument("--rates")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--out")
    ap.add_argument("--apply")
    args = ap.parse_args(argv)
    if args.apply:
        apply(args.apply)
        return 0
    with open(args.out, "a") as out:
        sweep(args.workload, [float(r) for r in args.rates.split(",")], args.seconds,
              args.seed, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
