"""Serving launcher (the port of ``repro.launch.serve``):

    PYTHONPATH=src python -m repro_torch.launch.serve --workload MP2 [--merged optimal] [--json]

Drives the merging-aware Nexus-variant scheduler over a paper workload
through the discrete-event simulator (the paper's Table-1/2 cost model).
Host arithmetic only: it touches no device, and its numbers are the cost
model's, not a card's.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.serving.profiler import profile_workload
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.simulator import simulate
from repro_torch.serving.workload import build_instances, memory_settings, workload_costs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", default="MP2")
    ap.add_argument("--memory", default="min", choices=["min", "50%", "75%", "max"])
    ap.add_argument("--merged", default="none", choices=["none", "optimal"])
    ap.add_argument("--sla-ms", type=float, default=100.0)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--horizon-s", type=float, default=30.0)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    cap = memory_settings(args.workload)[args.memory]
    costs = workload_costs(args.workload)
    insts = build_instances(args.workload, merged=args.merged)
    sched = Scheduler(insts, cap, costs, merged=(args.merged != "none"))
    order = [i.instance_id for i in sched.order]
    cost_by_inst = {i.instance_id: costs[i.model_id] for i in sched.order}
    swap = sched.cycle_swap_bytes({i: 1 for i in order})
    prof = profile_workload(order, cost_by_inst, swap, sla_ms=args.sla_ms)
    sched = Scheduler(insts, cap, costs, merged=(args.merged != "none"))
    res = simulate(sched, prof.batch_sizes, horizon_ms=args.horizon_s * 1000,
                   fps=args.fps, sla_ms=args.sla_ms)
    out = {
        "workload": args.workload,
        "memory": args.memory,
        "merged": args.merged,
        "capacity_gb": cap / 1e9,
        "overall_accuracy": res.overall_accuracy,
        "processed_fraction": res.processed_fraction,
        "swap_ms_total": res.swap_ms_total,
        "exec_ms_total": res.exec_ms_total,
        "batch_sizes": prof.batch_sizes,
    }
    if args.json:
        print(json.dumps(out, indent=2))
    else:
        print(f"workload={args.workload} mem={args.memory} merged={args.merged}")
        print(f"  capacity        {cap/1e9:.2f} GB")
        print(f"  accuracy        {res.overall_accuracy:.3f}")
        print(f"  processed frac  {res.processed_fraction:.3f}")
        print(f"  swap total      {res.swap_ms_total:.0f} ms")
        print(f"  exec total      {res.exec_ms_total:.0f} ms")


if __name__ == "__main__":
    main()
