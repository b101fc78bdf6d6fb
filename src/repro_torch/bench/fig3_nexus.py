"""Paper Fig 3 (motivation; the port of ``benchmarks/fig3_nexus.py``):
time/space sharing ALONE — accuracy relative to the all-resident setting
drops as memory shrinks (paper: up to 43% drop, 19-84% of frames skipped).

    PYTHONPATH=src python -m repro_torch.bench.fig3_nexus

Host only: the paper's Table 1/2 cost model through the workload
simulator, no device.  ``run(workloads=)`` takes the workloads to sweep
(default the paper's printed Appendix-A ones, as the reference)."""
from __future__ import annotations

from typing import Optional

from repro_torch.bench.common import emit
from repro_torch.configs.vision_workloads import WORKLOADS, workload_class
from repro_torch.serving.profiler import profile_workload
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.simulator import simulate
from repro_torch.serving.workload import build_instances, memory_settings, workload_costs

HORIZON_MS = 20_000.0


def _run(name, cap, merged="none", sla_ms=100.0, fps=30.0, horizon=HORIZON_MS,
         accuracies=None, workloads: Optional[dict] = None):
    """One simulated run of workload ``name`` at capacity ``cap``: the
    profiler's batch sizes for the scheduler's cycle, then the simulator."""
    costs = workload_costs(name, workloads)
    insts = build_instances(name, merged=merged, accuracies=accuracies, workloads=workloads)
    sched = Scheduler(insts, cap, costs, merged=(merged != "none"))
    order = [i.instance_id for i in sched.order]
    cost_by_inst = {i.instance_id: costs[i.model_id] for i in sched.order}
    swap = sched.cycle_swap_bytes({i: 1 for i in order})
    prof = profile_workload(order, cost_by_inst, swap, sla_ms=sla_ms)
    sched = Scheduler(insts, cap, costs, merged=(merged != "none"))
    return simulate(sched, prof.batch_sizes, horizon_ms=horizon, fps=fps, sla_ms=sla_ms)


def run(workloads: Optional[dict] = None) -> dict:
    rows = []
    for name in workloads or WORKLOADS:
        ms = memory_settings(name, workloads)
        base = _run(name, ms["max"], workloads=workloads)
        for setting in ["min", "50%", "75%"]:
            res = _run(name, ms[setting], workloads=workloads)
            rows.append({
                "workload": name,
                "class": workload_class(name),
                "memory": setting,
                "accuracy": res.overall_accuracy,
                "relative_to_max": res.overall_accuracy / max(base.overall_accuracy, 1e-9),
                "skipped_frac": 1 - res.processed_fraction,
            })
    drops = [1 - r["relative_to_max"] for r in rows]
    skips = [r["skipped_frac"] for r in rows]
    return emit("fig3_nexus", rows, {
        "max_accuracy_drop_pct": 100 * max(drops),
        "skipped_range_pct": f"{100*min(skips):.0f}-{100*max(skips):.0f}",
        "paper": "drops up to 43%; 19-84% frames skipped",
    })


if __name__ == "__main__":
    run()
