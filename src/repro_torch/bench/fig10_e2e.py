"""Paper Fig 10 (the port of ``benchmarks/fig10_e2e.py``): end-to-end
accuracy — GEMEL against time/space sharing alone across memory settings.
Paper: median improvements 8.0% (LP), 13.5% (MP), 39.1% (HP) at 'min';
benefits shrink as memory grows.

    PYTHONPATH=src python -m repro_torch.bench.fig10_e2e

Host only: GEMEL's groups come from ``gemel_scale.surrogate_merge``, both
lanes run through the workload simulator on the paper's cost model.  As in
the reference, the GEMEL lane's ``Scheduler`` takes its default
merging-aware order, the time/space lane ``merged=False``."""
from __future__ import annotations

from typing import Optional

from repro_torch.bench.common import emit
from repro_torch.bench.fig3_nexus import _run
from repro_torch.bench.gemel_scale import surrogate_merge
from repro_torch.configs.vision_workloads import WORKLOADS, workload_class
from repro_torch.serving.profiler import profile_workload
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.simulator import simulate
from repro_torch.serving.workload import build_instances, memory_settings, workload_costs


def _gemel(name, cap, groups, sla_ms=100.0, fps=30.0, workloads: Optional[dict] = None):
    """The GEMEL lane: the committed ``groups`` shared, the profiler's batch
    sizes, 20 s of simulated frames."""
    costs = workload_costs(name, workloads)
    insts = build_instances(name, merged="groups", shared_groups=groups, workloads=workloads)
    sched = Scheduler(insts, cap, costs)
    order = [i.instance_id for i in sched.order]
    cbi = {i.instance_id: costs[i.model_id] for i in sched.order}
    swap = sched.cycle_swap_bytes({i: 1 for i in order})
    prof = profile_workload(order, cbi, swap, sla_ms=sla_ms)
    sched = Scheduler(insts, cap, costs)
    return simulate(sched, prof.batch_sizes, horizon_ms=20_000.0, fps=fps, sla_ms=sla_ms)


def run(workloads: Optional[dict] = None) -> dict:
    rows = []
    med = {}
    for name in workloads or WORKLOADS:
        ms = memory_settings(name, workloads)
        merged_groups = surrogate_merge(name, workloads=workloads).committed_groups
        for setting in ["min", "50%", "75%"]:
            cap = ms[setting]
            nexus = _run(name, cap, merged="none", workloads=workloads)
            gem = _gemel(name, cap, merged_groups, workloads=workloads)
            delta = gem.overall_accuracy - nexus.overall_accuracy
            rows.append({
                "workload": name, "class": workload_class(name),
                "memory": setting,
                "nexus_acc": nexus.overall_accuracy,
                "gemel_acc": gem.overall_accuracy,
                "improvement": delta,
                "nexus_swap_ms": nexus.swap_ms_total,
                "gemel_swap_ms": gem.swap_ms_total,
            })
            med.setdefault((workload_class(name), setting), []).append(delta)

    def _median(v):
        s = sorted(v)
        return s[len(s) // 2]

    derived = {f"median_{c}_{m}": _median(v) for (c, m), v in sorted(med.items())}
    derived["paper"] = "min: LP +8.0% MP +13.5% HP +39.1%; shrinks with memory"
    return emit("fig10_e2e", rows, derived)


if __name__ == "__main__":
    run()
