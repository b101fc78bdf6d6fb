"""Paper Table 3 (the port of ``benchmarks/table3_sweeps.py``): GEMEL's
accuracy win over time/space sharing under varied accuracy targets
(95% -> 80% grows savings), FPS (30 -> 10 shrinks wins) and SLA (100 ms is
more swap-sensitive than 400 ms), on one representative workload a class.

    PYTHONPATH=src python -m repro_torch.bench.table3_sweeps
"""
from __future__ import annotations

from typing import Optional

from repro_torch.bench.common import emit
from repro_torch.bench.fig3_nexus import _run
from repro_torch.bench.fig10_e2e import _gemel
from repro_torch.bench.gemel_scale import surrogate_merge
from repro_torch.serving.workload import memory_settings

REP = {"LP": "LP3", "MP": "MP2", "HP": "HP4"}


def run(workloads: Optional[dict] = None) -> dict:
    rows = []
    for cls, name in REP.items():
        cap = memory_settings(name, workloads)["min"]
        for variant, (target, fps, sla) in {
            "default": (0.95, 30.0, 100.0),
            "80pct_accuracy": (0.80, 30.0, 100.0),
            "10fps": (0.95, 10.0, 100.0),
            "400ms_sla": (0.95, 30.0, 400.0),
        }.items():
            groups = surrogate_merge(name, accuracy_target=target,
                                     workloads=workloads).committed_groups
            nexus = _run(name, cap, merged="none", sla_ms=sla, fps=fps, workloads=workloads)
            gem = _gemel(name, cap, groups, sla_ms=sla, fps=fps, workloads=workloads)
            rows.append({
                "class": cls, "workload": name, "variant": variant,
                "nexus_acc": nexus.overall_accuracy,
                "gemel_acc": gem.overall_accuracy,
                "win": gem.overall_accuracy - nexus.overall_accuracy,
            })
    return emit("table3_sweeps", rows, {
        "paper": "wins grow at 80% target and tighter SLA; shrink at 10 FPS",
    })


if __name__ == "__main__":
    run()
