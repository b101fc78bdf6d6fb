"""Paper Fig 13 (the port of ``benchmarks/fig13_incremental.py``): memory
savings over time during incremental merging — the memory-forward
heuristic reaps most savings early (paper: >=70% of savings within 24-210
min).

    PYTHONPATH=src python -m repro_torch.bench.fig13_incremental
"""
from __future__ import annotations

from typing import Optional

from repro_torch.bench.common import emit
from repro_torch.bench.gemel_scale import surrogate_merge
from repro_torch.configs.vision_workloads import WORKLOADS, workload_class


def run(workloads: Optional[dict] = None) -> dict:
    rows = []
    for name in workloads or WORKLOADS:
        r = surrogate_merge(name, workloads=workloads)
        if not r.events:
            continue
        total = r.events[-1].cumulative_saved
        t70 = next((e.minutes for e in r.events if e.cumulative_saved >= 0.7 * total),
                   r.events[-1].minutes)
        frac_at_60min = max(
            (e.cumulative_saved for e in r.events if e.minutes <= 60), default=0
        ) / max(total, 1)
        rows.append({
            "workload": name,
            "class": workload_class(name),
            "total_minutes": r.events[-1].minutes,
            "minutes_to_70pct": t70,
            "savings_frac_at_60min": frac_at_60min,
            "n_commits": len(r.events),
        })
    t70s = [r["minutes_to_70pct"] for r in rows]
    return emit("fig13_incremental", rows, {
        "minutes_to_70pct_range": f"{min(t70s):.0f}-{max(t70s):.0f}",
        "paper": ">=70% of savings within 24-210 minutes",
    })


if __name__ == "__main__":
    run()
