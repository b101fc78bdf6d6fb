"""Paper Fig 12 (the port of ``benchmarks/fig12_baselines.py``): GEMEL
against Optimal (the accuracy-ignoring upper bound) and Mainstream (stem
sharing).  Paper: GEMEL within 9.3-29.0% of Optimal and 5.9-52.3% larger
than Mainstream.

    PYTHONPATH=src python -m repro_torch.bench.fig12_baselines
"""
from __future__ import annotations

from typing import Optional

from repro_torch.bench.common import emit
from repro_torch.bench.gemel_scale import mainstream_savings, records, surrogate_merge
from repro_torch.configs.vision_workloads import WORKLOADS
from repro_torch.core.groups import potential_savings


def run(workloads: Optional[dict] = None) -> dict:
    rows = []
    for name in workloads or WORKLOADS:
        opt = potential_savings(records(name, workloads))["fraction_saved"]
        gem = surrogate_merge(name, workloads=workloads).fraction_saved
        ms = mainstream_savings(name, workloads)["fraction_saved"]
        rows.append({
            "workload": name,
            "optimal_pct": 100 * opt,
            "gemel_pct": 100 * gem,
            "mainstream_pct": 100 * ms,
            "gap_to_optimal_pct": 100 * (opt - gem),
            "gemel_minus_mainstream_pct": 100 * (gem - ms),
        })
    gaps = [r["gap_to_optimal_pct"] for r in rows]
    deltas = [r["gemel_minus_mainstream_pct"] for r in rows]
    return emit("fig12_baselines", rows, {
        "gap_to_optimal_range": f"{min(gaps):.1f}-{max(gaps):.1f}% (paper 9.3-29.0%)",
        "vs_mainstream_range": f"{min(deltas):.1f}-{max(deltas):.1f}% (paper 5.9-52.3%)",
    })


if __name__ == "__main__":
    run()
