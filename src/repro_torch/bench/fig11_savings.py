"""Paper Fig 11 (the port of ``benchmarks/fig11_savings.py``): GEMEL's
final per-workload memory (parameter) reductions.  Paper: LP 17.5-33.9%,
MP 28.6-46.9%, HP 40.9-60.7%.

    PYTHONPATH=src python -m repro_torch.bench.fig11_savings
"""
from __future__ import annotations

from typing import Optional

from repro_torch.bench.common import emit
from repro_torch.bench.gemel_scale import surrogate_merge
from repro_torch.configs.vision_workloads import WORKLOADS, workload_class


def run(workloads: Optional[dict] = None) -> dict:
    rows = []
    by_class = {}
    for name in workloads or WORKLOADS:
        r = surrogate_merge(name, workloads=workloads)
        pct = 100 * r.fraction_saved
        rows.append({
            "workload": name,
            "class": workload_class(name),
            "saved_gb": r.saved_bytes / 1e9,
            "saved_pct": pct,
            "groups_committed": len(r.committed_groups),
        })
        by_class.setdefault(workload_class(name), []).append(pct)
    derived = {f"{c}_range_pct": f"{min(v):.1f}-{max(v):.1f}" for c, v in by_class.items()}
    derived["paper"] = "LP 17.5-33.9% MP 28.6-46.9% HP 40.9-60.7%"
    return emit("fig11_savings", rows, derived)


if __name__ == "__main__":
    run()
