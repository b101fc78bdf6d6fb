"""Paper Fig 5 (the port of ``benchmarks/fig5_potential.py``): potential
(Optimal) memory savings per workload when ALL architecturally identical
layers are shared across models (weights ignored).  Paper range:
17.9-86.4%.

    PYTHONPATH=src python -m repro_torch.bench.fig5_potential
"""
from __future__ import annotations

from typing import Optional

from repro_torch.bench.common import emit
from repro_torch.bench.gemel_scale import records
from repro_torch.configs.vision_workloads import WORKLOADS
from repro_torch.core.groups import potential_savings


def run(workloads: Optional[dict] = None) -> dict:
    rows = []
    for name, wl in (workloads or WORKLOADS).items():
        p = potential_savings(records(name, workloads))
        rows.append({
            "workload": name,
            "n_models": len(wl),
            "total_gb": p["total_bytes"] / 1e9,
            "saved_gb": p["saved_bytes"] / 1e9,
            "saved_pct": 100 * p["fraction_saved"],
        })
    pcts = [r["saved_pct"] for r in rows]
    return emit("fig5_potential", rows, {
        "range_pct": f"{min(pcts):.1f}-{max(pcts):.1f}",
        "paper": "17.9-86.4%",
    })


if __name__ == "__main__":
    run()
