"""Paper Table 2 (the port of ``benchmarks/table2_times.py``): per-model
load/run times — cost-model values with the batch-size interpolation the
profiler relies on, and the load:run ratio that motivates merging
(0.98-34.4x in the paper).

    PYTHONPATH=src python -m repro_torch.bench.table2_times
"""
from __future__ import annotations

from repro_torch.bench.common import emit
from repro_torch.serving.costs import _TABLES, costs_for


def run() -> dict:
    rows = []
    for mid in _TABLES:
        c = costs_for(mid)
        rows.append({
            "model": mid,
            "load_ms": c.load_ms,
            "run_bs1_ms": c.run_time(1),
            "run_bs2_ms": c.run_time(2),
            "run_bs4_ms": c.run_time(4),
            "run_bs8_ms": c.run_time(8),
            "load_over_run": c.load_ms / c.run_time(1),
        })
    ratios = [r["load_over_run"] for r in rows]
    return emit("table2_times", rows, {
        "load_run_ratio_min": min(ratios),
        "load_run_ratio_max": max(ratios),
        "paper_range": "0.98-34.4x",
    })


if __name__ == "__main__":
    run()
