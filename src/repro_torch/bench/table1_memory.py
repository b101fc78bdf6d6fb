"""Paper Table 1 (the port of ``benchmarks/table1_memory.py``): per-model
load/run memory (GB) — the descriptor-derived parameter bytes and the
activation model against the paper's measured values.

    PYTHONPATH=src python -m repro_torch.bench.table1_memory
"""
from __future__ import annotations

from repro_torch.bench.common import emit
from repro_torch.models.vision import get_spec
from repro_torch.serving.costs import _TABLES, costs_for

MODELS = ["yolo", "r152", "r50", "vgg", "tiny-yolo", "frcnn-r101",
          "inception", "ssd-vgg", "r18", "r101", "mnet", "ssd-mnet",
          "frcnn-r50"]


def run() -> dict:
    rows = []
    for mid in MODELS:
        spec = get_spec(mid)
        c = costs_for(mid)
        paper = _TABLES.get(mid)
        rows.append({
            "model": mid,
            "params_M": spec.params / 1e6,
            "spec_load_gb": spec.bytes / 1e9,
            "cost_load_gb": c.load_gb,
            "run_bs1_gb": c.run_mem(1),
            "run_bs4_gb": c.run_mem(4),
            "paper_load_gb": paper[0] if paper else "",
        })
    return emit("table1_memory", rows)


if __name__ == "__main__":
    run()
