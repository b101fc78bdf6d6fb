"""Paper Fig 9 / Observation O1 (the port of
``benchmarks/fig9_powerlaw.py``): power-law per-layer memory; heavy
hitters near the END of vision DNNs.

    PYTHONPATH=src python -m repro_torch.bench.fig9_powerlaw
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import emit
from repro_torch.core.memory import cumulative_layer_memory, heavy_hitter_stats
from repro_torch.core.signatures import records_from_spec
from repro_torch.models.vision import get_spec

MODELS = ["frcnn-r101", "vgg", "yolo", "r152", "r50", "inception", "ssd-vgg",
          "mnet"]


def run() -> dict:
    rows = []
    for mid in MODELS:
        recs = records_from_spec(get_spec(mid))
        hh = heavy_hitter_stats(recs, top_frac=0.15)
        cum = cumulative_layer_memory(recs)
        half_mem_layer = float(np.searchsorted(cum, 0.5) / len(cum))
        rows.append({
            "model": mid,
            "n_layers": hh["n_layers"],
            "top15pct_mem_share": 100 * hh["top_mem_fraction"],
            "heavy_mean_position": hh["mean_position"],
            "layer_pos_at_50pct_mem": half_mem_layer,
        })
    shares = [r["top15pct_mem_share"] for r in rows]
    pos = [r["heavy_mean_position"] for r in rows]
    return emit("fig9_powerlaw", rows, {
        "top15_share_range": f"{min(shares):.0f}-{max(shares):.0f}%",
        "paper": "57-90% of memory in <15% of layers, toward model end",
        "mean_heavy_position": float(np.mean(pos)),
    })


if __name__ == "__main__":
    run()
