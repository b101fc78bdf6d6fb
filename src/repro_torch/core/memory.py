"""Memory accounting (§3.1, §5.2; the port of ``repro.core.memory``).

* per-layer cumulative distributions (Fig 9 / power-law observation O1)
* load vs. run footprints (Table 1): run = params + activations(batch)
* workload totals and the min/50%/75% memory settings from §2.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

from repro_torch.core.signatures import LayerRecord

# Activation footprint model for the vision zoo: intermediates scale with the
# spatial resolution schedule; calibrated so Table-1 "run" columns land near
# the paper's measurements (run ≈ load + act_base * batch).  ``spec`` args
# are duck-typed descriptors (``family``/``bytes`` attrs) — core stays
# model-agnostic.
_ACT_BASE_GB = {
    "resnet": 0.11, "vgg": 0.10, "yolo": 0.17, "ssd": 0.07,
    "frcnn": 1.40, "inception": 0.04, "mobilenet": 0.03,
}


def activation_bytes(spec, batch: int) -> int:
    base = _ACT_BASE_GB.get(spec.family, 0.08)
    # sub-linear batch growth (allocator reuse), matching Table 1 ratios
    return int(base * 1e9 * (1 + 0.75 * (batch - 1)))


def load_bytes(spec) -> int:
    return spec.bytes


def run_bytes(spec, batch: int) -> int:
    return load_bytes(spec) + activation_bytes(spec, batch)


# ---------------------------------------------------------------------------
# Power-law / cumulative layer memory (Fig 9, observation O1)
# ---------------------------------------------------------------------------


def cumulative_layer_memory(records: list[LayerRecord]) -> np.ndarray:
    """Cumulative fraction of model memory, layer by layer start→end."""
    sizes = np.array([r.bytes for r in sorted(records, key=lambda r: r.position)],
                     dtype=np.float64)
    total = sizes.sum()
    return np.cumsum(sizes) / max(total, 1.0)


def heavy_hitter_stats(records: list[LayerRecord], top_frac: float = 0.15) -> dict:
    """What fraction of memory do the top ``top_frac`` heaviest layers hold,
    and where do they live in the model (0=start, 1=end)?"""
    recs = sorted(records, key=lambda r: -r.bytes)
    k = max(1, int(np.ceil(top_frac * len(recs))))
    top = recs[:k]
    total = sum(r.bytes for r in recs)
    return {
        "n_layers": len(recs),
        "top_k": k,
        "top_mem_fraction": sum(r.bytes for r in top) / max(total, 1),
        "mean_position": float(np.mean([r.position for r in top])),
    }


# ---------------------------------------------------------------------------
# Workload footprints (§2 memory settings)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorkloadMemory:
    """min / 50% / 75% memory settings for a workload (§2)."""

    min_bytes: int  # largest single model load+run at batch 1
    max_bytes: int  # all models resident + largest activation
    framework_bytes: int = int(0.8e9)  # PyTorch fixed cost (paper §3.1)

    @property
    def mid50(self) -> int:
        return self.max_bytes // 2

    @property
    def mid75(self) -> int:
        return (3 * self.max_bytes) // 4

    def setting(self, name: str) -> int:
        return {"min": self.min_bytes, "50%": self.mid50, "75%": self.mid75}[name]


def workload_memory(specs: Iterable, batch: int = 1) -> WorkloadMemory:
    specs = list(specs)
    per_model_run = [run_bytes(s, batch) for s in specs]
    min_bytes = max(per_model_run)
    max_bytes = sum(load_bytes(s) for s in specs) + max(
        activation_bytes(s, batch) for s in specs
    )
    return WorkloadMemory(min_bytes=min_bytes, max_bytes=max_bytes)
