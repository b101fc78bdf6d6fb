"""Per-model serving cost model (the port of ``repro.serving.costs``, table
ids only).

Calibrated from the paper's Tables 1-2 (load/run memory and time on the
edge GPU), reproduced verbatim.  The scheduler reads activation memory from
it; interpolation for models outside the tables waits for a later slice.
"""
from __future__ import annotations

import dataclasses

PCIE_GBPS = 16.0  # effective host->GPU bandwidth used by the paper's numbers

# Paper Table 1 (GB) and Table 2 (ms): model -> (load_gb, run_gb@bs1,
# run_gb@bs2, run_gb@bs4, load_ms, run_ms@bs1, run_ms@bs2, run_ms@bs4)
_TABLES = {
    "yolo":       (0.242, 0.518, 0.728, 1.22, 49.5, 17.0, 24.0, 39.9),
    "r152":       (0.244, 0.648, 0.978, 1.71, 73.25, 24.81, 26.27, 26.70),
    "r50":        (0.118, 0.346, 0.498, 0.838, 27.1, 8.41, 8.50, 8.52),
    "vgg":        (0.536, 0.738, 0.890, 1.18, 72.2, 2.10, 2.23, 2.40),
    "tiny-yolo":  (0.042, 0.152, 0.180, 0.238, 6.7, 3.0, 3.5, 5.2),
    "frcnn-r101": (0.732, 3.70, 6.96, 12.47, 117.3, 115.4, 210.1, 379.4),
    "inception":  (0.120, 0.190, 0.228, 0.340, 11.8, 9.1, 9.1, 9.1),
    "ssd-vgg":    (0.106, 0.230, 0.328, 0.506, 16.1, 16.5, 25.7, 44.6),
}


@dataclasses.dataclass(frozen=True)
class ModelCosts:
    model_id: str
    load_gb: float
    run_gb: dict  # batch -> GB (includes load)
    load_ms: float
    run_ms: dict  # batch -> ms

    def run_mem(self, batch: int) -> float:
        if batch in self.run_gb:
            return self.run_gb[batch]
        ks = sorted(self.run_gb)
        lo = max([k for k in ks if k <= batch], default=ks[0])
        hi = min([k for k in ks if k >= batch], default=ks[-1])
        if lo == hi:
            per = (self.run_gb[ks[-1]] - self.load_gb) / ks[-1]
            return self.run_gb[ks[-1]] + per * (batch - ks[-1])
        w = (batch - lo) / (hi - lo)
        return self.run_gb[lo] * (1 - w) + self.run_gb[hi] * w

    def activation_gb(self, batch: int) -> float:
        return max(self.run_mem(batch) - self.load_gb, 0.0)


def costs_for(model_id: str) -> ModelCosts:
    """Cost rows of the paper's tables; raises KeyError for other ids."""
    lg, r1, r2, r4, lms, t1, t2, t4 = _TABLES[model_id]
    return ModelCosts(model_id, lg, {1: r1, 2: r2, 4: r4}, lms,
                      {1: t1, 2: t2, 4: t4})
