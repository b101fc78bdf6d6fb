"""Per-model serving cost model (the port of ``repro.serving.costs``).

Calibrated from the paper's Tables 1-2 (load/run memory and time on the
edge GPU), reproduced verbatim.  For models not in the tables (e.g. r18,
r101, ssd-mnet, frcnn-r50) costs are interpolated from parameter counts
against same-family anchors.  The scheduler reads activation memory from
it and the simulator and profiler its run times: these are the paper's
cost model, not measurements of the card the port runs on.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

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

# family anchor used to scale unlisted models by parameter ratio
_FAMILY_ANCHOR = {
    "resnet": "r50", "vgg": "vgg", "yolo": "yolo", "ssd": "ssd-vgg",
    "frcnn": "frcnn-r101", "inception": "inception", "mobilenet": "tiny-yolo",
}


@dataclasses.dataclass(frozen=True)
class ModelCosts:
    model_id: str
    load_gb: float
    run_gb: dict  # batch -> GB (includes load)
    load_ms: float
    run_ms: dict  # batch -> ms

    def run_time(self, batch: int) -> float:
        if batch in self.run_ms:
            return self.run_ms[batch]
        # linear interpolation / extrapolation on known batch points
        ks = sorted(self.run_ms)
        lo = max([k for k in ks if k <= batch], default=ks[0])
        hi = min([k for k in ks if k >= batch], default=ks[-1])
        if lo == hi:
            per = self.run_ms[ks[-1]] / ks[-1]
            return self.run_ms[ks[-1]] + per * (batch - ks[-1])
        w = (batch - lo) / (hi - lo)
        return self.run_ms[lo] * (1 - w) + self.run_ms[hi] * w

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


def default_spec_provider() -> Callable:
    """Default ``model_id -> layer-spec descriptor`` source (shared by
    ``costs_for`` interpolation and ``workload.build_instances``): the
    paper's vision-zoo descriptors, resolved through the workload-config
    layer so serving code never imports a concrete model family."""
    from repro_torch.configs.vision_workloads import get_spec

    return get_spec


def costs_for(model_id: str) -> ModelCosts:
    if model_id in _TABLES:
        lg, r1, r2, r4, lms, t1, t2, t4 = _TABLES[model_id]
        return ModelCosts(model_id, lg, {1: r1, 2: r2, 4: r4}, lms,
                          {1: t1, 2: t2, 4: t4})
    get_spec = default_spec_provider()
    spec = get_spec(model_id)
    anchor_id = _FAMILY_ANCHOR[spec.family]
    a = costs_for(anchor_id)
    ratio = spec.params / get_spec(anchor_id).params if anchor_id in _TABLES else 1.0
    return ModelCosts(
        model_id,
        a.load_gb * ratio,
        {k: a.load_gb * ratio + (v - a.load_gb) * ratio for k, v in a.run_gb.items()},
        a.load_ms * ratio,
        {k: v * max(ratio, 0.3) for k, v in a.run_ms.items()},
    )
