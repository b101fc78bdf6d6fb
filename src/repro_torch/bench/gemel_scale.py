"""Workload-scale GEMEL merging model (the port of
``benchmarks/gemel_scale.py``).

The paper's models are 4-180M-parameter CNNs that are not jointly retrained
at full scale here.  The *merging engine* is exercised for real at reduced
scale (``bench.fig7_sharing_accuracy``); at workload scale the same planner
runs with a POSITION-THRESHOLD surrogate trainer: a per-model shared-layer
budget (``CAP_BY_TARGET``) prunes the models a group would take over it.
This encodes the paper's observation that late, memory-heavy layers merge
without accuracy loss while early-layer sharing breaks accuracy (Fig 7).

Also implements the Mainstream (stem-sharing) baseline: models share a
contiguous signature prefix, with the freeze fraction task-dependent
(classifiers tolerate deeper freezing than detectors — paper §6.1).

Every function takes ``workloads`` ({name: [(model_id, feed, objects)]},
default the paper's printed Appendix-A workloads); its arithmetic is the
reference's, in the reference's order, so the results are equal to the
last bit.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional

from repro_torch.configs.vision_workloads import WORKLOADS
from repro_torch.core.groups import LayerGroup, enumerate_groups
from repro_torch.core.signatures import records_from_spec
from repro_torch.models.vision import get_spec

# Per-model shared-layer budget, from the paper's Fig 7: the accuracy
# 'breaking point' at a 95% target is 5-25 shared layers per model pair;
# looser targets tolerate more sharing (Table 3: savings grow at 80%).
CAP_BY_TARGET = {0.99: 8, 0.95: 18, 0.90: 28, 0.80: 45}
EPOCH_MINUTES = 35.0  # paper: ~35 min/epoch for a 2-model FRCNN retrain


@dataclasses.dataclass
class ScaleEvent:
    minutes: float
    saved_bytes: int
    cumulative_saved: int
    shipped_bytes: int


@dataclasses.dataclass
class ScaleResult:
    committed_groups: list
    events: list
    baseline_bytes: int
    saved_bytes: int

    @property
    def fraction_saved(self) -> float:
        return self.saved_bytes / max(self.baseline_bytes, 1)


def records(name: str, workloads: Optional[dict] = None) -> list:
    """Layer records of every model instance of a workload (instance ids
    ``<model>#<k>``)."""
    recs = []
    for k, (mid, feed, obj) in enumerate((workloads or WORKLOADS)[name]):
        recs.extend(dataclasses.replace(r, model_id=f"{mid}#{k}")
                    for r in records_from_spec(get_spec(mid)))
    return recs


def surrogate_merge(name: str, accuracy_target: float = 0.95,
                    workloads: Optional[dict] = None) -> ScaleResult:
    cap = CAP_BY_TARGET[accuracy_target]
    recs = records(name, workloads)
    baseline = sum(r.bytes for r in recs)
    groups = enumerate_groups(recs)
    committed, events = [], []
    t = 0.0
    cum = 0
    shared_count: Counter = Counter()  # model -> shared layers so far
    model_bytes: Counter = Counter()
    for r in recs:
        model_bytes[r.model_id] += r.bytes

    for g in groups:
        while True:
            # only columns with >=2 members actually share
            active = [r for col in g.columns() if len(col) >= 2 for r in col]
            if len(active) < 2:
                break
            counts = Counter(r.model_id for r in active)
            over = {m for m, c in counts.items() if shared_count[m] + c > cap}
            # retraining cost: epochs scale with how close models are to
            # their budget (the paper's convergence slowdown near breaking
            # point); more models in the group => slower epochs
            stress = max((shared_count[m] + counts[m]) / cap for m in counts)
            epochs = 1 + round(6 * min(stress, 1.0))
            t += epochs * EPOCH_MINUTES * (len(counts) / 2.0) * 0.2
            if not over:
                gg = LayerGroup(g.signature, active)
                committed.append(gg)
                cum += gg.savings
                shared_count.update(counts)
                events.append(ScaleEvent(t, gg.savings, cum,
                                         sum(model_bytes[m] for m in counts)))
                break
            # prune over-budget models (early-failure path) and retry
            g = g.without_models(over)
            if len(g.records) < 2:
                break
    return ScaleResult(committed, events, baseline, cum)


# -- Mainstream (stem sharing) baseline --------------------------------------

FREEZE_FRACTION = {"classification": 0.6, "detection": 0.15}


def mainstream_savings(name: str, workloads: Optional[dict] = None) -> dict:
    """Share the longest common signature *prefix* across each model group,
    truncated at the task-dependent freeze point."""
    wl = (workloads or WORKLOADS)[name]
    per_model = []
    for k, (mid, feed, obj) in enumerate(wl):
        spec = get_spec(mid)
        cutoff = FREEZE_FRACTION[spec.task]
        frozen = [l for i, l in enumerate(spec.layers)
                  if i / max(len(spec.layers), 1) < cutoff]
        per_model.append((f"{mid}#{k}", [l.signature for l in frozen],
                          [l.bytes for l in frozen]))
    baseline = sum(l.bytes for mid, feed, obj in wl for l in get_spec(mid).layers)

    # group models by identical frozen-prefix signatures (pairwise longest
    # common prefix); greedy clustering on exact prefix match
    saved = 0
    seen_prefixes: dict = {}
    for iid, sigs, bys in per_model:
        # find the longest already-seen prefix that matches
        best = 0
        for plen in range(len(sigs), 0, -1):
            if tuple(sigs[:plen]) in seen_prefixes:
                best = plen
                break
        saved += sum(bys[:best])
        for plen in range(1, len(sigs) + 1):
            seen_prefixes.setdefault(tuple(sigs[:plen]), iid)
    return {"baseline_bytes": baseline, "saved_bytes": saved,
            "fraction_saved": saved / max(baseline, 1)}
