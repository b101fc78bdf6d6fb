"""Paper Appendix-A workloads (Tables 4-19) — the port of
``repro.configs.vision_workloads``, with the same draws.

Each entry is (model_id, feed, object-set).  The provided paper text includes
LP1-3, MP1-2, HP2-4 and HP6; the remaining 6 of the paper's 15 workloads
(MP3-6, HP1, HP5) are not printed in the appendix, so we *construct* them by
the paper's own §2 methodology: random 2-20-model subsets drawn from the same
model pool, sorted into potential-savings quartiles (see
``construct_missing``).  That keeps the LP/MP/HP class populations honest
without inventing data the paper withheld.
"""
from __future__ import annotations

import dataclasses
import random

from repro_torch.core.groups import potential_savings
from repro_torch.core.signatures import records_from_spec
from repro_torch.models.vision import SPEC_BUILDERS, get_spec

WORKLOADS: dict = {
    "LP1": [
        ("frcnn-r101", "A1", "people"), ("r101", "A1", "pcbt"),
        ("r50", "A2", "pcbt"), ("r152", "A3", "pv"), ("mnet", "A4", "pct"),
        ("yolo", "A5", "people"), ("tiny-yolo", "A1", "people"),
        ("ssd-vgg", "A6", "cars"), ("ssd-vgg", "A1", "cars"),
        ("ssd-mnet", "A5", "cars"), ("ssd-mnet", "A4", "cars"),
        ("ssd-mnet", "A6", "cars"), ("inception", "A3", "pv"),
    ],
    "LP2": [
        ("r152", "B1", "pv"), ("r101", "B2", "pcbt"), ("ssd-vgg", "B3", "people"),
    ],
    "LP3": [
        ("ssd-mnet", "B4", "cars"), ("frcnn-r101", "B3", "people"),
        ("r152", "B1", "pv"), ("r18", "B3", "pcbtm"), ("inception", "B1", "pv"),
    ],
    "MP1": [
        ("frcnn-r50", "B1", "cars"), ("frcnn-r50", "B1", "people"),
        ("r50", "B2", "pcbt"), ("r50", "B1", "pv"), ("r152", "B3", "pcbtm"),
        ("r152", "B4", "pcbt"), ("r18", "B5", "pcbt"), ("r18", "B4", "pcbt"),
        ("tiny-yolo", "B3", "cars"), ("tiny-yolo", "B2", "cars"),
        ("yolo", "B5", "cars"), ("yolo", "B1", "cars"),
        ("ssd-vgg", "B4", "cars"), ("ssd-vgg", "B3", "people"),
        ("inception", "B3", "pcbtm"),
    ],
    "MP2": [
        ("r50", "B3", "pcbtm"), ("r50", "B1", "pv"), ("r152", "B3", "pcbtm"),
        ("r18", "B5", "pcbt"), ("ssd-mnet", "B1", "cars"), ("ssd-mnet", "B2", "cars"),
    ],
    "HP2": [
        ("frcnn-r101", "B4", "cars"), ("frcnn-r101", "B5", "cars"),
        ("frcnn-r101", "B1", "cars"), ("frcnn-r101", "B2", "cars"),
        ("frcnn-r50", "B1", "people"), ("r50", "B3", "pcbtm"),
        ("r18", "B3", "pcbtm"), ("ssd-mnet", "B3", "people"),
        ("ssd-mnet", "B1", "people"), ("mnet", "B4", "pcbt"),
        ("yolo", "B3", "people"), ("tiny-yolo", "B5", "cars"),
        ("tiny-yolo", "B1", "people"), ("vgg", "B4", "pcbt"),
        ("inception", "B2", "pcbt"), ("inception", "B3", "pcbtm"),
    ],
    "HP3": [
        ("frcnn-r50", "A3", "cars"), ("frcnn-r50", "A3", "people"),
        ("frcnn-r50", "A1", "cars"), ("frcnn-r50", "A1", "people"),
        ("frcnn-r50", "A5", "cars"), ("frcnn-r50", "A5", "people"),
        ("frcnn-r50", "A2", "cars"), ("frcnn-r50", "A4", "cars"),
        ("frcnn-r50", "A2", "trucks"), ("frcnn-r101", "A3", "people"),
        ("yolo", "A3", "cars"), ("yolo", "A3", "people"),
        ("yolo", "A1", "people"), ("yolo", "A7", "buses"),
        ("yolo", "A7", "cars"), ("yolo", "A7", "people"),
        ("yolo", "A7", "trucks"), ("yolo", "A5", "trucks"),
        ("yolo", "A5", "people"), ("yolo", "A6", "cars"),
        ("r152", "A3", "pv"), ("r152", "A1", "pcbt"), ("r152", "A7", "pcbt"),
        ("r152", "A6", "cbt"), ("r152", "A2", "pcbt"), ("r152", "A4", "pct"),
        ("r50", "A3", "pv"), ("r50", "A7", "pcbt"), ("r50", "A6", "cbt"),
        ("r50", "A2", "pcbt"), ("r50", "A6", "cbt2"),
        ("ssd-vgg", "A3", "people"), ("ssd-vgg", "A1", "cars"),
        ("ssd-vgg", "A5", "people"), ("ssd-vgg", "A6", "cars"),
        ("ssd-vgg", "A4", "cars"), ("vgg", "A2", "pcbt"), ("r18", "A2", "pcbt"),
    ],
    "HP4": [
        ("yolo", "B1", "cars"), ("yolo", "B5", "cars"),
        ("tiny-yolo", "B2", "cars"), ("tiny-yolo", "B1", "cars"),
        ("tiny-yolo", "B3", "people"), ("ssd-vgg", "B5", "cars"),
        ("ssd-vgg", "B3", "people"), ("ssd-mnet", "B5", "cars"),
        ("ssd-mnet", "B3", "people"), ("ssd-mnet", "B2", "cars"),
        ("ssd-mnet", "B1", "people"), ("mnet", "B3", "pcbtm"),
        ("mnet", "B5", "pcbt"), ("r152", "B4", "pcbt"),
        ("r152", "B3", "pcbtm"), ("r152", "B1", "pv"),
    ],
    "HP6": [
        ("frcnn-r50", "A3", "cars"), ("frcnn-r50", "A3", "people"),
        ("frcnn-r50", "A1", "cars"), ("frcnn-r50", "A1", "people"),
        ("frcnn-r50", "A5", "cars"), ("frcnn-r50", "A5", "people"),
        ("frcnn-r50", "A2", "cars"), ("frcnn-r50", "A4", "cars"),
        ("frcnn-r50", "A2", "trucks"), ("frcnn-r101", "A3", "people"),
        ("yolo", "A3", "cars"), ("yolo", "A3", "people"),
        ("yolo", "A1", "people"), ("yolo", "A7", "buses"),
        ("yolo", "A7", "cars"), ("yolo", "A7", "people"),
        ("r101", "A1", "pcbt"), ("r101", "A7", "pcbt"), ("r101", "A6", "cbt"),
        ("r101", "A1", "pcbt2"), ("r152", "A3", "pv"), ("r152", "A1", "pcbt"),
        ("r152", "A7", "pcbt"), ("r152", "A6", "cbt"), ("r152", "A2", "pcbt"),
        ("r152", "A4", "pct"), ("r50", "A3", "pv"), ("r50", "A7", "pcbt"),
        ("r50", "A6", "cbt"), ("r50", "A2", "pcbt"), ("r50", "A6", "cbt2"),
        ("tiny-yolo", "A1", "people"), ("tiny-yolo", "A5", "people"),
        ("inception", "A3", "pv"), ("inception", "A1", "pcbt"),
        ("inception", "A7", "pcbt"), ("inception", "A6", "cbt"),
        ("inception", "A4", "pct"), ("vgg", "A2", "pcbt"),
        ("r18", "A2", "pcbt"), ("r18", "A2", "pcbt2"), ("r18", "A2", "pcbt3"),
    ],
}


def workload_records(name: str):
    """Layer records for every model instance in a workload (instances get
    unique ids ``<model>#<k>``)."""
    recs = []
    for k, (mid, feed, obj) in enumerate(WORKLOADS[name]):
        spec = get_spec(mid)
        recs.extend(
            dataclasses.replace(r, model_id=f"{mid}#{k}")
            for r in records_from_spec(spec)
        )
    return recs


def instance_ids(name: str) -> list:
    return [f"{mid}#{k}" for k, (mid, feed, obj) in enumerate(WORKLOADS[name])]


def construct_missing(seed: int = 17) -> dict:
    """Build stand-ins for the 6 appendix workloads missing from the provided
    text, via the paper's §2 methodology: enumerate random 2-20-model
    workloads, score potential savings, pick from the right quartile."""
    rng = random.Random(seed)
    pool = list(SPEC_BUILDERS.keys())
    feeds = [f"B{i}" for i in range(1, 6)]
    objs = ["cars", "people", "pcbt"]
    candidates = []
    for _ in range(200):
        n = rng.randint(2, 20)
        models = [(rng.choice(pool), rng.choice(feeds), rng.choice(objs)) for _ in range(n)]
        recs = []
        for k, (mid, f, o) in enumerate(models):
            recs.extend(
                dataclasses.replace(r, model_id=f"{mid}#{k}")
                for r in records_from_spec(get_spec(mid))
            )
        frac = potential_savings(recs)["fraction_saved"]
        candidates.append((frac, models))
    candidates.sort(key=lambda c: c[0])
    n = len(candidates)
    picks = {
        "MP3": candidates[int(0.35 * n)][1],
        "MP4": candidates[int(0.45 * n)][1],
        "MP5": candidates[int(0.55 * n)][1],
        "MP6": candidates[int(0.65 * n)][1],
        "HP1": candidates[int(0.85 * n)][1],
        "HP5": candidates[int(0.92 * n)][1],
    }
    return picks


def all_workloads(include_constructed: bool = True) -> dict:
    out = dict(WORKLOADS)
    if include_constructed:
        out.update(construct_missing())
    return out


def workload_class(name: str) -> str:
    return name[:2]
