"""Paper Fig 4 (the port of ``benchmarks/fig4_commonality.py``): % of
architecturally identical layers across model pairs (same model / same
family / cross family).

    PYTHONPATH=src python -m repro_torch.bench.fig4_commonality
"""
from __future__ import annotations

from repro_torch.bench.common import emit
from repro_torch.core.signatures import records_from_spec, signature_match_fraction
from repro_torch.models.vision import get_spec

PAIRS = [
    ("r50", "r50", "same-model"),
    ("yolo", "yolo", "same-model"),
    ("r18", "r50", "same-family"),
    ("r50", "r101", "same-family"),
    ("r50", "r152", "same-family"),
    ("r101", "r152", "same-family"),
    ("yolo", "tiny-yolo", "same-family"),
    ("ssd-vgg", "ssd-mnet", "same-family"),
    ("r50", "frcnn-r50", "cross-family"),
    ("r101", "frcnn-r101", "cross-family"),
    ("vgg", "ssd-vgg", "cross-family"),
    ("mnet", "ssd-mnet", "cross-family"),
    ("r50", "vgg", "cross-family"),
    ("r50", "yolo", "cross-family"),
    ("inception", "r50", "cross-family"),
    ("mnet", "inception", "cross-family"),
]


def run() -> dict:
    rows = []
    for a, b, kind in PAIRS:
        frac = signature_match_fraction(records_from_spec(get_spec(a)),
                                        records_from_spec(get_spec(b)))
        rows.append({"pair": f"{a}|{b}", "kind": kind, "identical_pct": 100 * frac})
    cross = [r["identical_pct"] for r in rows if r["kind"] == "cross-family"]
    same_fam = [r["identical_pct"] for r in rows if r["kind"] == "same-family"]
    return emit("fig4_commonality", rows, {
        "same_model": 100.0,
        "same_family_max_pct": max(same_fam),
        "cross_family_max_pct": max(cross),
        "paper": "same-family up to 25.3%, cross-family up to 92.3%",
    })


if __name__ == "__main__":
    run()
