"""Layer groups (§5.3; the port of ``repro.core.groups``): all appearances
of one architectural signature across a workload's models, sorted
memory-forward (group memory = leaf_bytes * n_appearances).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import defaultdict
from typing import Iterable


def stable_group_id(signature: tuple) -> str:
    """Deterministic shared-buffer id for a group signature: blake2b of the
    signature repr, so ids agree across processes and with the JAX package."""
    digest = hashlib.blake2b(repr(signature).encode(), digest_size=8).hexdigest()
    return f"shared:{digest}"


def disambiguate_base(base: str, in_use) -> str:
    """Repeat merges of the same signature must not alias onto one buffer:
    append ``~n`` until no existing key starts with the base.
    ``in_use(prefix)`` reports whether any existing key starts with
    ``prefix``."""
    if in_use(base + ":"):
        n = 1
        while in_use(f"{base}~{n}:"):
            n += 1
        base = f"{base}~{n}"
    return base


@dataclasses.dataclass
class LayerGroup:
    signature: tuple
    records: list  # list[LayerRecord], >= 2 entries, possibly across models

    @property
    def leaf_bytes(self) -> int:
        return self.records[0].bytes

    @property
    def memory(self) -> int:
        return self.leaf_bytes * len(self.records)

    def columns(self) -> list:
        """Merging is ACROSS models only (paper §4): a model's k-th
        appearance of this signature merges with other models' k-th
        appearances (position-ordered).  Each column becomes one shared
        buffer; a model's internal duplicates stay distinct."""
        by_model = defaultdict(list)
        for r in sorted(self.records, key=lambda r: r.position):
            by_model[r.model_id].append(r)
        ncols = max(len(v) for v in by_model.values())
        cols = [[] for _ in range(ncols)]
        for rs in by_model.values():
            for k, r in enumerate(rs):
                cols[k].append(r)
        return cols

    @property
    def savings(self) -> int:
        """bytes saved = leaf_bytes x (appearances - max per-model count):
        the workload still needs one buffer per column."""
        return sum(self.leaf_bytes * (len(c) - 1) for c in self.columns())

    @property
    def models(self) -> set:
        return {r.model_id for r in self.records}

    def drop_earliest_half(self) -> "LayerGroup":
        """AIMD multiplicative decrease: drop the half of appearances closest
        to the *start* of their models (they typically hold less memory and
        are harder to share — §5.3)."""
        ordered = sorted(self.records, key=lambda r: r.position)
        return LayerGroup(self.signature, ordered[len(ordered) // 2:])

    def without_models(self, model_ids: set) -> "LayerGroup":
        return LayerGroup(self.signature,
                          [r for r in self.records if r.model_id not in model_ids])


def enumerate_groups(records: Iterable, min_appearances: int = 2) -> list:
    """Cluster records by signature; keep groups with >= min_appearances,
    sorted descending by workload memory (memory-forward order)."""
    by_sig: dict = defaultdict(list)
    for r in records:
        by_sig[r.signature].append(r)
    groups = [LayerGroup(sig, recs) for sig, recs in by_sig.items()
              if len(recs) >= min_appearances]
    groups.sort(key=lambda g: (-g.memory, g.signature))
    return groups


def potential_savings(records: Iterable) -> dict:
    """Fig 5 'Optimal': share every architecturally identical layer,
    disregarding weights and accuracy.  Returns totals in bytes."""
    records = list(records)
    total = sum(r.bytes for r in records)
    groups = enumerate_groups(records)
    saved = sum(g.savings for g in groups)
    return {
        "total_bytes": total,
        "saved_bytes": saved,
        "merged_bytes": total - saved,
        "fraction_saved": saved / total if total else 0.0,
        "n_groups": len(groups),
    }
