"""Incremental AIMD merging planner (§5.3) — the port of
``repro.core.planner``'s compatibility surface.

The planning stack lives in :mod:`repro_torch.core.policy`;
:class:`IncrementalMerger` is the historical entry point: a
:class:`~repro_torch.core.policy.StagedPlanner` with the paper's
memory-forward scorer by default.  The planner never touches accuracy
guarantees itself — the trainer's validation is the gate.
"""
from __future__ import annotations

from repro_torch.core.policy import (  # noqa: F401  (re-exported compat names)
    MemoryForwardScorer,
    MergeEvent,
    MergePlan,
    PlanResult,
    RepresentationSimilarityScorer,
    StagedPlanner,
)


class IncrementalMerger(StagedPlanner):
    """Drop-in name for the seed planner: memory-forward order, full AIMD
    retry loop, returning a :class:`PlanResult` whose ``plan`` field is the
    serializable MergePlan."""
