"""GEMEL's contribution (the port of ``repro.core``): signatures, layer
groups, the ParamStore weight-unification substrate, the staged merge
planner (policy.py), joint retraining and validation."""
from repro_torch.core.groups import LayerGroup, enumerate_groups, potential_savings, stable_group_id
from repro_torch.core.merging import MergeResult, MergeTrainer
from repro_torch.core.planner import IncrementalMerger
from repro_torch.core.policy import (
    CandidateScorer,
    MemoryForwardScorer,
    MergeEvent,
    MergePlan,
    PlanResult,
    RepresentationSimilarityScorer,
    StagedPlanner,
)
from repro_torch.core.signatures import (
    LayerRecord,
    records_from_params,
    records_from_spec,
    signature_match_fraction,
)
from repro_torch.core.store import ParamStore
from repro_torch.core.validation import RegisteredModel, meets_targets, validate

__all__ = [
    "CandidateScorer", "LayerGroup", "LayerRecord", "MemoryForwardScorer",
    "ParamStore", "RegisteredModel", "RepresentationSimilarityScorer",
    "IncrementalMerger", "MergeEvent", "MergePlan", "MergeResult",
    "MergeTrainer", "PlanResult", "StagedPlanner", "enumerate_groups",
    "potential_savings", "records_from_params", "records_from_spec", "signature_match_fraction",
    "meets_targets", "stable_group_id", "validate",
]
