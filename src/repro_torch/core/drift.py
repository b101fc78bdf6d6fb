"""Data-drift tracking (§5.1 steps 4-5; the port of ``repro.core.drift``).

Edge boxes periodically sample frames; the cloud runs the *original* models
on them and compares against the merged models' outputs.  If any query's
accuracy falls below target, edge inference reverts to the original weights
for that model and merging resumes from the previously deployed state.

The loop that drives this monitor is ``serving/lifecycle.py``: breach ->
revert -> warm-start re-plan -> hot swap.  This module contributes the two
artifacts that loop consumes:

* :meth:`DriftMonitor.revert_delta` — the binding delta a revert implies,
  the revert-side analogue of ``MergePlan.binding_deltas``;
* :class:`ResumeState` — the serializable "resume merging from the last
  deployed state" payload (deployed plan + exclusions + revert history),
  whose JSON is the JAX package's byte for byte.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch

from repro_torch.core.store import ParamStore, _private_key
from repro_torch.utils.tree import flatten_paths


@dataclasses.dataclass
class DriftReport:
    checked: dict  # model_id -> accuracy vs original on sampled data
    breached: set  # model_ids under target
    reverted: set  # model_ids whose edge inference switched to originals


@dataclasses.dataclass
class ResumeState:
    """§5.1 step 5 — "merging resumes from the previously deployed state" —
    as a serializable artifact: the last deployed plan (its JSON payload),
    the models currently excluded from planning (reverted / quarantined by
    the revert-storm hysteresis), the revert timestamps that drive the
    hysteresis and the store epoch the state was captured at.  The JSON
    keeps the JAX package's ``replan_timed_out`` key, always false: the
    port's planner has no per-attempt budget."""

    plan_json: Optional[str]
    excluded: tuple  # model ids, sorted
    revert_history: dict  # model_id -> [revert timestamps, planner clock]
    epoch: int

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps({
            "plan": self.plan_json,
            "excluded": list(self.excluded),
            "revert_history": {m: list(ts) for m, ts in sorted(self.revert_history.items())},
            "epoch": self.epoch,
            "replan_timed_out": False,
        }, indent=indent)

    @classmethod
    def from_json(cls, payload: str) -> "ResumeState":
        obj = json.loads(payload)
        return cls(obj["plan"], tuple(obj["excluded"]),
                   {m: list(ts) for m, ts in obj["revert_history"].items()},
                   obj["epoch"])

    def plan(self):
        from repro_torch.core.policy import MergePlan

        return MergePlan.from_json(self.plan_json) if self.plan_json is not None else None


class DriftMonitor:
    def __init__(self, store: ParamStore, originals: dict, models: list):
        """originals: {model_id: original params tree} kept cloud-side."""
        self.store = store
        self.originals = originals
        self.models = {m.model_id: m for m in models}

    @torch.no_grad()
    def check(self, sampled_batches: dict) -> DriftReport:
        """sampled_batches: {model_id: batch of recent edge frames}."""
        checked, breached = {}, set()
        for mid, batch in sampled_batches.items():
            m = self.models[mid]
            # read-only check on the serve path's cached tree: drift checks
            # must neither bump the binding epoch nor force a rebuild
            acc = float(m.accuracy_fn(self.store.materialize_cached(mid), batch))
            checked[mid] = acc
            if acc < m.absolute_target:
                breached.add(mid)
        return DriftReport(checked, breached, set())

    def revert_delta(self, report: DriftReport) -> dict:
        """{(model_id, path): (current_key, private_key)} for every
        appearance a revert of the breached models rebinds — the breach's
        binding delta, mirroring ``MergePlan.binding_deltas``.  Pure query:
        the store is untouched."""
        delta = {}
        for mid in sorted(report.breached):
            for path in flatten_paths(self.originals[mid]):
                delta[(mid, path)] = (self.store.bindings[mid][path], _private_key(mid, path))
        return delta

    def revert(self, report: DriftReport) -> DriftReport:
        """Rebind breached models to their original private weights; shared
        buffers the surviving group members reference are untouched (only
        truly unreferenced keys are GC'd).  The rebind is staged and commits
        with ONE epoch bump, so a live engine's cached trees AND suffix
        banks invalidate exactly once and queued requests are served
        against the reverted bindings on the very next pass."""
        delta = self.revert_delta(report)  # the ONE statement of the rebind
        flats = {mid: flatten_paths(self.originals[mid]) for mid in report.breached}
        for (mid, path), (_old, private_key) in delta.items():
            self.store.buffers[private_key] = flats[mid][path]
            self.store.bindings[mid][path] = private_key
        report.reverted.update(report.breached)
        self.store._gc_unreferenced()
        if report.breached:
            self.store.bump_epoch()  # reverts rebind: invalidate cached trees
        return report
