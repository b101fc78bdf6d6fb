"""Plan-search efficiency (the port of ``benchmarks/plan_search.py``): the
similarity-prefiltered staged planner against the memory-forward planner
on a multi-model vision workload.

    PYTHONPATH=src python -m repro_torch.bench.plan_search [--device cuda|cpu]

Five small CNNs of mixed provenance: (A, B) and (D, E) common-provenance
pairs (B and E their partner + 0.01·N(0,1) on every leaf), C an
independent init of the same architecture.  Mergeability is functional
coherence: a shared column survives joint retraining iff its members'
calibration activations are mutually similar (linear CKA), which the
coherence surrogate enforces, so each planner pays one "retraining
attempt" a ``train`` call and the bench isolates SEARCH cost:

* memory-forward (§5.3) discovers incoherent members by paying a failed
  attempt, then shrinking;
* the similarity prefilter runs the calibration batch through each model
  up front and prunes candidates before any attempt.

Both planners score commits with the simulator in the loop
(``effective_accuracy_objective``, Table-1 byte scale).  ``BENCH_plan.json``
(under ``artifacts/torch/``) records attempts, wall time, fraction saved
and simulated accuracy, and the plan's round trip: exported, through JSON,
applied to a fresh store, every model's forward bitwise the planned
store's.  The inputs are one :class:`PlanInputs`: :func:`numpy_inputs`
draws them; the CPU parity tests inject the JAX bench's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.bench.common import check_gates, emit
from repro_torch.bench.lm_merging import _perturb
from repro_torch.core import (
    MemoryForwardScorer, MergePlan, ParamStore, RegisteredModel,
    RepresentationSimilarityScorer, StagedPlanner, records_from_params,
)
from repro_torch.core.policy import CoherenceSurrogateTrainer, calibration_activations
from repro_torch.models.registry import get_adapter
from repro_torch.serving.costs import costs_for
from repro_torch.serving.simulator import effective_accuracy_objective
from repro_torch.serving.workload import instances_from_store
from repro_torch.utils.device import resolve_device

MODEL_TARGET_GB = 0.242  # Table 1: yolo load size — what each model "weighs"
MIN_SIMILARITY = 0.5
ORDER = ("A", "B", "C", "D", "E")


@dataclasses.dataclass
class PlanInputs:
    """``zoo`` ({model_id: small_cnn params} in ``ORDER``; never mutated),
    the calibration batch, the (2, 32, 32, 3) frame of the round trip and
    ``planner_clock()``, which makes each planner's clock."""

    zoo: dict
    calibration: dict
    frame: torch.Tensor
    planner_clock: Callable[[], Callable[[], float]] = lambda: time.monotonic


def _adapter():
    return get_adapter("small_cnn")


def numpy_inputs(device=None) -> PlanInputs:
    """Inits from seeds 0, 42 and 5, the partners perturbed with numpy
    noise, numpy N(0, 1) calibration images (32) and frame, on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    adapter = _adapter()
    cfg = adapter.default_config()
    a, d = adapter.init(cfg, seed=0, device=dev), adapter.init(cfg, seed=5, device=dev)
    zoo = {"A": a, "B": _perturb(a, 1, 0.01), "C": adapter.init(cfg, seed=42, device=dev),
           "D": d, "E": _perturb(d, 2, 0.01)}

    def images(seed, n):
        x = np.random.default_rng(seed).standard_normal((n, 32, 32, 3), dtype=np.float32)
        return torch.from_numpy(x).to(dev)

    return PlanInputs(zoo, {"images": images(7, 32)}, images(3, 2))


@torch.no_grad()
def _activations(inp: PlanInputs) -> dict:
    adapter = _adapter()
    cfg = adapter.default_config()
    return calibration_activations({m: (adapter, cfg, p) for m, p in inp.zoo.items()},
                                   inp.calibration)


def _objective(store):
    """The simulator-in-the-loop objective at Table-1 byte scale: each model
    "weighs" the paper's yolo footprint and the capacity fits ~2 models,
    so the plan's sharing moves swap stalls and effective accuracy."""
    scale = MODEL_TARGET_GB * 1e9 / store.model_bytes("A")
    kb_fn = lambda k, nb: max(int(nb * scale), 1)  # noqa: E731
    return effective_accuracy_objective(
        lambda st, groups: instances_from_store(st, "tiny-yolo", key_bytes_fn=kb_fn),
        {"tiny-yolo": costs_for("tiny-yolo")}, capacity_bytes=int(2.2 * MODEL_TARGET_GB * 1e9))


@torch.no_grad()
def _build(inp: PlanInputs, scorer_name: str, activations: dict) -> tuple:
    """One planner run; returns (PlanResult, trainer calls, wall s, store,
    objective)."""
    store = ParamStore.from_models(dict(inp.zoo))
    recs = sum((records_from_params(p, m) for m, p in inp.zoo.items()), [])
    regs = [RegisteredModel(m, lambda p, b: 0.0, lambda p, b: 1.0, lambda e: [], None, 0.9, 1.0)
            for m in inp.zoo]
    scorer = (MemoryForwardScorer() if scorer_name == "memory-forward"
              else RepresentationSimilarityScorer(activations, MIN_SIMILARITY))
    objective = _objective(store)
    trainer = CoherenceSurrogateTrainer(activations, MIN_SIMILARITY)
    planner = StagedPlanner(store, regs, recs, trainer, scorer=scorer, objective=objective,
                            clock=inp.planner_clock())
    t0 = time.monotonic()
    res = planner.run()
    return res, trainer.calls, time.monotonic() - t0, store, objective


@torch.no_grad()
def _roundtrip_bitwise(inp: PlanInputs, res, store) -> dict:
    """Export → JSON → a fresh store's ``apply_plan``: forwards must match
    bitwise."""
    adapter = _adapter()
    cfg = adapter.default_config()
    payload = res.plan.to_json()
    plan = MergePlan.from_json(payload)
    fresh = ParamStore.from_models(dict(inp.zoo))
    epoch0 = fresh.epoch
    fresh.apply_plan(plan)
    bitwise = all(torch.equal(adapter.forward(cfg, store.materialize(m), inp.frame),
                              adapter.forward(cfg, fresh.materialize(m), inp.frame))
                  for m in ORDER)
    return {
        "plan_bytes": len(payload),
        "plan_groups": len(plan.groups),
        "bindings_equal": fresh.bindings == store.bindings,
        "single_epoch_bump": fresh.epoch == epoch0 + 1,
        "outputs_bitwise_identical": bitwise,
    }


def _row(planner: str, res, calls: int, wall: float, acc: float) -> dict:
    return {"planner": planner, "retrain_attempts": calls, "committed": res.committed,
            "discarded": res.discarded, "pruned_prefilter": res.pruned,
            "fraction_saved": res.fraction_saved, "wall_s": wall, "sim_overall_accuracy": acc}


def evaluate(inp: PlanInputs) -> tuple:
    """Both planners on the same activations and the round trip of the
    prefiltered plan.  Returns (rows, derived, {planner: PlanResult})."""
    activations = _activations(inp)
    mem, mem_calls, mem_wall, mem_store, objective = _build(inp, "memory-forward", activations)
    sim, sim_calls, sim_wall, sim_store, _ = _build(inp, "similarity", activations)
    baseline_acc = objective(ParamStore.from_models(dict(inp.zoo)), [])
    mem_acc, sim_acc = objective(mem_store, []), objective(sim_store, [])
    rt = _roundtrip_bitwise(inp, sim, sim_store)
    rows = [_row("memory-forward", mem, mem_calls, mem_wall, mem_acc),
            _row("similarity-prefilter", sim, sim_calls, sim_wall, sim_acc)]
    derived = {
        "attempts_strictly_fewer": sim_calls < mem_calls,
        "fraction_saved_no_worse": sim.fraction_saved >= mem.fraction_saved - 1e-12,
        "attempts_saved": mem_calls - sim_calls,
        "sim_overall_accuracy_unmerged": baseline_acc,
        "accuracy_no_worse": sim_acc >= mem_acc - 1e-9,
        **{f"roundtrip_{k}": v for k, v in rt.items()},
    }
    return rows, derived, {"memory-forward": mem, "similarity": sim}


def gates(d: dict) -> dict:
    """The bench's own acceptance check (``scripts/ci.sh`` runs it)."""
    return {"attempts_strictly_fewer": d["attempts_strictly_fewer"],
            "fraction_saved_no_worse": d["fraction_saved_no_worse"],
            "roundtrip_outputs_bitwise_identical": d["roundtrip_outputs_bitwise_identical"]}


def run(inp: PlanInputs = None, device=None) -> dict:
    inp = numpy_inputs(device) if inp is None else inp
    rows, derived, _ = evaluate(inp)
    return emit("BENCH_plan", rows, derived)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    out = run(device=args.device)
    check_gates("plan_search", gates(out["derived"]))


if __name__ == "__main__":
    main()
