"""Overload + fault-injection benchmark for the ingestion front end (the
port of ``benchmarks/overload.py``).

    PYTHONPATH=src python -m repro_torch.bench.overload [--device cuda|cpu]

Four camera feeds (``cam-A`` .. ``cam-D``, small-CNN variants with a shared
merged trunk) stream deterministic frames into bounded admission queues in
front of a live ``MergeAwareEngine``.  Ground truth is synthetic and exact:
each camera has a fixed event rate (0.30/0.40/0.50/0.60) and positive frames
carry a bright patch, so a class-mean probe over the MERGED trunk's pooled
features (``CascadeGate.fit_prefix_probe``) separates them.

Lanes:

* **policy sweep** — sustained 2x and 4x overload under ``drop-oldest``,
  ``drop-newest`` and ``degrade``.  Effective accuracy counts a heavy
  completion as 1.0, a gate-only completion as its correctness against
  ground truth and a shed frame as 0; ``degrade`` must beat ``drop-newest``
  at both overloads.
* **cascade objective** — the observed per-camera hit rates feed
  ``CascadeProfile`` → ``effective_accuracy_objective(cascade=...)`` at
  paper-scale model bytes; the cascaded objective must not be lower.
* **fault sweep** — engine stall, slow kernel (4x service factor), a
  mid-flight ``apply_plan`` failure (atomic rollback: ONE epoch bump,
  bindings bit-identical, queued requests intact, then a clean re-apply)
  and a camera disconnect/reconnect.  Every lane must show ``lost == 0``
  and max queue depth <= capacity.

The frame banks and gate-fitting frames are :class:`OverloadInputs`;
:func:`numpy_inputs` draws them from numpy, the CPU parity tests inject the
JAX package's draws.  Artifacts go to ``artifacts/torch/``.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.bench.common import check_gates, emit
from repro_torch.bench.drift_adapt import (
    DriftScenario, build_scenario, cnn_zoo, plan_members,
)
from repro_torch.core import MergePlan, ParamStore
from repro_torch.core.policy import CascadeProfile
from repro_torch.models.registry import get_adapter
from repro_torch.runtime.monitors import QueueDepthMonitor, ShedRateMonitor
from repro_torch.serving.costs import costs_for
from repro_torch.serving.executor import PlanApplyError
from repro_torch.serving.faults import CAMERA_DISCONNECT, SLOW_KERNEL, STALL, Fault, FaultInjector
from repro_torch.serving.ingestion import CameraSource, CascadeGate, IngestionFrontEnd
from repro_torch.serving.simulator import effective_accuracy_objective
from repro_torch.serving.workload import instances_from_store
from repro_torch.utils.device import resolve_device

MIDS = ("cam-A", "cam-B", "cam-C", "cam-D")
POS_RATE = {"cam-A": 0.30, "cam-B": 0.40, "cam-C": 0.50, "cam-D": 0.60}
CAP = 12  # per-camera admission queue capacity
BUDGET = 12  # frames the engine serves per pump step (the "1x" capacity)
STEPS = 12
FAULT_STEPS = 14
SLA_S = 600.0  # generous: overload sheds by queue bound, not SLA expiry
MAXK = 160  # frames precomputed per camera (>= max offered per lane)
PATCH = 2.5  # brightness added to the event patch of positive frames


def is_positive(mid: str, k: int) -> bool:
    """Deterministic ground truth: camera ``mid``'s frame ``k`` carries an
    event (Knuth-hash spread, so positives interleave)."""
    idx = MIDS.index(mid)
    return ((k * 2654435761 + idx * 40503) % 2 ** 32) % 1000 < POS_RATE[mid] * 1000


def frame_bank(mid: str, noise: np.ndarray) -> np.ndarray:
    """Camera ``mid``'s frames: ``noise`` with a bright 8x8 patch on the
    positive frames — the separable "event" the gate probe learns."""
    base = np.array(noise, dtype=np.float32)
    pos = np.array([is_positive(mid, k) for k in range(base.shape[0])])
    base[pos, 8:16, 8:16, :] += PATCH
    return base


def labelled(neg: np.ndarray, pos: np.ndarray) -> tuple:
    """Balanced labelled frames for gate fitting: ``pos`` gets the patch."""
    pos = np.array(pos, dtype=np.float32)
    pos[:, 8:16, 8:16, :] += PATCH
    return np.concatenate([neg, pos], axis=0), np.array([False] * len(neg) + [True] * len(pos))


@dataclasses.dataclass
class OverloadInputs:
    """Every frame the bench uses (NHWC float32 numpy): ``banks[mid]``
    (MAXK, 32, 32, 3) per camera, the labelled gate fitting and hold-out
    sets ``fit`` and ``hold`` ((frames, labels), 32 + 32 each) and the
    planner's CKA ``calibration`` batch (32)."""

    banks: dict
    fit: tuple
    hold: tuple
    calibration: np.ndarray


def numpy_inputs() -> OverloadInputs:
    def noise(seed, n):
        return np.random.default_rng(seed).standard_normal((n, 32, 32, 3), dtype=np.float32)

    return OverloadInputs({m: frame_bank(m, noise(123 + i, MAXK)) for i, m in enumerate(MIDS)},
                          labelled(noise(777, 32), noise(778, 32)),
                          labelled(noise(911, 32), noise(912, 32)), noise(7, 32))


def build_stack(inputs: Optional[OverloadInputs] = None, device=None,
                zoo: Optional[dict] = None) -> dict:
    """One serving stack for every lane: zoo -> cloud plan -> edge store +
    engine with the plan hot-swapped in, plus the trunk-probe gate.  Lanes
    reuse the engine; only the swap-failure lane mutates the store, so it
    runs LAST.  ``zoo`` ({mid: params}) replaces ``cnn_zoo``'s."""
    dev = resolve_device(device)
    inputs = numpy_inputs() if inputs is None else inputs
    adapter = get_adapter("small_cnn")
    cfg = adapter.default_config()
    originals = cnn_zoo(adapter, cfg, MIDS, dev) if zoo is None else zoo
    # the drift scenario's planning and deployment; no timeline runs here
    scn = DriftScenario(adapter, cfg, originals, drifted_original={},
                        calibration={"images": torch.from_numpy(np.array(inputs.calibration)).to(dev)},
                        payload=None, probe=None)
    info = build_scenario(scn)
    edge, eng = info["edge"], info["engine"]

    def tensor(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    prefix_fn = adapter.split(cfg).prefix
    gate_params = edge.materialize_cached(MIDS[0])  # the MERGED trunk
    fit_x, fit_y = inputs.fit
    gate_proto = CascadeGate.fit_prefix_probe(prefix_fn, gate_params, tensor(fit_x), fit_y)
    hold_x, hold_y = inputs.hold
    scores = gate_proto.score_fn(tensor(hold_x)).cpu().numpy()
    return {
        "adapter": adapter, "cfg": cfg, "scenario": scn, "originals": originals,
        "plan0": info["plan0"], "edge": edge, "engine": eng,
        "gate": gate_proto, "gate_acc": float(np.mean((scores > 0) == hold_y)),
        "banks": {m: tensor(inputs.banks[m]) for m in MIDS},
    }


def fresh_gate(stack) -> CascadeGate:
    """New counters per lane over the one fitted probe."""
    return CascadeGate(stack["gate"].score_fn)


def run_lane(stack, policy: str, overload: float, steps: int = STEPS, gated: bool = False,
             cascade_always: bool = False, faults=(), mid_run=None) -> dict:
    """One front-end run; returns the lane's accounting + quality row (the
    per-step accounting rows under ``step_log``)."""
    eng = stack["engine"]
    banks = stack["banks"]
    fps_cam = overload * BUDGET / len(MIDS)  # logical frames/s per camera
    sources = [CameraSource(m, fps=fps_cam, frame_fn=lambda k, b=banks[m]: b[k:k + 1],
                            sla_s=SLA_S) for m in MIDS]
    gate = fresh_gate(stack) if (gated or cascade_always) else None
    injector = FaultInjector(faults) if (faults or mid_run) else None
    depth_mon = QueueDepthMonitor(bound=CAP)
    shed_mon = ShedRateMonitor(window=steps)
    fe = IngestionFrontEnd(
        eng, sources, policy=policy, queue_capacity=CAP, service_budget=BUDGET, gate=gate,
        cascade_always=cascade_always, warmup=banks[MIDS[0]][:1], fault_injector=injector,
        monitors=(depth_mon, shed_mon))
    base = len(eng.completions)
    lane_extra: dict = {}
    for s in range(steps):
        fe.step(1.0)
        if mid_run is not None:
            mid_run(s, fe, eng, injector, lane_extra)
    rep = fe.report()

    # effective accuracy: heavy completion = 1.0; gate-only completion = its
    # correctness vs ground truth; shed/expired/pending = 0
    credit = float(len(eng.completions) - base)
    gate_correct = 0
    for req, decision, _ in fe.gate_completions:
        mid, k = req.meta
        ok = is_positive(mid, k) == decision
        gate_correct += int(ok)
        credit += float(ok)
    return {
        "policy": policy, "overload": overload, "steps": steps,
        "cascade_always": cascade_always,
        "effective_accuracy": credit / max(rep["offered"], 1),
        "sla_attainment": rep["sla_attained"] / max(rep["offered"], 1),
        "gate_correct": gate_correct,
        "queue_bounded": depth_mon.bounded,
        "shed_events": len(shed_mon.events),
        "fault_events": list(injector.events) if injector else [],
        "observed_rates": ({m: gate.observed_hit_rate(m) for m in MIDS}
                           if gate is not None else None),
        **{k: v for k, v in rep.items() if k != "max_depth_by_camera"},
        **lane_extra,
        "step_log": fe.step_log,
    }


# -- fault lanes ---------------------------------------------------------------


def fault_lanes(stack) -> list:
    rows = [{"lane": "fault:none", **run_lane(stack, "drop-oldest", 1.0, steps=FAULT_STEPS)}]
    rows.append({"lane": "fault:stall", **run_lane(
        stack, "drop-oldest", 1.0, steps=FAULT_STEPS,
        faults=[Fault(STALL, at_step=4, duration_steps=5)])})
    rows.append({"lane": "fault:slow_kernel", **run_lane(
        stack, "drop-oldest", 1.0, steps=FAULT_STEPS,
        faults=[Fault(SLOW_KERNEL, at_step=4, duration_steps=5, factor=4.0)])})
    rows.append({"lane": "fault:camera_disconnect", **run_lane(
        stack, "drop-oldest", 1.0, steps=FAULT_STEPS,
        faults=[Fault(CAMERA_DISCONNECT, camera="cam-B", at_step=3, duration_steps=4)])})

    # swap failure LAST (the only lane that mutates the store): a re-plan
    # excluding cam-D is first applied with an injected mid-flight failure
    # (must roll back atomically), then applied cleanly (must succeed)
    res2, _ = plan_members(stack["scenario"], stack["originals"], exclude={"cam-D"})
    plan2 = MergePlan.from_json(res2.plan.to_json())

    def mid_run(step, fe, eng, inj, extra):
        if step == 6:
            extra.update(swap_failure(eng, inj, plan2, fe.queues))
        elif step == 8:
            out = eng.apply_plan(plan2)  # clean re-apply must succeed
            extra["reapply_shared_keys"] = len(out["shared_keys"])
            extra["reapply_epoch_bumps"] = out["epoch_bumps"]

    rows.append({"lane": "fault:swap_failure", **run_lane(
        stack, "drop-oldest", 1.0, steps=FAULT_STEPS, mid_run=mid_run)})
    return rows


def swap_failure(eng, injector: FaultInjector, plan, queues: dict) -> dict:
    """Arm a one-shot failure after one plan column and apply ``plan`` on
    the live engine: it must raise ``PlanApplyError`` with ONE epoch bump,
    the bindings bit-identical to before and ``queues`` ({name: queue})
    holding what they held."""
    epoch0 = eng.store.epoch
    bind0 = {m: dict(b) for m, b in eng.store.bindings.items()}
    pend0 = sum(len(q) for q in queues.values())
    injector.arm_swap_failure(eng.store, 1)
    raised = False
    try:
        eng.apply_plan(plan)
    except PlanApplyError:
        raised = True
    return {
        "swap_failure_raised": raised,
        "swap_failure_epoch_bumps": eng.store.epoch - epoch0,
        "swap_failure_bindings_restored": eng.store.bindings == bind0,
        "swap_failure_pending_kept": sum(len(q) for q in queues.values()) == pend0,
    }


# -- cascade-aware planner objective -------------------------------------------


def cascade_objective_view(stack, profile: CascadeProfile) -> dict:
    """Score the UNMERGED workload with and without the observed cascade
    profile at paper-scale bytes (each model rescaled to ~1.2 GB against a
    2 GB box, so the swap schedule is the bottleneck): the cascade thins
    each camera's heavy arrivals to its observed hit rate, while
    gate-negative frames still earn the gate's measured credit."""
    cloud = ParamStore.from_models(dict(stack["originals"]))
    model_bytes = max(cloud.model_bytes(m) for m in MIDS)
    scale = 1.2e9 / max(model_bytes, 1)

    def insts_fn(store, committed_groups):
        return instances_from_store(store, "tiny-yolo", model_ids=list(MIDS),
                                    key_bytes_fn=lambda k, b: int(b * scale))

    common = dict(costs={"tiny-yolo": costs_for("tiny-yolo")}, capacity_bytes=int(2.0e9),
                  horizon_ms=20_000.0, fps=30.0, sla_ms=100.0)
    obj_plain = effective_accuracy_objective(insts_fn, **common)
    obj_casc = effective_accuracy_objective(insts_fn, cascade=profile.simulator_arg(), **common)
    return {
        "objective_plain": obj_plain(cloud, []),
        "objective_cascade": obj_casc(cloud, []),
        "profile_rates": dict(profile.rates),
        "profile_gate_accuracy": dict(profile.gate_accuracy),
    }


def fault_derived(fault_rows: list) -> dict:
    swap = next(r for r in fault_rows if r["lane"] == "fault:swap_failure")
    return {
        "fault_lanes": len(fault_rows),
        "fault_lost_total": sum(r["lost"] for r in fault_rows),
        "fault_all_bounded": all(r["queue_bounded"] and r["max_depth"] <= CAP
                                 for r in fault_rows),
        "swap_failure_raised": swap["swap_failure_raised"],
        "swap_failure_epoch_bumps": swap["swap_failure_epoch_bumps"],
        "swap_failure_bindings_restored": swap["swap_failure_bindings_restored"],
        "swap_failure_pending_kept": swap["swap_failure_pending_kept"],
        "swap_reapply_ok": swap.get("reapply_epoch_bumps") == 1,
        "disconnects": next(r for r in fault_rows
                            if r["lane"] == "fault:camera_disconnect")["fault_events"],
    }


def evaluate(stack) -> tuple:
    """Every lane on ``stack``; returns (rows, derived)."""
    rows = []
    for overload in (2.0, 4.0):
        for policy in ("drop-oldest", "drop-newest", "degrade"):
            rows.append({"lane": f"policy:{policy}@{overload:g}x",
                         **run_lane(stack, policy, overload, gated=(policy == "degrade"))})

    # the planner objective consumes the hit rates the gate ACTUALLY
    # observed on a 1x always-gated pass, not the ground-truth event rates
    casc = run_lane(stack, "drop-oldest", 1.0, cascade_always=True)
    rows.append({"lane": "cascade:profile@1x", **casc})
    profile = CascadeProfile(rates=casc["observed_rates"],
                             gate_accuracy={m: stack["gate_acc"] for m in MIDS})
    objective = cascade_objective_view(stack, profile)
    rows.extend(fault_lanes(stack))
    by_lane = {r["lane"]: r for r in rows}

    def eff(policy, overload):
        return by_lane[f"policy:{policy}@{overload:g}x"]["effective_accuracy"]

    derived = {
        "queue_capacity": CAP,
        "service_budget": BUDGET,
        "gate_accuracy": stack["gate_acc"],
        "max_depth_2x": max(r["max_depth"] for r in rows if r.get("overload") == 2.0),
        "max_depth_all": max(r["max_depth"] for r in rows),
        "lost_total": sum(r["lost"] for r in rows),
        **{f"eff_acc_{p.replace('-', '_')}_{o:g}x": eff(p, o)
           for o in (2.0, 4.0) for p in ("drop-oldest", "drop-newest", "degrade")},
        "degrade_beats_drop_newest_2x": eff("degrade", 2.0) > eff("drop-newest", 2.0),
        "degrade_beats_drop_newest_4x": eff("degrade", 4.0) > eff("drop-newest", 4.0),
        **objective,
        "cascade_objective_gain": objective["objective_cascade"] - objective["objective_plain"],
        **fault_derived([r for r in rows if r["lane"].startswith("fault:")]),
    }
    return rows, derived


def gates(d: dict) -> dict:
    """The overload acceptance gates of ``scripts/ci.sh``."""
    return {
        "fault_lost_total == 0": d["fault_lost_total"] == 0,
        "fault_all_bounded": d["fault_all_bounded"],
        "swap_failure_raised": d["swap_failure_raised"],
        "swap_failure_epoch_bumps == 1": d["swap_failure_epoch_bumps"] == 1,
        "swap_failure_bindings_restored": d["swap_failure_bindings_restored"],
        "swap_failure_pending_kept": d["swap_failure_pending_kept"],
        "swap_reapply_ok": d["swap_reapply_ok"],
        "max_depth_all <= queue_capacity": d["max_depth_all"] <= d["queue_capacity"],
        "lost_total == 0": d["lost_total"] == 0,
        "degrade_beats_drop_newest_2x": d["degrade_beats_drop_newest_2x"],
        "degrade_beats_drop_newest_4x": d["degrade_beats_drop_newest_4x"],
        "cascade_objective_gain >= 0": d["cascade_objective_gain"] >= 0.0,
    }


def run(device=None) -> dict:
    rows, derived = evaluate(build_stack(device=device))
    rows = [{k: v for k, v in r.items() if k != "step_log"} for r in rows]
    return emit("BENCH_overload", rows, derived)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    out = run(device=args.device)
    check_gates("overload", gates(out["derived"]))


if __name__ == "__main__":
    main()
