"""Drift-adapt lifecycle benchmark (the port of ``benchmarks/drift_adapt.py``;
paper §5.1 steps 4-5).

    PYTHONPATH=src python -m repro_torch.bench.drift_adapt [--device cuda|cpu]

Seven small-CNN queries (``cam-A`` .. ``cam-G``) with common trunk
provenance are planned, hot-swapped and served merged by a live
``MergeAwareEngine``.  At a fixed sampling period the content behind
``cam-B`` drifts: the cloud-side *original* model of that query changes,
so the merged model's agreement with it collapses.  Two timelines serve the
SAME request trace:

* **with the lifecycle loop** — a ``LifecycleController`` samples frames
  every period; the breach is detected and the model reverted within one
  sampling period (no engine drain), the planner warm-starts from the
  deployed plan excluding the breached member, and the re-planned
  configuration hot-swaps back in;
* **without the loop** — the breached query keeps serving the stale merged
  weights.

Everything the timelines take is one :class:`DriftScenario`: the zoo, the
drifted original, the calibration batch, the request payloads and the
sampled probe batches.  :func:`numpy_scenario` draws them from numpy; the
CPU parity tests inject the JAX package's draws, and ``chip_smoke.py``
drives the same timelines over a full-width stablelm-1.6b zoo.
``BENCH_drift.json`` (under ``artifacts/torch/``) records the
agreement-over-time table, time to recover, warm-start vs cold re-plan
attempts, the post-swap replay check and the simulator's view of the lag.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.bench.common import check_gates, emit
from repro_torch.bench.lm_merging import _perturb, verify_bitwise
from repro_torch.core import MergePlan, ParamStore, RegisteredModel, RepresentationSimilarityScorer
from repro_torch.core import StagedPlanner
from repro_torch.core.drift import DriftMonitor
from repro_torch.core.policy import CoherenceSurrogateTrainer, calibration_activations
from repro_torch.models.registry import get_adapter
from repro_torch.serving.costs import costs_for
from repro_torch.serving.executor import MergeAwareEngine, ModelProgram, Request
from repro_torch.serving.lifecycle import BREACHED, REVERTED, LifecycleController
from repro_torch.serving.lifecycle import RevertHysteresis
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.simulator import DriftEvent, simulate
from repro_torch.serving.workload import instances_from_store
from repro_torch.utils.device import resolve_device

MIDS = tuple(f"cam-{c}" for c in "ABCDEFG")
DRIFTED = "cam-B"
BUCKETS = (1, 2, 4)
PERIOD_S = 10.0
TARGET = 0.5  # absolute agreement-with-original target (original_accuracy=1)
# a banked row against the member's own suffix over the batch: exact on the
# CPU, where the bank's plain version is the suffix's arithmetic; on the card
# (the bank's own kernel against the library's GEMM) the kernel tolerances of
# the JAX package's kernel tests, by the zoo's dtype
BANK_GAP_TOL = {"float32": 2e-3, "bfloat16": 2e-2}
MIN_SIMILARITY = 0.5
N_PERIODS = 8
DRIFT_PERIOD = 3
REQS_PER_MODEL = 2
PROBE_N = 64  # sampled frames per check: quantisation 1/64 vs a 0.5 target


class ManualClock:
    """Deterministic lifecycle time: the timeline advances it one sampling
    period per loop iteration; nothing in the controller reads wall time."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@dataclasses.dataclass
class DriftScenario:
    """The inputs of one drift study.  ``originals`` ({model_id: params})
    is never mutated: each timeline works on its own copy of the dict, so
    two timelines can share the tensors; the second member is the one that
    drifts, to ``drifted_original``.  ``payload(period, i, j)`` is the
    (1, ...) payload of member ``i``'s ``j``-th request of a period;
    ``probe(period)`` the batch of sampled inputs a check runs.
    ``planner_clock()`` makes each planner's clock."""

    adapter: Any
    cfg: Any
    originals: dict
    drifted_original: dict
    calibration: dict
    payload: Callable[[int, int, int], torch.Tensor]
    probe: Callable[[int], torch.Tensor]
    planner_clock: Callable[[], Callable[[], float]] = lambda: time.monotonic

    @property
    def mids(self) -> tuple:
        return tuple(self.originals)

    @property
    def drifted(self) -> str:
        return self.mids[1]


def _is_head(path: str) -> bool:
    return path.startswith(("head/", "final_norm/", "lm_head/"))


def cnn_zoo(adapter, cfg, mids=MIDS, device=None) -> dict:
    """Per-feed variants of one detector: common trunk provenance (trunk
    + 0.005·N(0,1) — the fine-tune-per-feed story), divergent private heads
    (+ 1.0·N(0,1))."""
    base = adapter.init(cfg, seed=0, device=device)
    zoo = {mids[0]: base}
    for i, mid in enumerate(mids[1:]):
        v = _perturb(base, 2 * i + 1, 0.005, select=lambda p: not _is_head(p))
        zoo[mid] = _perturb(v, 2 * i + 2, 1.0, select=_is_head)
    return zoo


def numpy_scenario(mids=MIDS, device=None) -> DriftScenario:
    """The small-CNN scenario with every input drawn from numpy (frames
    N(0,1), (32, 32, 3)) on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    adapter = get_adapter("small_cnn")
    cfg = adapter.default_config()

    def frames(seed, n):
        x = np.random.default_rng(seed).standard_normal((n, 32, 32, 3), dtype=np.float32)
        return torch.from_numpy(x).to(dev)

    return DriftScenario(
        adapter, cfg, cnn_zoo(adapter, cfg, mids, dev),
        drifted_original=adapter.init(cfg, seed=999, device=dev),
        calibration={"images": frames(7, 32)},
        payload=lambda period, i, j: frames((5000, period, i, j), 1),
        probe=lambda period: frames((1000, period), PROBE_N),
    )


def agreement_fn(fwd, originals: dict, mid: str):
    """§5.1 step 4 metric: fraction of sampled positions (frames, or
    tokens of an LM's prompts) where the served (merged) model's argmax
    agrees with the query's ORIGINAL model's.  Reads ``originals`` live, so
    a drift (the original changes) is seen by the very next check."""

    def acc(params, x):
        ref = fwd(originals[mid], x).argmax(dim=-1)
        out = fwd(params, x).argmax(dim=-1)
        return (out == ref).float().mean()

    return acc


def registered(mids) -> list:
    """Planner-side registrations (the surrogate trainer judges coherence,
    so loss and accuracy are inert here)."""
    return [RegisteredModel(m, lambda p, b: 0.0, lambda p, b: 1.0, lambda e: [], None, 0.9, 1.0)
            for m in mids]


@torch.no_grad()
def plan_members(scn: DriftScenario, originals: dict, exclude=(), seed_plan=None,
                 plan_weights: bool = True):
    """Cloud-side staged search over the trunk (heads stay private): CKA
    prefilter + coherence surrogate on ``scn.calibration``;
    ``exclude``/``seed_plan`` are the warm-start controls the lifecycle
    loop drives.  Returns (PlanResult, cloud store)."""
    adapter, cfg = scn.adapter, scn.cfg
    cloud = ParamStore.from_models(dict(originals))
    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m, p in originals.items() for r in adapter.records(cfg, p, m) if r.path in trunk]
    acts = calibration_activations({m: (adapter, cfg, p) for m, p in originals.items()},
                                   scn.calibration)
    scorer = RepresentationSimilarityScorer(acts, MIN_SIMILARITY)
    trainer = CoherenceSurrogateTrainer(acts, MIN_SIMILARITY)
    planner = StagedPlanner(cloud, registered(originals), recs, trainer, scorer=scorer,
                            exclude_models=set(exclude), seed_plan=seed_plan,
                            clock=scn.planner_clock(), plan_weights=plan_weights)
    return planner.run(), cloud


def make_engine(scn: DriftScenario, store) -> MergeAwareEngine:
    """An engine whose capacity holds every member unmerged (the study is
    about accuracy and residency, not swapping)."""
    programs = [ModelProgram.from_adapter(scn.adapter, m, cfg=scn.cfg) for m in scn.mids]
    return MergeAwareEngine(
        store, instances_from_store(store, "tiny-yolo", model_ids=list(scn.mids)),
        programs, capacity_bytes=10 ** 9 + store.resident_bytes(),
        costs={"tiny-yolo": costs_for("tiny-yolo")}, buckets=BUCKETS)


def period_requests(scn: DriftScenario, period: int, now_s: float) -> list:
    """``REQS_PER_MODEL`` requests per member; deadlines interleave the
    members so a merged group's micro-batches carry rows of every member."""
    mids = scn.mids
    return [Request(m, scn.payload(period, i, j), now_s,
                    now_s + 1e6 + (j * len(mids) + i) * 1e-3)
            for i, m in enumerate(mids) for j in range(REQS_PER_MODEL)]


def build_scenario(scn: DriftScenario, plan0: Optional[MergePlan] = None) -> dict:
    """Everything a timeline needs: the initial cloud plan (planned and
    shipped through JSON, unless ``plan0`` is given), an edge store + engine
    with it hot-swapped in, a monitor over the timeline's own originals
    dict.  Host seconds of each step are recorded under ``"seconds"``."""
    originals = dict(scn.originals)
    seconds = {}
    cloud = None
    if plan0 is None:
        t0 = time.perf_counter()
        res0, cloud = plan_members(scn, originals)
        seconds["plan"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        payload = res0.plan.to_json()
        seconds["to_json"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan0 = MergePlan.from_json(payload)
        seconds["from_json"] = time.perf_counter() - t0
        del payload
    edge = ParamStore.from_models(dict(originals))
    unmerged_bytes = edge.resident_bytes()
    eng = make_engine(scn, edge)
    t0 = time.perf_counter()
    eng.apply_plan(plan0)
    seconds["apply_plan"] = time.perf_counter() - t0
    fwd = scn.adapter.bound_forward(scn.cfg)
    regs = [RegisteredModel(m, lambda p, b: 0.0, agreement_fn(fwd, originals, m),
                            lambda e: [], None, TARGET, 1.0) for m in scn.mids]
    return dict(originals=originals, plan0=plan0, cloud=cloud, edge=edge, engine=eng,
                monitor=DriftMonitor(edge, originals, regs),
                unmerged_bytes=unmerged_bytes, seconds=seconds)


def run_timeline(scn: DriftScenario, with_loop: bool, n_periods: int = N_PERIODS,
                 drift_period: int = DRIFT_PERIOD, plan0: Optional[MergePlan] = None):
    """One serving timeline over ``n_periods`` sampling periods; drift is
    injected at the start of ``drift_period``.  ``plan0`` reuses a decoded
    initial plan instead of planning again.  Returns (rows, info)."""
    info = build_scenario(scn, plan0)
    originals, edge, eng, monitor = (info["originals"], info["edge"], info["engine"],
                                     info["monitor"])
    merged_bytes = edge.resident_bytes()
    clock = ManualClock()
    period_box = [0]
    replans: list = []

    def sample_fn(ids):
        return {m: scn.probe(period_box[0]) for m in ids}

    def replan_fn(seed_plan, excluded):
        res, _ = plan_members(scn, originals, exclude=excluded, seed_plan=seed_plan)
        replans.append(res)
        return res.plan

    controller = None
    if with_loop:
        controller = LifecycleController(
            eng, monitor, sample_fn, replan_fn, deployed_plan=info["plan0"],
            sample_period_s=PERIOD_S, clock=clock,
            hysteresis=RevertHysteresis(cooldown_s=20 * PERIOD_S, clock=clock))

    rows, events = [], []
    submitted = completed = 0
    drift_time = None
    warm = period_requests(scn, 0, 0.0)[0].payload
    for period in range(n_periods):
        period_box[0] = period
        clock.advance(PERIOD_S)
        if period == drift_period:
            # the query's ground truth changes: the cloud replaces the
            # ORIGINAL model of this feed, and the merged weights now
            # disagree with it (what §5.1 step 4 samples for)
            originals[scn.drifted] = scn.drifted_original
            drift_time = clock()
        reqs = period_requests(scn, period, clock())
        for r in reqs:
            eng.submit(r)
        submitted += len(reqs)
        if controller is not None:
            events.extend(controller.tick())
        stats = eng.serve(horizon_s=60.0, warmup=(warm if period == 0 else None))
        completed += stats["completed"]
        probe = scn.probe(period)
        with torch.no_grad():
            accs = {m: float(monitor.models[m].accuracy_fn(edge.materialize_cached(m), probe))
                    for m in scn.mids}
        rows.append({
            "period": period,
            "t_s": clock(),
            "state": controller.state if controller else "static",
            "mean_agreement": float(np.mean(list(accs.values()))),
            "breached_query_agreement": accs[scn.drifted],
            "resident_bytes": edge.resident_bytes(),
            "agreement": accs,
        })

    info.update(controller=controller, events=events, replans=replans,
                merged_bytes=merged_bytes, drift_time=drift_time, submitted=submitted,
                completed=completed, rows=rows)
    return rows, info


def simulator_lag_view(cloud, mids, drifted, degraded: float, recover_s: float) -> dict:
    """The discrete-event view of the same story: effective accuracy over a
    60 s horizon with the breached query stepping down at 20 s, (a) never
    adapting vs (b) stepping back up after the measured time to recover.
    ``cloud`` is the planned (merged) cloud store."""
    insts = instances_from_store(cloud, "tiny-yolo", model_ids=list(mids))
    costs = {"tiny-yolo": costs_for("tiny-yolo")}
    batches = {m: 1 for m in mids}
    drift_ms = 20_000.0

    def score(events):
        return simulate(Scheduler(insts, 10 ** 9, costs), batches, horizon_ms=60_000.0,
                        drift_events=events).overall_accuracy

    down = DriftEvent(drift_ms, drifted, degraded)
    up = DriftEvent(drift_ms + recover_s * 1000.0, drifted, 1.0)
    return {
        "sim_accuracy_no_adapt": score([down]),
        "sim_accuracy_with_loop": score([down, up]),
        "sim_accuracy_no_drift": score(None),
    }


def evaluate(scn: DriftScenario, n_periods: int = N_PERIODS, drift_period: int = DRIFT_PERIOD,
             sim: bool = True) -> tuple:
    """Both timelines (the static one reuses the loop timeline's decoded
    initial plan), one more deterministic trace served after the swap and
    replayed (``verify_bitwise``), and a cold re-plan for the
    warm-start comparison.  Returns (rows, derived, loop info, static info);
    ``derived`` carries the ``scripts/ci.sh`` drift gates' quantities."""
    loop_rows, loop = run_timeline(scn, True, n_periods, drift_period)
    static_rows, static = run_timeline(scn, False, n_periods, drift_period, plan0=loop["plan0"])
    ctl, eng, edge = loop["controller"], loop["engine"], loop["edge"]
    breach_ev = next(e for e in ctl.events if e.state == BREACHED)
    revert_ev = next(e for e in ctl.events if e.state == REVERTED)
    degraded = breach_ev.detail["checked"][scn.drifted]

    since = len(eng.completions)
    extra = period_requests(scn, n_periods, loop_rows[-1]["t_s"])
    for r in extra:
        eng.submit(r)
    eng.serve(horizon_s=60.0)
    loop["post_swap_requests"] = extra
    mismatches: list = []
    bitwise, bank_gap, _ = verify_bitwise(eng, edge, buckets=BUCKETS, since=since,
                                          gaps=mismatches)

    saved_pre = loop["unmerged_bytes"] - loop["merged_bytes"]
    saved_post = loop["unmerged_bytes"] - edge.resident_bytes()
    recover_s = ctl.last_recover_s if ctl.last_recover_s is not None else math.inf
    # warm-start value: a cold re-plan over the same post-drift originals
    # (only its attempts are read, so its plan carries no weights)
    cold, _ = plan_members(scn, loop["originals"], exclude={scn.drifted}, plan_weights=False)
    after_drift = [r["breached_query_agreement"] for r in static_rows[drift_period:]]
    rows = [{**{k: v for k, v in lr.items() if k != "agreement"},
             "static_mean_agreement": sr["mean_agreement"],
             "static_breached_query_agreement": sr["breached_query_agreement"]}
            for lr, sr in zip(loop_rows, static_rows)]
    derived = {
        "models": len(scn.mids),
        "sample_period_s": PERIOD_S,
        "drift_t_s": loop["drift_time"],
        "breach_detect_s": breach_ev.time - loop["drift_time"],
        "breach_detect_periods": math.ceil((breach_ev.time - loop["drift_time"]) / PERIOD_S),
        "degraded_agreement": degraded,
        "revert_epoch_bumps": revert_ev.detail["epoch_bumps"],
        "revert_same_tick": revert_ev.time == breach_ev.time,
        "pending_at_revert": revert_ev.detail["pending_requests"],
        "reverts": ctl.reverts,
        "swaps": ctl.swaps,
        "time_to_recover_s": recover_s,
        "post_swap_bitwise": bitwise,
        "post_swap_mismatches": mismatches,
        "post_swap_bank_gap": bank_gap,
        "post_swap_bank_gap_tol": (0.0 if extra[0].payload.device.type == "cpu"
                                   else BANK_GAP_TOL[getattr(scn.cfg, "dtype", "float32")]),
        "all_requests_served": (len(eng.completions) == loop["submitted"] + len(extra)
                                and eng.skipped == 0),
        "skipped": eng.skipped,
        "saved_bytes_pre_drift": saved_pre,
        "saved_bytes_post_swap": saved_post,
        "savings_restored_frac": saved_post / max(saved_pre, 1),
        "final_agreement_with_loop": loop_rows[-1]["mean_agreement"],
        "final_agreement_static": static_rows[-1]["mean_agreement"],
        "static_breached_max_after_drift": max(after_drift),
        "warm_start_attempts": loop["replans"][0].attempted if loop["replans"] else None,
        "cold_replan_attempts": cold.attempted,
    }
    if sim:
        derived.update(simulator_lag_view(loop["cloud"], scn.mids, scn.drifted, degraded,
                                          recover_s))
    return rows, derived, loop, static


def gates(d: dict) -> dict:
    """The drift acceptance gates of ``scripts/ci.sh`` (the simulator's
    where ``d`` has it), with the revert's tick, epoch bump and queued
    requests, one revert and one swap, warm <= cold attempts and the static
    lane left under target."""
    g = {
        "breach_detect_periods <= 1": d["breach_detect_periods"] <= 1,
        "revert in the breach's tick": d["revert_same_tick"],
        "revert_epoch_bumps == 1": d["revert_epoch_bumps"] == 1,
        "pending_at_revert > 0": d["pending_at_revert"] > 0,
        "reverts == 1": d["reverts"] == 1,
        "swaps == 1": d["swaps"] == 1,
        "time_to_recover_s == 2 periods": d["time_to_recover_s"] == 2 * d["sample_period_s"],
        "post_swap_bitwise": d["post_swap_bitwise"],
        "post_swap_bank_gap <= tol": d["post_swap_bank_gap"] <= d["post_swap_bank_gap_tol"],
        "savings_restored_frac >= 0.8": d["savings_restored_frac"] >= 0.8,
        "all_requests_served": d["all_requests_served"] and d["skipped"] == 0,
        "warm_start_attempts <= cold": d["warm_start_attempts"] <= d["cold_replan_attempts"],
        "static lane stays under target": d["static_breached_max_after_drift"] < TARGET,
    }
    if "sim_accuracy_with_loop" in d:
        g["sim_accuracy_with_loop > no_adapt"] = (d["sim_accuracy_with_loop"]
                                                  > d["sim_accuracy_no_adapt"])
    return g


def run(scn: Optional[DriftScenario] = None, device=None) -> dict:
    scn = numpy_scenario(device=device) if scn is None else scn
    rows, derived, _, _ = evaluate(scn)
    return emit("BENCH_drift", rows, derived)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    out = run(device=args.device)
    check_gates("drift-adapt", gates(out["derived"]))


if __name__ == "__main__":
    main()
