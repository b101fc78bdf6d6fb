"""Drift-adapt lifecycle loop (paper §5.1 steps 4-5; the port of
``repro.serving.lifecycle``, pure Python, the JAX package's transitions).

GEMEL's accuracy story is a *closed loop*: edge boxes sample frames, the
cloud detects per-query accuracy breaches against the original models,
edge inference reverts the breached model to its original weights, and
merging resumes from the previously deployed state.
:class:`LifecycleController` closes that loop over a live
:class:`~repro_torch.serving.executor.MergeAwareEngine` as a state machine:

    serving --(breach)--> breached -> reverted -> re-planning -> swapped
       ^                                                            |
       +------------------------------------------------------------+

* **serving** — every ``sample_period_s`` (clock-injected
  :class:`~repro_torch.runtime.monitors.SampleCadence`), run
  ``DriftMonitor.check`` on freshly sampled frames; checks ride the serve
  cache (no epoch bump, no rebuild).
* **breached → reverted** — in the SAME tick as detection, through
  ``MergeAwareEngine.revert`` (one epoch bump; queued requests survive).
  Every revert feeds the :class:`RevertHysteresis` storm guard.
* **re-planning** — a warm-started ``StagedPlanner`` resumes from the
  previously deployed plan (``seed_plan=``), excluding breached and
  quarantined members (``exclude_models=``); the engine keeps serving the
  reverted configuration meanwhile.
* **swapped** — the re-planned configuration hot-swaps through
  ``MergeAwareEngine.apply_plan``; a failed swap is rolled back by the engine and the loop keeps serving
  the prior plan.

Every transition timestamp comes from the injected ``clock``;
:meth:`LifecycleController.resume_state` serializes the "resume from the
last deployed state" artifact (:class:`~repro_torch.core.drift.ResumeState`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.core.drift import DriftMonitor, ResumeState
from repro_torch.runtime.monitors import SampleCadence
from repro_torch.serving.executor import PlanApplyError

SERVING = "serving"
BREACHED = "breached"
REVERTED = "reverted"
REPLANNING = "re-planning"
SWAPPED = "swapped"
# revert-storm escalation: reverts of one model within REVERT_WINDOW_S
# multiply its quarantine by REVERT_BACKOFF each
REVERT_WINDOW_S = 600.0
REVERT_BACKOFF = 4.0


@dataclasses.dataclass
class LifecycleEvent:
    """One state-machine transition: the state *entered*, when (controller
    clock) and the transition's payload."""

    time: float
    state: str
    detail: dict


@dataclasses.dataclass
class RevertHysteresis:
    """Revert-storm guard: each revert quarantines the model from
    re-planning for ``cooldown_s``; reverts recurring within
    ``REVERT_WINDOW_S`` escalate the quarantine geometrically
    (``REVERT_BACKOFF``), so a flapping query converges to staying unmerged
    instead of thrashing the planner."""

    cooldown_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self.history: dict = {}  # model_id -> [revert timestamps]
        self._until: dict = {}  # model_id -> quarantined-until timestamp

    def record(self, model_id: str) -> float:
        """Register a revert; returns the cooldown applied."""
        now = self.clock()
        recent = [t for t in self.history.get(model_id, []) if now - t <= REVERT_WINDOW_S]
        recent.append(now)
        self.history[model_id] = recent
        cool = self.cooldown_s * (REVERT_BACKOFF ** (len(recent) - 1))
        self._until[model_id] = now + cool
        return cool

    def excluded(self) -> set:
        """Model ids currently quarantined from re-planning."""
        now = self.clock()
        return {m for m, t in self._until.items() if now < t}

    def restore(self, history: dict) -> None:
        """Rebuild quarantine state from a serialized revert history
        (:attr:`ResumeState.revert_history`), replaying the escalation rule
        against each model's most recent revert."""
        self.history = {m: list(ts) for m, ts in history.items()}
        self._until = {}
        for mid, ts in self.history.items():
            if not ts:
                continue
            last = max(ts)
            recent = [t for t in ts if last - t <= REVERT_WINDOW_S]
            self._until[mid] = last + self.cooldown_s * (REVERT_BACKOFF ** (len(recent) - 1))


class LifecycleController:
    """Wires DriftMonitor → revert → warm-start re-plan → hot swap over a
    live engine.

    ``sample_fn(model_ids) -> {model_id: batch}`` supplies the sampled edge
    frames (§5.1 step 4).  ``replan_fn(seed_plan, excluded) -> MergePlan |
    None`` owns the cloud side; returning ``None`` (or an empty plan) skips
    the swap and the loop returns to serving the reverted configuration.

    :meth:`tick` advances AT MOST one transition and is meant to be called
    from the serve loop between passes: detection and revert land in the
    tick that sampled the breach, re-planning and the swap occupy the next
    ticks — the adaptation lag ``bench/drift_adapt.py`` measures."""

    def __init__(
        self,
        engine,  # MergeAwareEngine
        monitor: DriftMonitor,
        sample_fn: Callable,
        replan_fn: Callable,
        *,
        deployed_plan=None,
        sample_period_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        hysteresis: Optional[RevertHysteresis] = None,
    ):
        self.engine = engine
        self.monitor = monitor
        self.sample_fn = sample_fn
        self.replan_fn = replan_fn
        self.deployed_plan = deployed_plan
        self.clock = clock
        self.cadence = SampleCadence(sample_period_s, clock=clock)
        self.hysteresis = hysteresis or RevertHysteresis(clock=clock)
        self.state = SERVING
        self.events: list = []
        self.checks = 0
        self.reverts = 0
        self.swaps = 0
        self.failed_swaps = 0
        self.last_recover_s: Optional[float] = None
        self._pending_plan = None
        self._breach_time: Optional[float] = None

    # -- state machine ---------------------------------------------------------

    def tick(self) -> list:
        """Advance by at most one transition; returns the events emitted."""
        n0 = len(self.events)
        if self.state == SERVING:
            self._tick_serving()
        elif self.state == REVERTED:
            self._tick_replan()
        elif self.state == REPLANNING:
            self._tick_swap()
        return self.events[n0:]

    def _emit(self, state: str, **detail) -> LifecycleEvent:
        ev = LifecycleEvent(self.clock(), state, detail)
        self.events.append(ev)
        return ev

    def _tick_serving(self) -> None:
        if not self.cadence.due():
            return
        self.cadence.mark()
        report = self.monitor.check(self.sample_fn(sorted(self.monitor.models)))
        self.checks += 1
        if not report.breached:
            return
        self._breach_time = self.clock()
        self._emit(BREACHED, checked=dict(report.checked), breached=sorted(report.breached))
        # revert IMMEDIATELY — the same sampling period as the detection; the
        # engine keeps its queues (no drain) and its next pass re-plans the
        # prefix groups at the new epoch
        r = self.engine.revert(self.monitor, report)
        self.reverts += len(report.reverted)
        for mid in sorted(report.reverted):
            self.hysteresis.record(mid)
        self.state = REVERTED
        self._emit(REVERTED, **r)

    def _tick_replan(self) -> None:
        excluded = self.hysteresis.excluded()
        plan = self.replan_fn(self.deployed_plan, excluded)
        self._pending_plan = plan
        self.state = REPLANNING
        # the JAX package's event; the port's planner has no budget to time out
        self._emit(REPLANNING, excluded=sorted(excluded), replan_timed_out=False,
                   groups=0 if plan is None else len(plan.groups))

    def _tick_swap(self) -> None:
        plan, self._pending_plan = self._pending_plan, None
        if plan is None or not plan.groups:
            # nothing to deploy: keep serving the reverted state
            self.state = SERVING
            self._emit(SERVING, swapped=False)
            return
        try:
            swap = self.engine.apply_plan(plan)
        except PlanApplyError as exc:
            # the engine already rolled the store back (one epoch bump,
            # queues intact); the loop keeps serving the PRIOR deployed plan
            self.failed_swaps += 1
            self.state = SERVING
            self._emit(SERVING, swapped=False, swap_failed=True, error=str(exc),
                       pending_requests=sum(len(q) for q in self.engine.queues.values()))
            return
        self.deployed_plan = plan
        self.swaps += 1
        self.last_recover_s = (self.clock() - self._breach_time
                               if self._breach_time is not None else None)
        self.state = SERVING
        self._emit(SWAPPED, recover_s=self.last_recover_s,
                   shared_keys=len(swap["shared_keys"]),
                   **{k: v for k, v in swap.items() if k != "shared_keys"})

    # -- resume-state round trip -----------------------------------------------

    def resume_state(self) -> ResumeState:
        """Serializable "merging resumes from the previously deployed state"
        snapshot (§5.1 step 5): deployed plan + current exclusions + revert
        history."""
        return ResumeState(
            self.deployed_plan.to_json() if self.deployed_plan else None,
            tuple(sorted(self.hysteresis.excluded())),
            {m: list(ts) for m, ts in self.hysteresis.history.items()},
            self.engine.store.epoch,
        )

    def restore(self, state: ResumeState) -> None:
        """Adopt a serialized resume state: the deployed plan becomes the
        warm-start seed of the next re-plan and the revert history rebuilds
        the hysteresis quarantine."""
        self.deployed_plan = state.plan()
        self.hysteresis.restore(state.revert_history)
