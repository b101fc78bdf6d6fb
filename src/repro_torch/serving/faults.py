"""Deterministic fault injection for the serving stack (the port of
``repro.serving.faults``, pure Python).

Four faults the ingestion front end and the engine are hardened against,
each step-indexed (no wall clock, no randomness), so every fault run
replays exactly:

* ``stall`` — the engine serves nothing for N steps; load accumulates in
  the *bounded* admission queues and sheds by policy;
* ``slow_kernel`` — service capacity divided by ``factor`` for N steps;
* ``swap_failure`` — ``ParamStore.apply_plan`` raises mid-flight AFTER
  committing a prefix of the plan's column rebinds (buffers and bindings
  partially mutated, epoch NOT bumped); ``MergeAwareEngine.apply_plan``
  must roll back atomically (one epoch bump, queues untouched) and raise
  ``PlanApplyError``, which ``LifecycleController`` absorbs;
* ``camera_disconnect`` — a source quiesces for N steps then reconnects,
  realigned to *now* (no stale catch-up burst).

:meth:`FaultInjector.arm_swap_failure` is a one-shot patch of one store's
``apply_plan`` that fires on the next call and restores the original
method as it fires — the test harness reaching into the seam, not a change
to the store.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

STALL = "stall"
SLOW_KERNEL = "slow_kernel"
SWAP_FAILURE = "swap_failure"
CAMERA_DISCONNECT = "camera_disconnect"
# the kinds a Fault schedules; a swap failure is armed on a store instead
# (FaultInjector.arm_swap_failure), and SWAP_FAILURE names it in the log
FAULT_KINDS = (STALL, SLOW_KERNEL, CAMERA_DISCONNECT)


class FaultError(RuntimeError):
    """Raised by an injected fault (distinguishable from organic failures)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.  ``at_step`` indexes front-end pump steps;
    ``duration_steps`` is how many steps it stays active (stall /
    slow_kernel / camera_disconnect).  ``factor`` divides the service budget
    for slow_kernel; ``camera`` names the source for camera_disconnect."""

    kind: str
    at_step: int = 0
    duration_steps: int = 1
    factor: float = 4.0
    camera: Optional[str] = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.kind == CAMERA_DISCONNECT and self.camera is None:
            raise ValueError("camera_disconnect needs camera=")

    def active(self, step: int) -> bool:
        return self.at_step <= step < self.at_step + self.duration_steps


class FaultInjector:
    """Deterministic fault orchestrator for one front-end run.  The front
    end calls :meth:`begin_step` at every step boundary (driving camera
    disconnect/reconnect), then :meth:`stalled` / :meth:`service_factor` to
    shape that step's dispatch.  ``events`` logs every transition."""

    def __init__(self, faults: list = ()):  # list[Fault]
        self.faults = list(faults)
        self.events: list = []
        self._swap_armed: Optional[tuple] = None  # (store, original, k)
        self._disconnected: set = set()

    # -- step-boundary hooks ---------------------------------------------------

    def begin_step(self, step: int, now: float, sources: dict) -> None:
        """Drive camera faults; log stall/slow transitions."""
        for f in self.faults:
            if f.kind == CAMERA_DISCONNECT:
                src = sources.get(f.camera)
                if src is None:
                    continue
                key = (id(f), f.camera)
                if f.active(step) and key not in self._disconnected:
                    src.disconnect()
                    self._disconnected.add(key)
                    self.events.append({"step": step, "fault": f.kind, "camera": f.camera,
                                        "edge": "down"})
                elif not f.active(step) and key in self._disconnected:
                    src.reconnect(now)
                    self._disconnected.discard(key)
                    self.events.append({"step": step, "fault": f.kind, "camera": f.camera,
                                        "edge": "up"})
            elif f.active(step) and f.at_step == step:
                self.events.append({"step": step, "fault": f.kind, "edge": "start",
                                    "duration": f.duration_steps})

    def stalled(self, step: int) -> bool:
        return any(f.kind == STALL and f.active(step) for f in self.faults)

    def service_factor(self, step: int) -> float:
        """Product of every active slow-kernel factor (>= 1.0)."""
        factor = 1.0
        for f in self.faults:
            if f.kind == SLOW_KERNEL and f.active(step):
                factor *= f.factor
        return factor

    # -- swap failure ----------------------------------------------------------

    def arm_swap_failure(self, store, fail_after_columns: int = 1) -> None:
        """One-shot: the NEXT ``store.apply_plan`` call commits the first
        ``fail_after_columns`` columns' buffers and bindings, then raises
        :class:`FaultError` with the epoch NOT bumped — the partial mutation
        ``MergeAwareEngine.apply_plan``'s rollback must survive.  The
        original method is restored as the fault fires (or by
        :meth:`disarm`)."""
        if self._swap_armed is not None:
            raise RuntimeError("swap failure already armed")
        original = store.apply_plan
        injector = self

        def failing_apply_plan(plan):
            store.apply_plan = original  # one-shot: restore before raising
            injector._swap_armed = None
            k = 0
            for pg in plan.groups:
                for col in pg.columns:
                    if k >= fail_after_columns:
                        injector.events.append({"fault": SWAP_FAILURE, "edge": "raise",
                                                "columns_committed": k})
                        raise FaultError(f"injected swap failure after {k} columns")
                    dm, dp = col.donor
                    store.buffers[col.key] = store.buffers[store.bindings[dm][dp]]
                    for r in col.members:
                        store.bindings[r.model_id][r.path] = col.key
                    k += 1
            # a plan smaller than the failure point fails at the very end,
            # everything mutated and no epoch bump — still mid-flight
            injector.events.append({"fault": SWAP_FAILURE, "edge": "raise",
                                    "columns_committed": k})
            raise FaultError(f"injected swap failure after {k} columns")

        store.apply_plan = failing_apply_plan
        self._swap_armed = (store, original, fail_after_columns)

    def disarm(self) -> None:
        """Restore a still-armed swap failure (the fault never fired)."""
        if self._swap_armed is not None:
            store, original, _ = self._swap_armed
            store.apply_plan = original
            self._swap_armed = None
