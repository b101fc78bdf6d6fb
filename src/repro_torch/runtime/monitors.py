"""Runtime health: heartbeats, stragglers, failure recovery, and the
queue and cadence monitors of the serving tiers (the port of
``repro.runtime.monitors``; pure Python, the JAX package's arithmetic).

* :class:`HeartbeatMonitor` / :class:`StragglerMonitor` — the trainer's
  monitors (``Trainer(monitors=...)`` ticks them every step);
* :class:`FailurePolicy` — on worker loss, a new mesh from the survivors,
  the latest checkpoint restored and resharded onto it;
* :class:`SampleCadence` — the periodic trigger of the drift-sampling loop
  (§5.1 step 4) that ``serving.lifecycle.LifecycleController`` asks between
  serve passes;
* :class:`QueueDepthMonitor` / :class:`ShedRateMonitor` — queue health of
  the ingestion front end's bounded admission queues.

Every monitor takes its clock as an argument, so tests drive it
deterministically; the policies run against an injected clock and
topology, the interfaces a real launcher would drive.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional


@dataclasses.dataclass
class HeartbeatMonitor:
    """Workers report per-step heartbeats; silence > timeout marks them dead.
    ``on_failure(worker_id)`` typically triggers the elastic re-mesh path."""

    n_workers: int
    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic
    on_failure: Optional[Callable] = None

    def __post_init__(self):
        now = self.clock()
        self.last_seen = {w: now for w in range(self.n_workers)}
        self.dead: set = set()

    def beat(self, worker_id: int):
        if worker_id in self.dead:
            self.dead.discard(worker_id)  # rejoin after restart
        self.last_seen[worker_id] = self.clock()

    def check(self) -> set:
        now = self.clock()
        newly = {w for w, t in self.last_seen.items()
                 if w not in self.dead and now - t > self.timeout_s}
        for w in newly:
            self.dead.add(w)
            if self.on_failure:
                self.on_failure(w)
        return newly

    @property
    def alive(self) -> int:
        return self.n_workers - len(self.dead)

    def tick(self, step: int, metrics: dict):  # Trainer monitor API
        self.beat(0)
        self.check()


@dataclasses.dataclass
class SampleCadence:
    """Clock-injected periodic trigger: the lifecycle controller asks
    ``due()`` between serve passes and ``mark()``s the boundary it acted on.
    Boundaries stay anchored to the schedule (late ticks don't accumulate
    phase drift); falling more than one period behind realigns to now
    instead of firing a burst of catch-up samples."""

    period_s: float
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self._next = self.clock() + self.period_s

    def due(self) -> bool:
        return self.clock() >= self._next

    def mark(self) -> None:
        self._next += self.period_s
        now = self.clock()
        if self._next <= now:
            self._next = now + self.period_s


STRAGGLER_WINDOW = 32  # step times in the rolling median


@dataclasses.dataclass
class StragglerMonitor:
    """Flags steps slower than ``threshold`` x the rolling-median step time.

    Mitigation policy at scale: (1) within-pod stragglers are absorbed by the
    synchronous collective (no action, logged); (2) a persistently slow pod
    (>= ``evict_after`` consecutive flags) is evicted via the same elastic
    path as a failure — better to lose 1/N compute than run at its speed.
    """

    threshold: float = 2.0
    evict_after: int = 5
    on_evict: Optional[Callable] = None

    def __post_init__(self):
        self.times: deque = deque(maxlen=STRAGGLER_WINDOW)
        self.flags = 0
        self.events: list = []

    def tick(self, step: int, metrics: dict):
        dt = metrics.get("step_time")
        if dt is None:
            return
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.threshold * med:
                self.flags += 1
                self.events.append({"step": step, "time": dt, "median": med})
                if self.flags >= self.evict_after and self.on_evict:
                    self.on_evict(step)
                    self.flags = 0
            else:
                self.flags = 0
        self.times.append(dt)


@dataclasses.dataclass
class QueueDepthMonitor:
    """Per-camera admission-queue depth watchdog for the ingestion front
    end.  ``observe`` records one camera's depth; a depth above ``bound``
    counts a breach.  With correctly
    bounded admission queues (capacity <= bound) breaches are impossible —
    the monitor is the tripwire proving it."""

    bound: int
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self.high_water: dict = {}  # camera -> max observed depth
        self.breaches: list = []  # (now, camera, depth)

    def observe(self, camera: str, depth: int = 0, now: Optional[float] = None, **_) -> None:
        now = self.clock() if now is None else now
        if depth > self.high_water.get(camera, -1):
            self.high_water[camera] = depth
        if depth > self.bound:
            self.breaches.append((now, camera, depth))

    @property
    def max_depth(self) -> int:
        return max(self.high_water.values(), default=0)

    @property
    def bounded(self) -> bool:
        return not self.breaches


SHED_THRESHOLD = 0.25  # shed fraction over the window that flags overload


@dataclasses.dataclass
class ShedRateMonitor:
    """Windowed shed-rate watch over the admission queues: ``observe`` takes
    each camera's CUMULATIVE offered/shed counters, differences them
    internally, and flags ``overloaded`` cameras whose shed fraction over
    the last ``window`` observations exceeds ``SHED_THRESHOLD`` — the signal to
    escalate policy (drop-oldest -> degrade) or re-plan for a cheaper
    configuration."""

    window: int = 16
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self._last: dict = {}  # camera -> (offered, shed)
        self._deltas: dict = {}  # camera -> deque[(d_offered, d_shed)]
        self.overloaded: set = set()
        self.events: list = []

    def observe(self, camera: str, offered: int = 0, shed: int = 0,
                now: Optional[float] = None, **_) -> None:
        now = self.clock() if now is None else now
        last_o, last_s = self._last.get(camera, (0, 0))
        self._last[camera] = (offered, shed)
        dq = self._deltas.setdefault(camera, deque(maxlen=self.window))
        dq.append((offered - last_o, shed - last_s))
        d_off = sum(d for d, _ in dq)
        d_shed = sum(s for _, s in dq)
        rate = d_shed / max(d_off, 1)
        was = camera in self.overloaded
        if rate > SHED_THRESHOLD and d_off > 0:
            self.overloaded.add(camera)
            if not was:
                self.events.append({"time": now, "camera": camera, "rate": rate,
                                    "edge": "overloaded"})
        elif was:
            self.overloaded.discard(camera)
            self.events.append({"time": now, "camera": camera, "rate": rate,
                                "edge": "recovered"})

    def shed_rate(self, camera: str) -> float:
        dq = self._deltas.get(camera, ())
        d_off = sum(d for d, _ in dq)
        return sum(s for _, s in dq) / max(d_off, 1)


@dataclasses.dataclass
class FailurePolicy:
    """Orchestrates recovery: on worker loss, choose a new mesh from the
    survivors (``distributed.elastic.plan_for_devices``), restore the latest
    checkpoint with reshard-on-load, and resume.  ``simulate`` drives the
    whole path without the lost hardware."""

    total_devices: int
    model_parallel: int
    ckpt_manager: object = None
    pod_size: int = 0

    def recover_plan(self, failed_devices: int):
        from repro_torch.distributed.elastic import plan_for_devices

        survivors = self.total_devices - failed_devices
        # keep whole multiples of the model-parallel degree
        usable = (survivors // self.model_parallel) * self.model_parallel
        return plan_for_devices(usable, self.model_parallel, self.pod_size)

    def simulate(self, state, rules_factory, failed_devices: int):
        """``rules_factory(plan) -> LogicalRules`` for the surviving mesh.
        Returns (the state resharded onto it, the plan)."""
        from repro_torch.ckpt.reshard import reshard_state

        plan = self.recover_plan(failed_devices)
        rules = rules_factory(plan)
        if self.ckpt_manager is not None:
            restored = self.ckpt_manager.restore_latest(device=rules.mesh.primary)
            if restored is not None:
                state = restored
        return reshard_state(state, rules), plan
