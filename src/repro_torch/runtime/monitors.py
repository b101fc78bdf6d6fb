"""Clock-injected runtime monitors (the port of ``repro.runtime.monitors``;
pure Python, the JAX package's arithmetic).

* :class:`SampleCadence` — the periodic trigger of the drift-sampling loop
  (§5.1 step 4) that ``serving.lifecycle.LifecycleController`` asks between
  serve passes;
* :class:`QueueDepthMonitor` / :class:`ShedRateMonitor` — queue health of
  the ingestion front end's bounded admission queues.

Every monitor takes its clock as an argument, so tests drive it
deterministically.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional


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
