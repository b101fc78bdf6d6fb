"""Overload-hardened ingestion front end (the port of
``repro.serving.ingestion``).

Real edge traffic is per-camera frame streams that do not stop arriving
when the box is busy.  This layer puts *admission* in front of
:class:`~repro_torch.serving.executor.MergeAwareEngine`: bounded per-camera
queues, explicit shed policies under overload, and a cascade path where a
cheap gating model decides whether the heavy merged group runs at all.

* :class:`CameraSource` — deterministic, clock-driven frame stream for one
  feed (payloads from a pure ``frame_fn(index)``); ``disconnect`` /
  ``reconnect`` model a flapping camera, reconnection realigning to *now*.
* :class:`AdmissionQueue` — one bounded queue per camera with a policy:
  ``drop-oldest``, ``drop-newest`` or ``degrade`` (above the high-water
  mark only gate-positive frames reach the heavy path; negatives complete
  with the gate's answer).  Every disposition is counted.
* :class:`CascadeGate` — the cheap gating model: any batched score function
  over frame payloads.  :meth:`CascadeGate.fit_prefix_probe` builds one
  from a merged group's SHARED trunk prefix (a closed-form class-mean probe
  on mean-pooled trunk features), run under ``torch.no_grad()`` on the
  params' device.  Observed per-camera hit rates feed
  :class:`~repro_torch.core.policy.CascadeProfile`.
* :class:`IngestionFrontEnd` — the pump: each :meth:`IngestionFrontEnd.step`
  advances the logical clock, polls every source, gates/admits arrivals,
  dispatches at most ``service_budget`` frames into the engine and drains
  it.  A :class:`~repro_torch.serving.faults.FaultInjector` hooks the step
  boundary.

The accounting identity the fault harness gates on:

    offered == completed + gate_completed + shed(oldest|newest|expired)
               + dropped_expired(engine) + pending(admission) + pending(engine)

— zero frames lost, under every fault.  Arrivals run on the front end's
deterministic logical clock (``now_s``); service inside one step runs on
the engine's clock (deadlines are rewritten to the *remaining* SLA budget
at dispatch).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.serving.executor import Request
from repro_torch.serving.workload import bucket_for, pad_stack

DROP_OLDEST = "drop-oldest"
DROP_NEWEST = "drop-newest"
DEGRADE = "degrade"
POLICIES = (DROP_OLDEST, DROP_NEWEST, DEGRADE)
SERVE_HORIZON_S = 30.0  # engine clock budget of one step's drain


# ---------------------------------------------------------------------------
# Camera sources
# ---------------------------------------------------------------------------


class CameraSource:
    """Deterministic frame stream for one camera feed.  ``poll(now)`` emits
    every frame due since the last poll as a ``Request`` with
    ``meta=(instance_id, frame_index)``; ``fps`` is frames per logical
    second."""

    def __init__(self, instance_id: str, fps: float, frame_fn: Callable,
                 sla_s: float = 60.0, start_s: float = 0.0):
        self.instance_id = instance_id
        self.fps = fps
        self.frame_fn = frame_fn
        self.sla_s = sla_s
        self.connected = True
        self._next_due = start_s
        self._index = 0
        self.emitted = 0
        self.disconnects = 0

    def poll(self, now: float) -> list:
        """Requests for every frame due in (last poll, now]; a disconnected
        source emits nothing."""
        if not self.connected:
            return []
        out = []
        interval = 1.0 / self.fps
        while self._next_due <= now:
            out.append(Request(self.instance_id, self.frame_fn(self._index),
                               arrival_s=self._next_due,
                               deadline_s=self._next_due + self.sla_s,
                               meta=(self.instance_id, self._index)))
            self._index += 1
            self._next_due += interval
        self.emitted += len(out)
        return out

    def disconnect(self) -> None:
        """Quiesce: no frames until :meth:`reconnect`."""
        if self.connected:
            self.connected = False
            self.disconnects += 1

    def reconnect(self, now: float) -> None:
        """Resume the stream ANCHORED AT NOW: the outage's frames are gone
        (a camera does not buffer), so no catch-up burst reaches admission."""
        if not self.connected:
            self.connected = True
            self._next_due = max(self._next_due, now)


# ---------------------------------------------------------------------------
# Bounded admission queues
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdmissionQueue:
    """Bounded FIFO in front of one camera's engine queue, with an explicit
    overload policy.  All shed paths are counted."""

    camera: str
    capacity: int
    policy: str = DROP_OLDEST

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; one of {POLICIES}")
        self.q: deque = deque()
        self.offered = 0
        self.admitted = 0
        self.shed_oldest = 0
        self.shed_newest = 0
        self.shed_expired = 0
        self.max_depth = 0

    @property
    def depth(self) -> int:
        return len(self.q)

    def __len__(self) -> int:
        return len(self.q)

    def offer(self, req: Request) -> str:
        """Admit under the policy; returns ``admitted`` or ``shed``.
        (``degrade`` admits like drop-oldest: the gate decides *upstream*,
        in the front end, whether a frame reaches the queue at all.)"""
        self.offered += 1
        if len(self.q) >= self.capacity:
            if self.policy == DROP_NEWEST:
                self.shed_newest += 1
                return "shed"
            self.q.popleft()  # drop-oldest / degrade: freshness-preserving
            self.shed_oldest += 1
        self.q.append(req)
        self.admitted += 1
        self.max_depth = max(self.max_depth, len(self.q))
        return "admitted"

    def expire(self, now: float) -> int:
        """Drop heads whose deadline passed while waiting; counted."""
        n = 0
        while self.q and now > self.q[0].deadline_s:
            self.q.popleft()
            n += 1
        self.shed_expired += n
        return n

    def take(self, n: int) -> list:
        out = []
        while self.q and len(out) < n:
            out.append(self.q.popleft())
        return out

    @property
    def shed_total(self) -> int:
        return self.shed_oldest + self.shed_newest + self.shed_expired


# ---------------------------------------------------------------------------
# Cascade gate
# ---------------------------------------------------------------------------


def _host(scores) -> np.ndarray:
    if isinstance(scores, torch.Tensor):
        return scores.detach().cpu().numpy()
    return np.asarray(scores)


def _pooled(feats: torch.Tensor) -> torch.Tensor:
    """Mean-pool NHWC trunk features over space; flatten anything else."""
    if feats.dim() == 4:
        return feats.mean(dim=(1, 2))
    return feats.reshape(feats.shape[0], -1)


GATE_BUCKETS = (1, 2, 4, 8)  # the gate's batch ladder


class CascadeGate:
    """Cheap gating model: ``score_fn(batch) -> (B,)`` scores; a frame is
    *positive* (needs the heavy merged group) iff its score exceeds 0.
    Decisions run batched over ``GATE_BUCKETS``.  Counters track the
    observed hit rate overall and per camera."""

    def __init__(self, score_fn: Callable):
        self.score_fn = score_fn
        self.evaluated = 0
        self.positives = 0
        self.per_camera: dict = {}  # camera -> [positives, evaluated]

    def decide(self, requests: list) -> list:
        """Booleans (positive?) for a list of requests, batched."""
        out = []
        cap = GATE_BUCKETS[-1]
        for i in range(0, len(requests), cap):
            chunk = requests[i:i + cap]
            batch, n = pad_stack([r.payload for r in chunk],
                                 bucket_for(len(chunk), GATE_BUCKETS))
            scores = _host(self.score_fn(batch))[:n]
            out.extend(bool(s > 0.0) for s in scores)
        for r, pos in zip(requests, out):
            self.evaluated += 1
            self.positives += int(pos)
            pc = self.per_camera.setdefault(r.instance_id, [0, 0])
            pc[0] += int(pos)
            pc[1] += 1
        return out

    def observed_hit_rate(self, camera: Optional[str] = None) -> float:
        if camera is not None:
            pos, n = self.per_camera.get(camera, (0, 0))
            return pos / max(n, 1)
        return self.positives / max(self.evaluated, 1)

    @classmethod
    def fit_prefix_probe(cls, prefix_fn: Callable, params, frames, labels) -> "CascadeGate":
        """Closed-form gate over a merged group's SHARED trunk: mean-pool
        the prefix features and project onto the class-mean difference
        direction, thresholded at the projected class midpoint (numpy
        float32 on the host, as the JAX package computes it).  The trunk
        runs under ``torch.no_grad()`` on the device of ``frames``.
        ``frames``: (N, ...) stacked calibration frames; ``labels``: (N,)
        bools (event of interest)."""
        with torch.no_grad():
            feats = _pooled(prefix_fn(params, frames)).cpu().numpy()
        lab = np.asarray(labels, dtype=bool)
        if not lab.any() or lab.all():
            raise ValueError("fit_prefix_probe needs both classes present")
        w = feats[lab].mean(0) - feats[~lab].mean(0)
        tau = 0.5 * (float((feats[lab] @ w).mean()) + float((feats[~lab] @ w).mean()))
        w_t = torch.from_numpy(w).to(frames.device)

        def score(batch):
            with torch.no_grad():
                return _pooled(prefix_fn(params, batch)) @ w_t - tau

        return cls(score)


# ---------------------------------------------------------------------------
# The front-end pump
# ---------------------------------------------------------------------------


class IngestionFrontEnd:
    """sources -> gate -> bounded admission -> budgeted dispatch -> engine.

    One :meth:`step` = one pump iteration on the logical clock: poll
    sources, gate the step's arrivals (when the policy or
    ``cascade_always`` wants decisions), admit under the per-camera policy,
    dispatch at most the step's service budget into the engine, serve.
    Under ``degrade`` a camera's arrivals are gated once its queue holds
    half its capacity; each serve drains the engine within
    ``SERVE_HORIZON_S``.  ``monitors``: objects with ``observe(camera,
    depth=, offered=, shed=, now=)`` (``runtime.monitors.QueueDepthMonitor``
    / ``ShedRateMonitor``).
    """

    def __init__(
        self,
        engine,
        sources: list,
        policy: str = DROP_OLDEST,
        queue_capacity: int = 16,
        service_budget: int = 8,
        gate: Optional[CascadeGate] = None,
        cascade_always: bool = False,
        warmup: Any = None,
        fault_injector=None,
        monitors: tuple = (),
    ):
        if policy == DEGRADE and gate is None:
            raise ValueError("policy='degrade' needs a CascadeGate")
        if cascade_always and gate is None:
            raise ValueError("cascade_always needs a CascadeGate")
        self.engine = engine
        self.sources = {s.instance_id: s for s in sources}
        self.policy = policy
        self.queues = {s.instance_id: AdmissionQueue(s.instance_id, queue_capacity, policy)
                       for s in sources}
        self.queue_capacity = queue_capacity
        self.service_budget = service_budget
        self.high_water = queue_capacity // 2
        self.gate = gate
        self.cascade_always = cascade_always
        self.warmup = warmup
        self.injector = fault_injector
        self.monitors = tuple(monitors)
        self.now_s = 0.0
        self.step_idx = 0
        self.offered = 0
        self.dispatched = 0
        self.gate_completions: list = []  # (request, positive_decision, now_s)
        self._warmed = False
        self._completions0 = len(engine.completions)
        self._skipped0 = engine.skipped
        self.step_log: list = []

    # -- gating / admission ----------------------------------------------------

    def _gating_active(self, camera: str) -> bool:
        if self.gate is None:
            return False
        if self.cascade_always:
            return True
        return self.policy == DEGRADE and self.queues[camera].depth >= self.high_water

    def _admit(self, arrivals: list) -> dict:
        """Gate (batched) then admit the step's arrivals; returns per-step
        disposition counts.  Decisions are computed for every arrival whose
        camera *could* gate this step, but consulted per frame at its
        admission moment (degrade sheds to the gate only above high water)."""
        counts = {"admitted": 0, "gated_out": 0, "shed": 0}
        need_gate = [r for r in arrivals if self.gate is not None
                     and (self.cascade_always or self.policy == DEGRADE)]
        decisions: dict = {}
        if need_gate:
            for r, pos in zip(need_gate, self.gate.decide(need_gate)):
                decisions[id(r)] = pos
        for r in arrivals:
            self.offered += 1
            q = self.queues[r.instance_id]
            if self._gating_active(r.instance_id) and not decisions.get(id(r), True):
                # the cheap model's answer IS the result for this frame
                q.offered += 1
                self.gate_completions.append((r, False, self.now_s))
                counts["gated_out"] += 1
                continue
            disp = q.offer(r)
            counts["admitted" if disp == "admitted" else "shed"] += 1
        return counts

    # -- the pump --------------------------------------------------------------

    def step(self, dt_s: float = 1.0) -> dict:
        """One pump iteration; returns the step's accounting row."""
        self.now_s += dt_s
        step = self.step_idx
        self.step_idx += 1
        stalled = False
        factor = 1.0
        if self.injector is not None:
            self.injector.begin_step(step, self.now_s, self.sources)
            stalled = self.injector.stalled(step)
            factor = self.injector.service_factor(step)

        arrivals = []
        for src in self.sources.values():
            arrivals.extend(src.poll(self.now_s))
        arrivals.sort(key=lambda r: (r.arrival_s, r.instance_id))
        counts = self._admit(arrivals)

        expired = 0
        for q in self.queues.values():
            expired += q.expire(self.now_s)

        budget = 0 if stalled else max(0, int(self.service_budget / factor))
        taken: list = []
        order = sorted(self.queues)
        while budget > len(taken):
            progressed = False
            for cam in order:
                if len(taken) >= budget:
                    break
                got = self.queues[cam].take(1)
                if got:
                    taken.extend(got)
                    progressed = True
            if not progressed:
                break
        for r in taken:
            # rewrite onto the engine's per-call clock: the deadline becomes
            # the SLA budget REMAINING at dispatch time
            self.engine.submit(dataclasses.replace(
                r, arrival_s=0.0, deadline_s=max(r.deadline_s - self.now_s, 0.0)))
        self.dispatched += len(taken)

        served = {"completed": 0, "skipped": 0}
        if not stalled and (taken or any(len(q) for q in self.engine.queues.values())):
            warm = None
            if not self._warmed and self.warmup is not None:
                warm, self._warmed = self.warmup, True
            served = self.engine.serve(horizon_s=SERVE_HORIZON_S, warmup=warm, drain=True)

        for mon in self.monitors:
            for cam, q in self.queues.items():
                mon.observe(cam, depth=q.depth, offered=q.offered, shed=q.shed_total,
                            now=self.now_s)
        row = {
            "step": step, "now_s": self.now_s, "arrivals": len(arrivals),
            "stalled": stalled, "service_factor": factor,
            "dispatched": len(taken), "completed": served["completed"],
            "dropped_expired_engine": served.get("dropped_expired", served["skipped"]),
            "expired_admission": expired, **counts,
            "depth": {cam: q.depth for cam, q in self.queues.items()},
        }
        self.step_log.append(row)
        return row

    # -- accounting ------------------------------------------------------------

    def report(self) -> dict:
        """Aggregate accounting.  ``lost`` MUST be zero: every offered frame
        is completed (heavy or gate), shed (counted, by policy), expired
        (counted, admission or engine) or still pending somewhere."""
        completed = len(self.engine.completions) - self._completions0
        dropped_expired = self.engine.skipped - self._skipped0
        shed_oldest = sum(q.shed_oldest for q in self.queues.values())
        shed_newest = sum(q.shed_newest for q in self.queues.values())
        shed_expired = sum(q.shed_expired for q in self.queues.values())
        pending_admission = sum(q.depth for q in self.queues.values())
        pending_engine = sum(len(q) for q in self.engine.queues.values())
        gate_completed = len(self.gate_completions)
        accounted = (completed + gate_completed + shed_oldest + shed_newest + shed_expired
                     + dropped_expired + pending_admission + pending_engine)
        return {
            "offered": self.offered,
            "completed": completed,
            "gate_completed": gate_completed,
            "shed_oldest": shed_oldest,
            "shed_newest": shed_newest,
            "shed_expired": shed_expired,
            "dropped_expired": dropped_expired,
            "pending_admission": pending_admission,
            "pending_engine": pending_engine,
            "dispatched": self.dispatched,
            "max_depth": max((q.max_depth for q in self.queues.values()), default=0),
            "max_depth_by_camera": {c: q.max_depth for c, q in self.queues.items()},
            "sla_attained": (sum(1 for c in self.engine.completions[self._completions0:]
                                 if c.met_sla) + gate_completed),
            "hit_rate": self.gate.observed_hit_rate() if self.gate is not None else None,
            "lost": self.offered - accounted,
        }
