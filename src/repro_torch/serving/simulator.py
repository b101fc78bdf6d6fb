"""Discrete-event edge-inference simulator (the port of
``repro.serving.simulator``).

Faithfully reproduces the paper's serving dynamics at workload scale using
the Table 1/2 cost model: frames arrive at ``fps`` per instance, each frame
must complete within ``sla_ms`` of arrival or it is *skipped*; models are
visited in the scheduler's round-robin order; swapping in the next model is
pipelined with the current model's execution (§3.2); merging reduces both
the resident footprint (fewer swaps) and each swap's bytes (§4).

Outputs per-instance processed/skipped counts and effective accuracy
(= processed_fraction x per-model accuracy), the exact quantities behind
Figs 3, 6, 10 and Table 3.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

from repro_torch.serving.scheduler import Scheduler


@dataclasses.dataclass
class DriftEvent:
    """An injected accuracy step for one instance at a simulated time: frames
    the instance processes at/after ``at_ms`` earn ``accuracy`` credit.  A
    drifted query is one event down (content changed under a merged model);
    an *adapting* deployment adds a second event back up at breach time +
    time-to-recover — the gap between the two timelines is the adaptation
    lag a drift-adapting deployment is paid to close."""

    at_ms: float
    instance_id: str
    accuracy: float


@dataclasses.dataclass
class SimResult:
    horizon_ms: float
    processed: dict
    skipped: dict
    swap_ms_total: float
    exec_ms_total: float
    cycles: int
    accuracy: dict  # instance -> effective accuracy
    # frames the cascade gate completed WITHOUT the heavy model: they never
    # queue, earn the gate's accuracy credit, and count as
    # completed in processed_fraction
    gated: dict = dataclasses.field(default_factory=dict)

    @property
    def overall_accuracy(self) -> float:
        return sum(self.accuracy.values()) / max(len(self.accuracy), 1)

    @property
    def processed_fraction(self) -> float:
        tot_p = sum(self.processed.values()) + sum(self.gated.values())
        tot = tot_p + sum(self.skipped.values())
        return tot_p / max(tot, 1)


def effective_accuracy_objective(
    instances_fn: Callable,  # (store, committed_groups) -> list[Instance]
    costs: dict,
    capacity_bytes: int,
    batches: Optional[dict] = None,
    horizon_ms: float = 20_000.0,
    fps: float = 30.0,
    sla_ms: float = 100.0,
    drift_events: Optional[list] = None,
    cascade: Optional[dict] = None,
) -> Callable:
    """Simulator-in-the-loop plan objective for the staged planner: returns
    ``objective(store, committed_groups) -> simulate(...).overall_accuracy``
    (the Fig 6/10 quantity).  The planner then optimises what the edge box
    actually serves under the memory/latency cost model — a commit that
    saves bytes but *hurts* effective accuracy (e.g. by worsening the swap
    schedule) is rolled back — rather than raw bytes saved (MAFAT's point:
    drive the search with the cost model).

    ``cascade`` ({instance_id -> (hit_rate, gate_accuracy)}, the observed
    gate behaviour of a cascaded front end) scores candidates against the *observed*
    cascaded arrival process: only the gate-positive fraction of frames
    reaches the heavy model, gate-negatives earn the gate's credit — so the
    planner values heavy-model residency at its real traffic share."""

    def objective(store, committed_groups) -> float:
        insts = instances_fn(store, committed_groups)
        sched = Scheduler(insts, capacity_bytes, costs)
        b = batches or {i.instance_id: 1 for i in insts}
        return simulate(sched, b, horizon_ms=horizon_ms, fps=fps,
                        sla_ms=sla_ms, drift_events=drift_events,
                        cascade=cascade).overall_accuracy

    return objective


def simulate(
    scheduler: Scheduler,
    batches: dict,  # instance_id -> batch size
    horizon_ms: float = 60_000.0,
    fps: float = 30.0,
    sla_ms: float = 100.0,
    drift_events: Optional[list] = None,
    cascade: Optional[dict] = None,
) -> SimResult:
    """Event loop: visit instances round-robin; at each visit, load (evicting
    as needed, cost hidden behind the previous execution where possible),
    then run as many batches as are pending & fresh.

    ``drift_events`` injects accuracy steps (:class:`DriftEvent`): per-frame
    accuracy credit follows the value in force when the frame *finishes*, so
    the objective scores the adaptation lag between a drift and the loop's
    recovery.  Without events the closed form ``processed_fraction x
    accuracy`` is used — bit-identical to the historical accounting.

    ``cascade`` ({instance_id -> (hit_rate, gate_accuracy)}) thins each
    instance's arrivals to the gate-positive fraction DETERMINISTICALLY
    (frame ``k`` goes heavy iff ``floor((k+1)·r) > floor(k·r)`` — evenly
    spread, no RNG): gate-negative frames complete immediately with the
    gate's accuracy credit and never touch the heavy queue, so swap/SLA
    pressure reflects the cascaded arrival process."""
    order = [i.instance_id for i in scheduler.order]
    frame_interval = 1000.0 / fps
    next_frame = {i: 0.0 for i in order}  # arrival time of next frame
    queues = {i: deque() for i in order}
    processed = {i: 0 for i in order}
    skipped = {i: 0 for i in order}
    gated = {i: 0 for i in order}
    gate_credit = {i: 0.0 for i in order}
    frame_no = {i: 0 for i in order}
    swap_total = exec_total = 0.0
    t = 0.0
    prev_exec_end = 0.0  # pipelining: loads overlap previous execution
    cycles = 0
    pending_events = sorted(drift_events or [], key=lambda e: e.at_ms)
    cur_acc = {i: scheduler.instances[i].accuracy for i in order}
    credit = {i: 0.0 for i in order}

    def apply_events(now: float):
        while pending_events and pending_events[0].at_ms <= now:
            e = pending_events.pop(0)
            if e.instance_id in cur_acc:
                cur_acc[e.instance_id] = e.accuracy

    def admit_frames(now: float):
        for i in order:
            casc = (cascade or {}).get(i)
            while next_frame[i] <= now:
                if casc is not None:
                    rate, gacc = casc
                    k = frame_no[i]
                    frame_no[i] = k + 1
                    if not int((k + 1) * rate) > int(k * rate):
                        # gate-negative: the cheap model's answer IS the
                        # result — immediate completion, gate's credit
                        gated[i] += 1
                        gate_credit[i] += gacc
                        next_frame[i] += frame_interval
                        continue
                queues[i].append(next_frame[i])
                next_frame[i] += frame_interval

    def expire(now: float):
        for i in order:
            q = queues[i]
            while q and now - q[0] > sla_ms:
                q.popleft()
                skipped[i] += 1

    idx = 0
    while t < horizon_ms:
        inst_id = order[idx % len(order)]
        b = batches.get(inst_id, 1)

        # swap: starts as soon as the previous model finished *computing* —
        # execution and the next load are pipelined.
        r = scheduler.load(inst_id, b)
        load_ms = r["load_ms"]
        swap_hidden = max(prev_exec_end - t, 0.0)
        effective_load = Scheduler.overlapped_load_ms(load_ms, swap_hidden)
        swap_total += load_ms
        t += effective_load

        admit_frames(t)
        expire(t)

        # run pending frames in batches while any are fresh; at least one
        # batch attempt per visit (even if queue empty, move on)
        q = queues[inst_id]
        ran = 0
        while q and ran < 4:  # bounded service per visit to stay fair
            take = min(b, len(q))
            exec_ms = scheduler.run_time_ms(inst_id, take)
            # frames must finish within SLA
            done_t = t + exec_ms
            apply_events(done_t)
            batch_frames = [q.popleft() for _ in range(take)]
            for f in batch_frames:
                if done_t - f <= sla_ms:
                    processed[inst_id] += 1
                    credit[inst_id] += cur_acc[inst_id]
                else:
                    skipped[inst_id] += 1
            t = done_t
            exec_total += exec_ms
            ran += 1
            admit_frames(t)
            expire(t)
        prev_exec_end = t
        idx += 1
        if idx % len(order) == 0:
            cycles += 1
        # tiny scheduling overhead to guarantee progress on empty queues
        if ran == 0:
            t += 0.01
            if not any(queues[i] for i in order):
                # fully idle: nothing can happen before the next frame
                # arrives, so fast-forward instead of spinning the
                # round-robin in 0.01 ms steps (a merged store's near-zero
                # loads otherwise turn 20 s of idle horizon into ~10^6
                # event-loop iterations)
                t = max(t, min(next_frame[i] for i in order))

    # account frames that never got a chance
    expire(horizon_ms)
    acc = {}
    for i in order:
        total = processed[i] + skipped[i] + gated[i]
        if drift_events:
            acc[i] = (credit[i] + gate_credit[i]) / max(total, 1)
        else:
            heavy = processed[i] * scheduler.instances[i].accuracy
            acc[i] = (heavy + gate_credit[i]) / max(total, 1)
    return SimResult(horizon_ms, processed, skipped, swap_total, exec_total,
                     cycles, acc, gated=gated)
