"""Offline batch-size profiling (§3.2), the port of
``repro.serving.profiler``: pick the global list of per-model
batch sizes that maximises the *minimum* per-model throughput while every
frame still meets the SLA.

A frame's worst-case latency is its queueing wait (one full round-robin
cycle) plus its own batch's execution, so feasibility of a batch assignment
``b`` is:

    cycle(b) = sum_i max(load_i_hidden, exec_i(b_i))  <= SLA slack model

We use the paper's operational rule: per-frame deadline = SLA, frames
arrive at ``fps``; a model processes b_i frames per cycle, so it keeps up
iff cycle(b) <= b_i / fps (no queue growth) and exec+wait <= SLA.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serving.costs import PCIE_GBPS

CANDIDATE_BATCHES = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class Profile:
    batch_sizes: dict  # model instance -> batch
    cycle_ms: float
    min_throughput_fps: float


def cycle_time_ms(order: list, batches: dict, costs: dict, swap_bytes_gb: dict) -> float:
    """One full round-robin pass.  ``swap_bytes_gb[m]`` is the incremental
    load for m given its predecessor in the order (merging-aware); the load
    of m overlaps the execution of its predecessor (pipelined)."""
    total = 0.0
    n = len(order)
    for i, m in enumerate(order):
        exec_ms = costs[m].run_time(batches[m])
        load_ms = 1000.0 * swap_bytes_gb.get(m, 0.0) / PCIE_GBPS
        prev = order[i - 1]
        prev_exec = costs[prev].run_time(batches[prev]) if n > 1 else 0.0
        # load happens during predecessor's exec; only the overhang counts
        total += exec_ms + max(load_ms - prev_exec, 0.0)
    return total


def profile_workload(order: list, costs: dict, swap_bytes_gb: dict, sla_ms: float) -> Profile:
    """Exhaustive over uniform batch + greedy per-model refinement (the space
    is tiny: |batches|^|models| is pruned by uniform-first)."""
    best: Optional[Profile] = None
    # uniform assignment first
    for b in CANDIDATE_BATCHES:
        batches = {m: b for m in order}
        c = cycle_time_ms(order, batches, costs, swap_bytes_gb)
        tput = min(b / (c / 1000.0) for _ in order) if c > 0 else float("inf")
        feasible = c <= sla_ms  # a frame waits at most one cycle
        if feasible and (best is None or tput > best.min_throughput_fps):
            best = Profile(dict(batches), c, tput)
    if best is None:
        # nothing fits the SLA — fall back to batch 1 (degraded mode)
        batches = {m: CANDIDATE_BATCHES[0] for m in order}
        c = cycle_time_ms(order, batches, costs, swap_bytes_gb)
        best = Profile(batches, c, min(1.0 / (c / 1000.0) for _ in order))

    # greedy: try bumping each model's batch if it raises min throughput
    improved = True
    while improved:
        improved = False
        for m in order:
            cur = best.batch_sizes[m]
            larger = [b for b in CANDIDATE_BATCHES if b > cur]
            for b in larger:
                trial = dict(best.batch_sizes)
                trial[m] = b
                c = cycle_time_ms(order, trial, costs, swap_bytes_gb)
                if c > sla_ms:
                    continue
                tput = min(trial[x] / (c / 1000.0) for x in order)
                if tput > best.min_throughput_fps:
                    best = Profile(trial, c, tput)
                    improved = True
                    break
    return best
