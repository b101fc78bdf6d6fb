"""Scheduler instances from a live store, and request micro-batching (the
serving subset of ``repro.serving.workload``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.serving.scheduler import Instance
from repro_torch.utils.tree import leaf_bytes


def instances_from_store(
    store,
    cost_ids,  # str (one cost-table id for all) or {model_id: cost_id}
    model_ids: Optional[list] = None,
    accuracies: Optional[dict] = None,
) -> list:
    """Scheduler Instances straight from a live ParamStore: each model's key
    set is its *current* bindings and key bytes are the real buffer sizes."""
    ids = model_ids if model_ids is not None else sorted(store.bindings)
    out = []
    for mid in ids:
        kb = {k: leaf_bytes(store.buffers[k]) for k in store.keys_for(mid)}
        cost = cost_ids if isinstance(cost_ids, str) else cost_ids[mid]
        out.append(Instance(mid, cost, frozenset(kb), kb,
                            accuracy=(accuracies or {}).get(mid, 1.0)))
    return out


# The serving engine drains queues into deadline-sorted micro-batches padded
# up to a fixed bucket ladder, so the device sees a bounded set of shapes.


@dataclasses.dataclass
class Microbatch:
    requests: list  # deadline-sorted slice of the drained queue
    bucket: int  # padded batch size actually executed (>= len(requests))


def bucket_for(n: int, buckets: tuple = (1, 2, 4, 8)) -> int:
    """Smallest bucket >= n (the largest bucket caps the batch size)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def deadline_microbatches(requests: list, buckets: tuple = (1, 2, 4, 8)) -> list:
    """EDF micro-batches: sort by deadline (ties by arrival) and cut greedy
    chunks of at most ``max(buckets)`` requests, each padded to its bucket."""
    if not requests:
        return []
    ordered = sorted(requests, key=lambda r: (r.deadline_s, r.arrival_s))
    cap = buckets[-1]
    return [Microbatch(ordered[i:i + cap], bucket_for(len(ordered[i:i + cap]), buckets))
            for i in range(0, len(ordered), cap)]


def pad_stack(payloads: list, bucket: int):
    """Stack per-request payloads (each an unbatched or batch-1 tensor) into
    one (bucket, ...) batch on the payloads' device, repeating the last
    payload as padding.  Returns the batch and the number of real rows."""
    rows = [p[0] if p.dim() >= 1 and p.shape[0] == 1 else p for p in payloads]
    n = len(rows)
    rows = rows + [rows[-1]] * (bucket - n)
    return torch.stack(rows, dim=0), n
