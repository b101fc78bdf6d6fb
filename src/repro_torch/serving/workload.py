"""Workload definition -> scheduler Instances, with or without merging,
and request micro-batching (the port of ``repro.serving.workload``).

``build_instances`` materialises store-key-level weight sets from the
layer-spec descriptors (no weight is allocated):
  * unmerged: every instance owns private keys for all its layers;
  * merged (optimal): all architecturally identical layers across the
    workload share one key (the Fig 5/6 upper bound);
  * merged (groups): only the given committed groups share keys;
  * merged (plan): the binding deltas of a serialized ``MergePlan`` are
    applied verbatim.

``instances_from_store`` builds Instances straight from a live ParamStore's
bindings (real buffer bytes).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.vision_workloads import WORKLOADS
from repro_torch.core.groups import enumerate_groups, stable_group_id
from repro_torch.core.signatures import records_from_spec
from repro_torch.serving.costs import costs_for, default_spec_provider
from repro_torch.serving.scheduler import Instance
from repro_torch.utils.tree import leaf_bytes


def build_instances(
    name: str,
    merged: str = "none",  # none | optimal | groups | plan
    shared_groups: Optional[list] = None,  # LayerGroups actually merged
    accuracies: Optional[dict] = None,  # instance_id -> accuracy multiplier
    workloads: Optional[dict] = None,
    plan=None,  # MergePlan consumed when merged == "plan"
) -> list:
    wl = (workloads or WORKLOADS)[name]
    get_spec = default_spec_provider()
    recs_by_inst = {}
    for k, (mid, feed, obj) in enumerate(wl):
        iid = f"{mid}#{k}"
        recs_by_inst[iid] = [dataclasses.replace(r, model_id=iid)
                             for r in records_from_spec(get_spec(mid))]

    # (model, path) -> shared key, COLUMN-wise (across-model sharing only)
    shared_keys: dict = {}
    groups = None
    if merged == "optimal":
        groups = enumerate_groups([r for rs in recs_by_inst.values() for r in rs])
    elif merged == "groups":
        groups = shared_groups or []
    elif merged == "plan":
        if plan is None:
            raise ValueError("merged='plan' requires plan=")
        shared_keys = plan.binding_deltas()  # the artifact IS the contract
    if groups:
        for g in groups:
            base = stable_group_id(g.signature)
            for ci, col in enumerate(g.columns()):
                if len(col) < 2:
                    continue
                for r in col:
                    shared_keys[(r.model_id, r.path)] = f"{base}:c{ci}"

    instances = []
    for k, (mid, feed, obj) in enumerate(wl):
        iid = f"{mid}#{k}"
        keys = {}
        for r in recs_by_inst[iid]:
            keys[shared_keys.get((iid, r.path), f"{iid}:{r.path}")] = r.bytes
        acc = (accuracies or {}).get(iid, 1.0)
        instances.append(Instance(iid, mid, frozenset(keys.keys()), keys, accuracy=acc))
    return instances


def instances_from_store(
    store,
    cost_ids,  # str (one cost-table id for all) or {model_id: cost_id}
    model_ids: Optional[list] = None,
    accuracies: Optional[dict] = None,
    key_bytes_fn=None,  # (key, real_bytes) -> bytes (e.g. paper-scale rescale)
) -> list:
    """Scheduler Instances straight from a live ParamStore: each model's key
    set is its *current* bindings and key bytes are the real buffer sizes
    unless ``key_bytes_fn`` rescales them."""
    ids = model_ids if model_ids is not None else sorted(store.bindings)
    out = []
    for mid in ids:
        kb = {k: (key_bytes_fn(k, leaf_bytes(store.buffers[k])) if key_bytes_fn
                  else leaf_bytes(store.buffers[k])) for k in store.keys_for(mid)}
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


def workload_costs(name: str, workloads: Optional[dict] = None) -> dict:
    wl = (workloads or WORKLOADS)[name]
    return {mid: costs_for(mid) for mid, _, _ in wl}


def memory_settings(name: str, workloads: Optional[dict] = None) -> dict:
    """§2 memory settings from the paper's Table-1 cost model, so the
    scheduler and the settings agree: *min* = the largest single model's
    load+run at batch 1; *max* = all params resident + the largest
    activation.  50%/75% are clamped to at least *min* (feasibility)."""
    wl = (workloads or WORKLOADS)[name]
    costs = workload_costs(name, workloads)
    loads = [costs[mid].load_gb for mid, _, _ in wl]
    acts = [costs[mid].activation_gb(1) for mid, _, _ in wl]
    runs = [costs[mid].run_mem(1) for mid, _, _ in wl]
    mn = max(runs) * 1e9
    mx = (sum(loads) + max(acts)) * 1e9
    return {
        "min": int(mn),
        "50%": int(max(mn, 0.5 * mx)),
        "75%": int(max(mn, 0.75 * mx)),
        "max": int(mx),
    }
