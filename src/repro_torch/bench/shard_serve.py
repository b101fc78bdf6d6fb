"""Mesh-sharded serve tier benchmark (the port of ``benchmarks/shard_serve.py``;
DESIGN.md S3): the LM merged-group decode scenario served from a ParamStore
carrying a ``MeshPlacement`` over a (2, 4) mesh, against the same store
unplaced.

    PYTHONPATH=src python -m repro_torch.bench.shard_serve [--device cuda|cpu]

The mesh is eight entries of the run's device (``distributed.sharding``:
one controller, entries may repeat), so the sharded lanes run on any host:
on the CPU the kernels' plain versions, on a card the kernels.  Lanes
(``BENCH_shard``, under ``artifacts/torch/``):

1. **bitwise** — the sharded store replicates trunk buffers and splits the
   suffix BANK's leading axis over the ``model`` axis (4 shards; the merged
   (A, B, D, E) group's bank divides exactly), so every bank dispatch is
   four ``bank_matmul`` launches at one member each.  The bank axis is
   batch-like (no contraction is split), so every generated token AND its
   logits must match the unsharded decoder bitwise.  Chunked prefill is on
   in both lanes.  ``max_logit_diff`` is the largest difference found.
2. **per-shard epochs** — ``apply_plan`` on the sharded store advances each
   touched shard's epoch EXACTLY once (one global bump); ``update_buffers``
   on one private key advances exactly that key's home shard.
3. **over-budget admission** — the scheduler budget is set strictly below
   the merged group's total resident bytes (+ activations), i.e. the group
   does NOT fit one device, but at or above the largest per-shard slice —
   sharded admission (replicated trunk per shard, private suffixes on their
   home shards) must serve every request to completion.  The lane's engine
   is built over lane 2's store, already planned.

``run(scn, plan=)`` takes an injected scenario (``bench.lm_merging``'s
``LMScenario``; its ``prompt(i, j, n)`` draws the requests) and a decoded
plan; ``chip_smoke.py`` passes full-width stablelm-1.6b's.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.bench.common import check_gates, emit
from repro_torch.bench.lm_merging import BUCKETS, LMScenario, numpy_scenario, ship_plan
from repro_torch.core import ParamStore
from repro_torch.distributed.partitioning import MeshPlacement
from repro_torch.distributed.sharding import LogicalRules, make_mesh
from repro_torch.serving.costs import costs_for
from repro_torch.serving.decode import DecodeRequest
from repro_torch.serving.executor import MergeAwareEngine, ModelProgram
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.workload import instances_from_store
from repro_torch.utils.device import resolve_device

PAGE_SIZE = 4
DECODE_KW = dict(page_size=PAGE_SIZE, num_pages=64, max_slots=8, max_len=16,
                 buckets=(1, 2, 4), record_logits=True, chunked_prefill=True)
PROMPT_LEN = 7
MAX_NEW = 5
N_PER_MODEL = 2
MESH_SHAPE = (2, 4)  # ("data", "model") -> 4 bank shards
MESH_AXES = ("data", "model")


def serve_rules(mesh):
    """Serve-tier logical rules: every weight buffer REPLICATES (each shard
    computes the full trunk), and only the suffix bank's leading axis
    splits (``MeshPlacement.bank_sharding``)."""
    return LogicalRules(mesh, {})  # unmapped logical axes resolve to None


def mesh_placement(device) -> MeshPlacement:
    """The (2, 4) mesh of ``device`` repeated, bank over ``model``."""
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device)
    return MeshPlacement(serve_rules(mesh), bank_axis="model")


def shard_requests(scn: LMScenario) -> list:
    """N_PER_MODEL requests per member, interleaved (A, B, C, D, E, A, ...)."""
    return [DecodeRequest(m, scn.prompt(i, j, PROMPT_LEN), max_new_tokens=MAX_NEW)
            for j in range(N_PER_MODEL) for i, m in enumerate(scn.mids)]


def engine_over(scn: LMScenario, store, capacity_bytes=None) -> MergeAwareEngine:
    """An engine over every member of ``store``, at ``capacity_bytes``
    (default: one that holds the whole unmerged zoo, as the reference's
    10**9 does for its tiny zoo)."""
    programs = [ModelProgram.from_adapter(scn.adapter, m, cfg=scn.cfg) for m in scn.mids]
    cap = 10 ** 9 + store.resident_bytes() if capacity_bytes is None else capacity_bytes
    return MergeAwareEngine(
        store, instances_from_store(store, "tiny-yolo", model_ids=list(scn.mids)), programs,
        capacity_bytes=cap, costs={"tiny-yolo": costs_for("tiny-yolo")}, buckets=BUCKETS)


def _engine(scn: LMScenario, plan, placement=None) -> MergeAwareEngine:
    eng = engine_over(scn, ParamStore.from_models(dict(scn.zoo), placement=placement))
    eng.apply_plan(plan)
    return eng


def completion_map(decoder) -> dict:
    return {(c.request.instance_id, tuple(int(t) for t in c.request.prompt)):
            (list(c.tokens), c.logits) for c in decoder.completions}


def compare(a: dict, b: dict) -> tuple:
    """(bitwise, largest absolute logits difference) of two completion
    maps: bitwise iff the same requests, tokens and logits rows."""
    same = set(a) == set(b)
    worst = 0.0
    for k in set(a) & set(b):
        same &= a[k][0] == b[k][0] and len(a[k][1]) == len(b[k][1])
        for x, y in zip(a[k][1], b[k][1]):
            same &= np.array_equal(x, y)
            worst = max(worst, float(np.max(np.abs(np.asarray(x, np.float64) - y))))
    return same, worst


def _lane_row(mode: str, lane: str, st: dict) -> dict:
    return {"mode": mode, "lane": lane, "completed": st["completed"], "steps": st["steps"],
            "tokens_decoded": st["tokens_decoded"],
            "prefill_chunk_dispatches": st["prefill_chunk_dispatches"],
            "bank_dispatches": st["bank_dispatches"], "lost_in_flight": st["lost_in_flight"]}


def serve_pair(scn: LMScenario, plan, placement, on_lane=None) -> tuple:
    """The unsharded and the sharded lane on the same requests, each engine
    built and dropped in turn.  ``on_lane(name, engine, stats)`` sees each
    before it goes.  Returns (rows, bitwise, max_logit_diff, whether a
    sharded bank wrapper was built)."""
    mode = scn.device.type
    maps, rows = {}, []
    sharded = False
    for lane, pl in (("unsharded", None), ("sharded", placement)):
        eng = _engine(scn, plan, placement=pl)
        stats = eng.serve_decode(shard_requests(scn), **DECODE_KW)
        maps[lane] = completion_map(eng.last_decoder)
        rows.append(_lane_row(mode, lane, stats))
        if pl is not None:
            sharded = bool(eng._bank_sharded)
        if on_lane is not None:
            on_lane(lane, eng, stats)
        del eng
    bitwise, worst = compare(maps["unsharded"], maps["sharded"])
    return rows, bitwise, worst, sharded


def epoch_accounting(scn: LMScenario, plan, placement) -> tuple:
    """Per-shard epoch discipline around the two shard-affecting events on
    a fresh sharded store.  Returns (derived fields, the store)."""
    store = ParamStore.from_models(dict(scn.zoo), placement=placement)
    before = dict(store.shard_epochs)
    epoch0 = store.epoch
    keys = store.apply_plan(plan)
    bumps = {s: store.shard_epochs.get(s, 0) - before.get(s, 0) for s in range(store.n_shards)}
    touched_shards = {store.shard_of(k) for k in keys}
    plan_ok = (store.epoch - epoch0 == 1
               and all(b <= 1 for b in bumps.values())
               and all(bumps[s] == 1 for s in touched_shards))

    # update_buffers on ONE private key: exactly its home shard advances
    priv = next(k for k in sorted(store.buffers) if ":" in k and k not in store.shared_keys())
    before = dict(store.shard_epochs)
    store.update_buffers({priv: store.buffers[priv] * 1.0})
    bumped = [s for s in range(store.n_shards)
              if store.shard_epochs.get(s, 0) != before.get(s, 0)]
    update_ok = bumped == [store.shard_of(priv)]
    return {
        "apply_plan_epoch_bumps": 1 if plan_ok else -1,
        "apply_plan_touched_shards": len(touched_shards),
        "update_buffers_bumped_shards": len(bumped),
        "epoch_bumps_ok": bool(plan_ok and update_ok),
    }, store


def over_budget(scn: LMScenario, store, on_lane=None) -> dict:
    """Serve the merged group from ``store`` (sharded, planned) under a
    per-shard budget one device cannot hold the group in."""
    total = store.resident_bytes()
    by_shard = store.resident_bytes_by_shard()
    probe = Scheduler(instances_from_store(store, "tiny-yolo", model_ids=list(scn.mids)), 0,
                      {"tiny-yolo": costs_for("tiny-yolo")})
    act = max(probe._activation_bytes(i, 1) for i in probe.instances.values())
    capacity = max(by_shard.values()) + act + 1
    assert capacity < total + act, "scenario too small to be over budget"
    eng = engine_over(scn, store, capacity_bytes=capacity)
    reqs = shard_requests(scn)
    stats = eng.serve_decode(reqs, **DECODE_KW)
    if on_lane is not None:
        on_lane("over-budget", eng, stats)
    return {
        "over_budget_capacity_bytes": capacity,
        "over_budget_activation_bytes": act,
        "group_resident_bytes": total,
        "max_shard_resident_bytes": max(by_shard.values()),
        "over_budget_submitted": len(reqs),
        "over_budget_completed": stats["completed"],
        "over_budget_served": stats["completed"] == len(reqs) and stats["lost_in_flight"] == 0,
        "dma_bytes_by_shard": dict(eng.dma.bytes_by_shard),
    }


def run(scn: LMScenario = None, device=None, plan=None, on_lane=None) -> dict:
    """The three lanes; ``scn`` defaults to ``numpy_scenario`` on ``device``
    (default ``cuda``), ``plan`` to the scenario's own shipped plan.
    ``on_lane(name, engine, stats)`` sees each serving lane."""
    scn = numpy_scenario(device=resolve_device(device)) if scn is None else scn
    plan = ship_plan(scn)["plan"] if plan is None else plan
    placement = mesh_placement(scn.device)
    rows, bitwise, worst, bank_sharded = serve_pair(scn, plan, placement, on_lane=on_lane)
    epochs, store = epoch_accounting(scn, plan, placement)
    derived = {
        "sharded": True,
        "devices": placement.mesh.size,
        "distinct_devices": len(placement.mesh.distinct_devices),
        "mesh": "x".join(map(str, MESH_SHAPE)),
        "n_shards": placement.n_shards,
        "bank_sharded_over_model_axis": bank_sharded,
        "bitwise": bitwise,
        "max_logit_diff": worst,
        **epochs,
        **over_budget(scn, store, on_lane=on_lane),
    }
    return emit("BENCH_shard", rows, derived)


def gates(d: dict) -> dict:
    """``scripts/ci.sh``'s sharded-serve gates (S3; the plan-wire half is
    ``bench.fig14_bandwidth``'s), ``bitwise`` in place of its ref and
    interpret pair."""
    weights_budget = d["over_budget_capacity_bytes"] - d["over_budget_activation_bytes"]
    return {
        "sharded": d["sharded"],
        "bitwise": d["bitwise"],
        "epoch_bumps_ok": d["epoch_bumps_ok"],
        "apply_plan_epoch_bumps == 1": d["apply_plan_epoch_bumps"] == 1,
        "bank_sharded_over_model_axis": d["bank_sharded_over_model_axis"],
        "over_budget_served": d["over_budget_served"],
        "weights budget < group_resident_bytes": weights_budget < d["group_resident_bytes"],
        "weights budget >= max_shard_resident_bytes":
            weights_budget >= d["max_shard_resident_bytes"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    with torch.no_grad():
        out = run(device=args.device)
    check_gates("shard_serve", gates(out["derived"]))


if __name__ == "__main__":
    main()
