"""Cloud-to-edge MergePlan round trip: plan on the "cloud", ship JSON, apply
on the "edge" under a live serving engine (the port of
``examples/cloud_edge_plan.py``).

    PYTHONPATH=src python -m repro_torch.examples.cloud_edge_plan [--device cpu]

1. CLOUD: the staged planner (similarity prefilter + simulator-in-the-loop
   objective) searches merge configurations over three registered models
   and exports a serializable MergePlan;
2. SHIP: the plan round-trips through JSON — the artifact is the contract;
3. EDGE: a MergeAwareEngine serving an *unmerged* twin of the workload gets
   the plan hot-swapped in (staged rebind, one epoch bump, queued requests
   survive) and immediately serves merged: shared trunk, one prefix run per
   micro-batch (private heads in one ``bank_matmul`` dispatch), smaller
   resident footprint.

Every model-facing step goes through the registered ``MergeableAdapter``.
"""
import argparse

import torch

from repro_torch.core import ParamStore, RepresentationSimilarityScorer, StagedPlanner
from repro_torch.core.policy import CoherenceSurrogateTrainer, calibration_activations
from repro_torch.models.registry import get_adapter
from repro_torch.serving.costs import costs_for
from repro_torch.serving.executor import MergeAwareEngine, ModelProgram, Request
from repro_torch.serving.workload import instances_from_store
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import map_tree

ADAPTER = get_adapter("small_cnn")
CFG = ADAPTER.default_config()


def make_zoo(device) -> dict:
    """cam-A (seed 0), cam-B (cam-A plus 0.01 N(0, 1), one generator of
    seed 1 drawn afresh for every leaf) and an unrelated cam-C (seed 42)."""
    base = ADAPTER.init(CFG, seed=0, device=device)

    def noisy(x):
        gen = torch.Generator(device=device).manual_seed(1)
        return x + 0.01 * torch.randn(x.shape, generator=gen, device=device)

    return {"cam-A": base, "cam-B": map_tree(noisy, base),
            "cam-C": ADAPTER.init(CFG, seed=42, device=device)}


def cloud_plan(zoo: dict, batch: dict, regs: list) -> tuple:
    """Plan over ``zoo`` with ``batch`` as the calibration batch and
    ``regs`` the registered members; returns (the plan's JSON, what it
    printed)."""
    print("== CLOUD: staged planner with similarity prefilter ==")
    store = ParamStore.from_models(zoo)
    members = {m: (ADAPTER, CFG, p) for m, p in zoo.items()}
    acts = calibration_activations(members, batch)
    scorer = RepresentationSimilarityScorer(acts, min_similarity=0.5)
    recs = sum((ADAPTER.records(CFG, p, m) for m, p in zoo.items()), [])
    # calibration-coherence surrogate for joint retraining: fast, same
    # ground truth the prefilter predicts
    res = StagedPlanner(store, regs, recs,
                        CoherenceSurrogateTrainer(acts, min_similarity=0.5),
                        scorer=scorer).run()
    print(f"   committed {res.committed} groups in {res.attempted} attempts "
          f"({res.fraction_saved:.1%} saved); plan has "
          f"{len(res.plan.groups)} groups")
    payload = res.plan.to_json()
    print(f"   shipping {len(payload)} bytes of MergePlan JSON to the edge")
    return payload, dict(committed=res.committed, attempted=res.attempted,
                         fraction_saved=res.fraction_saved, groups=len(res.plan.groups),
                         payload_bytes=len(payload))


def edge_serve(payload: str, zoo: dict, img: torch.Tensor) -> dict:
    """The edge box's unmerged ``zoo`` served live by an engine with 9
    requests of ``img`` queued when the plan lands; returns what it
    printed, and the engine and store (not printed)."""
    from repro_torch.core import MergePlan

    print("\n== EDGE: live engine, hot plan swap ==")
    store = ParamStore.from_models(zoo)
    mids = sorted(zoo)
    programs = [ModelProgram.from_adapter(ADAPTER, m, cfg=CFG) for m in mids]
    eng = MergeAwareEngine(
        store, instances_from_store(store, "tiny-yolo"), programs,
        capacity_bytes=10**9, costs={"tiny-yolo": costs_for("tiny-yolo")},
        buckets=(1, 2, 4),
    )
    for i in range(9):  # requests already queued when the plan lands
        eng.submit(Request(mids[i % 3], img, 0.0, 30.0))
    before = store.resident_bytes()
    groups_before = eng.prefix_groups()
    print(f"   prefix groups before swap: {groups_before}")

    swap = eng.apply_plan(MergePlan.from_json(payload))
    print(f"   applied plan: {len(swap['shared_keys'])} shared keys, "
          f"{swap['epoch_bumps']} epoch bump, "
          f"{swap['pending_requests']} queued requests kept")
    groups_after = eng.prefix_groups()
    print(f"   prefix groups after swap:  {groups_after}")
    after = store.resident_bytes()
    print(f"   resident bytes: {before} -> {after}")

    stats = eng.serve(horizon_s=10.0, warmup=img)
    # the JAX example also prints prefix_jits, its count of compiled
    # prefixes: nothing is compiled here
    print(f"   served {stats['completed']} queued requests "
          f"(prefix_runs={stats['prefix_runs']}, "
          f"cache_hit={stats['cache_hit_rate']:.2f}, "
          f"sla={stats['sla_fraction']:.2f})")
    return dict(prefix_groups_before=groups_before, prefix_groups_after=groups_after,
                shared_keys=sorted(swap["shared_keys"]), epoch_bumps=swap["epoch_bumps"],
                pending_requests=swap["pending_requests"], resident_bytes_before=before,
                resident_bytes_after=after, stats=stats, engine=eng, store=store)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    zoo = make_zoo(device)
    batch = ADAPTER.calibration_batch(CFG, torch.Generator(device=device).manual_seed(7), 32)
    regs = [ADAPTER.registered(CFG, m, i + 10, device=device) for i, m in enumerate(sorted(zoo))]
    payload, cloud = cloud_plan(zoo, batch, regs)
    gen = torch.Generator(device=device).manual_seed(2)
    img = torch.randn((1, 32, 32, 3), generator=gen, device=device)
    # the edge box has the same registered originals
    return dict(cloud=cloud, payload=payload, edge=edge_serve(payload, make_zoo(device), img))


if __name__ == "__main__":
    main()
