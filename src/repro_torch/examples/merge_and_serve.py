"""End to end: GEMEL against time/space sharing on a paper workload
(the port of ``examples/merge_and_serve.py``).

    PYTHONPATH=src python -m repro_torch.examples.merge_and_serve [--workload MP2] [--device cpu]

Reproduces the paper's core claim at workload scale through the
discrete-event simulator (the Table 1/2 cost model, host arithmetic): the
merged workload swaps less, processes more frames inside the SLA and lands
a higher effective accuracy.  Then serves a real reduced-scale merged pair
through the per-request executor and the merge-aware engine, whose private
heads run in one ``bank_matmul`` dispatch (the float32 ``simt`` route on
the card).
"""
import argparse
import time

import torch

from repro_torch.serving.executor import EdgeExecutor, Request
from repro_torch.serving.profiler import profile_workload
from repro_torch.serving.scheduler import Instance, Scheduler
from repro_torch.serving.simulator import simulate
from repro_torch.serving.workload import build_instances, memory_settings, workload_costs
from repro_torch.utils.device import resolve_device


def simulated(workload: str) -> dict:
    """{merged: {accuracy, processed, swap_ms}} for ``none`` and ``optimal``."""
    print(f"== workload {workload}: simulator (paper Table 1/2 cost model) ==")
    cap = memory_settings(workload)["min"]
    costs = workload_costs(workload)
    out = {}
    for merged in ["none", "optimal"]:
        insts = build_instances(workload, merged=merged)
        sched = Scheduler(insts, cap, costs, merged=(merged != "none"))
        order = [i.instance_id for i in sched.order]
        cbi = {i.instance_id: costs[i.model_id] for i in sched.order}
        swap = sched.cycle_swap_bytes({i: 1 for i in order})
        prof = profile_workload(order, cbi, swap, sla_ms=100.0)
        sched = Scheduler(insts, cap, costs, merged=(merged != "none"))
        res = simulate(sched, prof.batch_sizes, horizon_ms=20_000)
        print(f"   {merged:8s} acc={res.overall_accuracy:.3f} "
              f"processed={res.processed_fraction:.3f} "
              f"swap={res.swap_ms_total:.0f}ms")
        out[merged] = dict(accuracy=res.overall_accuracy, processed=res.processed_fraction,
                           swap_ms=res.swap_ms_total)
    return out


def real_executor(pa: dict, pb: dict, imgs: torch.Tensor) -> dict:
    """Members A and B (``pa``, ``pb``) with the trunk merged; 40 requests of
    ``imgs`` (1, 32, 32, 3) through both executors.  Returns both lanes'
    stats, and each lane's completions with the store (not printed)."""
    print("\n== real executor: merged pair of small models ==")
    from repro_torch.core import ParamStore, enumerate_groups
    from repro_torch.models.registry import get_adapter
    from repro_torch.serving.costs import costs_for
    from repro_torch.serving.executor import MergeAwareEngine, ModelProgram

    adapter = get_adapter("small_cnn")
    cfg = adapter.default_config()
    store = ParamStore.from_models({"A": pa, "B": pb})
    recs = adapter.records(cfg, pa, "A") + adapter.records(cfg, pb, "B")
    # merge the trunk only — heads stay private, the shared-prefix case
    for g in enumerate_groups(recs):
        if not any(r.path.startswith("head/") for r in g.records):
            store.merge_group(g)

    insts = []
    for mid in ("A", "B"):
        keys = store.keys_for(mid)
        insts.append(Instance(mid, "tiny-yolo", frozenset(keys), {k: 1000 for k in keys}))
    costs = {"tiny-yolo": costs_for("tiny-yolo")}

    # seed path: one forward per request, synchronous DMA
    ex = EdgeExecutor(
        store, insts, {m: adapter.bound_forward(cfg) for m in ("A", "B")},
        capacity_bytes=10**9, costs=costs,
    )
    t0 = time.monotonic()
    for i in range(40):
        now = time.monotonic() - t0
        ex.submit(Request("A" if i % 2 == 0 else "B", imgs, now, now + 0.5))
    stats = ex.serve(horizon_s=3.0, warmup=imgs)
    print(f"   per-request: {stats}")

    # engine path: shared-prefix batched execution + cached materialisation
    # + async DMA prefetch; the adapter IS the serving contract
    programs = [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in ("A", "B")]
    eng = MergeAwareEngine(store, insts, programs, capacity_bytes=10**9, costs=costs)
    for i in range(40):
        eng.submit(Request("A" if i % 2 == 0 else "B", imgs, 0.0, 0.5))
    estats = eng.serve(horizon_s=3.0, warmup=imgs)
    print(f"   engine     : completed={estats['completed']} "
          f"rps={estats['requests_per_s']:.0f} "
          f"sla={estats['sla_fraction']:.3f} "
          f"cache_hit={estats['cache_hit_rate']:.2f} "
          f"prefix_runs={estats['prefix_runs']} "
          f"(shared stem ran once per micro-batch for both models)")
    return dict(per_request=stats, engine=estats, store=store,
                per_request_completions=ex.completions, engine_completions=eng.completions)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", default="MP2")
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    from repro_torch.models.registry import get_adapter

    adapter = get_adapter("small_cnn")
    cfg = adapter.default_config()
    pa = adapter.init(cfg, seed=0, device=device)
    pb = adapter.init(cfg, seed=1, device=device)
    gen = torch.Generator(device=device).manual_seed(2)
    imgs = torch.randn((1, 32, 32, 3), generator=gen, device=device)
    return dict(simulated=simulated(args.workload), real=real_executor(pa, pb, imgs))


if __name__ == "__main__":
    main()
