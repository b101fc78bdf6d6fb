"""Serving-engine throughput (the port of ``benchmarks/serve_throughput.py``):
the per-request time/space-sharing path against the merge-aware engine.

    PYTHONPATH=src python -m repro_torch.bench.serve_throughput [--device cuda|cpu]
        [--requests N]

One synthetic workload through both serve paths: two model *pairs*, (A, B)
and (C, D), where each pair shares a merged trunk in one ParamStore and the
pairs share nothing.  Key bytes are scaled to the paper's Table-1 yolo
footprint (0.242 GB a model) and the capacity holds only ONE pair, so
every pair switch moves a trunk across the modelled 16 GB/s link (§3.2):

* seed   — ``EdgeExecutor.serve``: one forward per visit, a synchronous
  (modelled) DMA stall before each swap;
* engine — ``MergeAwareEngine.serve``: deadline-sorted micro-batches, the
  merged trunk run once per batch with per-model heads, cached
  materialisation, the next pair's load prefetched behind this pair's
  compute.

An ``engine-nobank`` lane serves the same traffic with per-member
suffixes, so the bank (DESIGN.md S2) is held to ONE suffix dispatch per
shared micro-batch (the reference adds that lane with ``--suffix-bank``,
which ``scripts/ci.sh`` always passes; here it always runs).  ``BENCH_serve.json`` (under
``artifacts/torch/``) records requests a second, SLA fraction, cache hit
rate and materialisations against binding epochs.  The inputs (the four
models' params and the frame every request carries) are one
:class:`ServeInputs`: :func:`numpy_inputs` draws them; the CPU parity tests
inject the JAX bench's.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.bench.common import check_gates, emit
from repro_torch.core import ParamStore, enumerate_groups
from repro_torch.models.registry import get_adapter
from repro_torch.serving.costs import costs_for
from repro_torch.serving.executor import EdgeExecutor, MergeAwareEngine, ModelProgram, Request
from repro_torch.serving.scheduler import Instance
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import leaf_bytes

MODEL_TARGET_GB = 0.242  # Table 1: yolo load size — what each model "weighs"
PAIRS = (("A", "B"), ("C", "D"))
ORDER = ("A", "B", "C", "D")
BUCKETS = (1, 2, 4)
HORIZON_S = 90.0  # the reference's default --horizon
DEADLINE_S = 80.0  # the first request's deadline; each later one 1 ms more


@dataclasses.dataclass
class ServeInputs:
    """``params`` ({model_id: small_cnn params}, in ``ORDER``; never
    mutated) and ``frame``, the (1, 32, 32, 3) payload of every request
    and of the warm-up."""

    params: dict
    frame: torch.Tensor


def numpy_inputs(device=None) -> ServeInputs:
    """Seeded inits (model i from seed i) and a numpy N(0, 1) frame on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    adapter = get_adapter("small_cnn")
    cfg = adapter.default_config()
    frame = np.random.default_rng(2).standard_normal((1, 32, 32, 3), dtype=np.float32)
    return ServeInputs({m: adapter.init(cfg, seed=i, device=dev) for i, m in enumerate(ORDER)},
                       torch.from_numpy(frame).to(dev))


def _build(inp: ServeInputs):
    """The store (each pair's trunk merged, heads private), instances at
    Table-1 byte scale, costs, and a capacity of one pair, the largest
    bucket's activation and 0.05 GB."""
    adapter = get_adapter("small_cnn")
    cfg = adapter.default_config()
    store = ParamStore.from_models(dict(inp.params))
    for pair in PAIRS:  # merge trunks within each pair; heads stay private
        recs = sum((adapter.records(cfg, inp.params[m], m) for m in pair), [])
        for g in enumerate_groups(recs):
            if not any(r.path.startswith("head/") for r in g.records):
                store.merge_group(g)
    # paper-scale byte accounting: each reduced-scale model "weighs"
    # MODEL_TARGET_GB (Table 1), so swap stalls match the paper's regime
    scale = MODEL_TARGET_GB * 1e9 / store.model_bytes("A")
    insts = []
    for m in ORDER:
        kb = {k: max(int(leaf_bytes(store.buffers[k]) * scale), 1) for k in store.keys_for(m)}
        insts.append(Instance(m, "tiny-yolo", frozenset(kb), kb))
    costs = {"tiny-yolo": costs_for("tiny-yolo")}
    # the second pair never fits beside the first: every pair switch swaps
    pair_bytes = sum({k: insts[0].key_bytes.get(k) or insts[1].key_bytes[k]
                      for k in insts[0].keys | insts[1].keys}.values())
    act = int(costs["tiny-yolo"].activation_gb(max(BUCKETS)) * 1e9)
    return adapter, cfg, store, insts, costs, pair_bytes + act + int(0.05e9)


def _trace(frame, n_requests: int) -> list:
    """Deadlines staggered by arrival, so EDF interleaves a pair's models
    within one micro-batch (the shared prefix serves rows of both)."""
    return [(ORDER[i % len(ORDER)], frame, DEADLINE_S + i * 1e-3) for i in range(n_requests)]


def _run_seed(inp: ServeInputs, n_requests: int) -> dict:
    adapter, cfg, store, insts, costs, capacity = _build(inp)
    ex = EdgeExecutor(store, insts, {m: adapter.bound_forward(cfg) for m in ORDER},
                      capacity_bytes=capacity, costs=costs)
    for iid, payload, dl in _trace(inp.frame, n_requests):
        ex.submit(Request(iid, payload, 0.0, dl))
    stats = ex.serve(horizon_s=HORIZON_S, warmup=inp.frame, drain=True)
    last = max((c.finished_s for c in ex.completions), default=0.0)
    stats["requests_per_s"] = stats["completed"] / max(last, 1e-9)
    stats["elapsed_s"] = last
    return stats


def _run_engine(inp: ServeInputs, n_requests: int, suffix_bank: bool = True) -> dict:
    adapter, cfg, store, insts, costs, capacity = _build(inp)
    programs = [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in ORDER]
    eng = MergeAwareEngine(store, insts, programs, capacity_bytes=capacity, costs=costs,
                           buckets=BUCKETS, suffix_bank=suffix_bank)
    for iid, payload, dl in _trace(inp.frame, n_requests):
        eng.submit(Request(iid, payload, 0.0, dl))
    stats = eng.serve(horizon_s=HORIZON_S, warmup=inp.frame)
    # cache verification: rebuilds per model never exceed the binding
    # epochs (trunk merges before serving, no rebinds after: exactly one
    # materialisation per model, whatever the request count)
    stats["materializations_total"] = dict(store.materializations)
    stats["cache_verified"] = all(
        n <= store.epoch for n in store.materializations.values()
    ) and stats["materializations"] <= stats["binding_epochs"]
    return stats


def _row(path: str, stats: dict, hit_rate) -> dict:
    return {"path": path, "completed": stats["completed"],
            "requests_per_s": stats["requests_per_s"], "sla_fraction": stats["sla_fraction"],
            "cache_hit_rate": hit_rate, "elapsed_s": stats["elapsed_s"]}


def evaluate(inp: ServeInputs, n_requests: int = 240) -> tuple:
    """The lanes on the same trace; returns (rows, derived)."""
    seed = _run_seed(inp, n_requests)
    engine = _run_engine(inp, n_requests)
    speedup = engine["requests_per_s"] / max(seed["requests_per_s"], 1e-9)
    rows = [_row("seed", seed, None), _row("engine", engine, engine["cache_hit_rate"])]
    derived = {
        "speedup_rps": speedup,
        "target_2x_met": speedup >= 2.0,
        "sla_no_worse": engine["sla_fraction"] >= seed["sla_fraction"] - 1e-9,
        "cache_hit_rate": engine["cache_hit_rate"],
        "cache_verified": engine["cache_verified"],
        "binding_epochs": engine["binding_epochs"],
        "materializations": engine["materializations_total"],
        "prefix_runs": engine["prefix_runs"],
        "suffix_runs": engine["suffix_runs"],
        "suffix_dispatches": engine["suffix_dispatches"],
        "bank_hits": engine["bank_hits"],
        "microbatches": engine["microbatches"],
        "dma_stall_s": engine["dma_stall_s"],
        "dma_hidden_s": engine["dma_hidden_s"],
        "n_requests": n_requests,
    }
    nobank = _run_engine(inp, n_requests, suffix_bank=False)
    rows.append(_row("engine-nobank", nobank, nobank["cache_hit_rate"]))
    derived.update({
        "suffix_runs_nobank": nobank["suffix_runs"],
        "suffix_dispatches_nobank": nobank["suffix_dispatches"],
        "bank_speedup_rps": engine["requests_per_s"] / max(nobank["requests_per_s"], 1e-9),
        # every shared micro-batch must fan out in exactly ONE dispatch
        "bank_dispatch_per_microbatch": (engine["suffix_dispatches"]
                                         / max(engine["microbatches"], 1)),
    })
    return rows, derived


def run(inp: ServeInputs = None, device=None, n_requests: int = 240) -> dict:
    inp = numpy_inputs(device) if inp is None else inp
    rows, derived = evaluate(inp, n_requests)
    return emit("BENCH_serve", rows, derived)


def gates(d: dict) -> dict:
    """The suffix-bank gates ``scripts/ci.sh`` holds ``BENCH_serve`` to."""
    return {"suffix_dispatches < suffix_runs_nobank":
            d["suffix_dispatches"] < d["suffix_runs_nobank"],
            "bank_dispatch_per_microbatch == 1": d["bank_dispatch_per_microbatch"] == 1.0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    ap.add_argument("--requests", type=int, default=240)
    args = ap.parse_args(argv)
    out = run(device=args.device, n_requests=args.requests)
    check_gates("serve_throughput", gates(out["derived"]))


if __name__ == "__main__":
    main()
