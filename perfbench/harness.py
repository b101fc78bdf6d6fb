"""One run of one cell: set-up (weights drawn on the device, the store built
and merged, the engine warmed up), the measured window, the check against
the plain reference, and the metrics of the cell.

``run_cell`` does all but the look for a chip, so a test can drive a whole
run on the CPU at a small size (``overrides``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import time
from typing import Any, Optional

import torch

from perfbench import check, common, trace, weights

# the engine's capacity: the whole card, so nothing is swapped in a window
CAPACITY_BYTES = 80 * 10 ** 9


@dataclasses.dataclass
class Context:
    name: str
    cell: dict
    mix: dict
    seed: int
    seconds: float
    traced: bool
    device: Any
    t_process: float  # perf_counter() at process start
    cfg: dict = None  # the model's sizes, as the program's config takes them
    family: str = ""
    members: tuple = ()
    vocab: int = 0
    padded_vocab: int = 0
    engine: Any = None
    store: Any = None
    decoder: Any = None
    clock: Any = None
    slice: Any = None
    resident_bytes: int = 0
    setup_peak_bytes: int = 0
    window_peak_bytes: int = 0
    setup_s: float = 0.0
    stats: dict = dataclasses.field(default_factory=dict)
    e2e: dict = dataclasses.field(default_factory=dict)
    samples: list = dataclasses.field(default_factory=list)
    probes: Any = None
    latencies: list = dataclasses.field(default_factory=list)  # serve: (due s, latency s)
    attempted: int = 0
    failed: int = 0
    useful_flops: float = 0.0
    graph_calls: dict = dataclasses.field(default_factory=dict)  # decode: graph -> calls
    summary: Optional[trace.Summary] = None

    def window_starts(self) -> None:
        self.slice.prepare()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.setup_peak_bytes = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        self.setup_s = time.perf_counter() - self.t_process

    def window_ends(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.window_peak_bytes = torch.cuda.max_memory_allocated()


def model_config(adapter, fields: dict):
    """The program's config object of ``fields`` (the config file's model)."""
    cls = type(adapter.default_config())
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in fields.items() if k in names})


def build(ctx: Context) -> None:
    """Draw every member, build the store, merge every trunk group and make
    the engine."""
    from repro_torch.core import ParamStore, enumerate_groups
    from repro_torch.models.registry import get_adapter
    from repro_torch.serving.costs import costs_for
    from repro_torch.serving.executor import MergeAwareEngine, ModelProgram
    from repro_torch.serving.workload import instances_from_store
    from repro_torch.utils.tree import flatten_paths, unflatten_paths

    from perfbench.serve import CallClock

    adapter = get_adapter(ctx.family)
    cfg = model_config(adapter, ctx.cfg)
    layout = weights.layout_of(flatten_paths(adapter.eval_params(cfg)))
    models = {}
    for i, mid in enumerate(ctx.members):
        models[mid] = unflatten_paths(
            weights.draw_member(ctx.seed, i, layout, ctx.cfg["norm"], ctx.device))
    store = ParamStore.from_models(models)
    del models
    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m in ctx.members for r in adapter.records(cfg, store.materialize(m), m)
            if r.path in trunk]
    for g in enumerate_groups(recs):
        store.merge_group(g)
    ctx.resident_bytes = store.resident_bytes()
    ctx.clock = CallClock()
    programs = [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in ctx.members]
    ctx.engine = MergeAwareEngine(
        store, instances_from_store(store, "tiny-yolo", model_ids=list(ctx.members)),
        programs, capacity_bytes=CAPACITY_BYTES, costs={"tiny-yolo": costs_for("tiny-yolo")},
        simulate_dma=False, buckets=tuple(ctx.cell["buckets"]), clock=ctx.clock)
    ctx.store = store
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def make_context(name: str, seed: int, seconds: float, traced: bool, device="cuda",
                 overrides: Optional[dict] = None, t_process: Optional[float] = None) -> Context:
    """The context of one run of cell ``name``, its files read by name and
    ``overrides`` applied (see :func:`run_cell`)."""
    overrides = overrides or {}
    cell = {**common.load_json("workloads", name), **overrides.get("cell", {})}
    config = common.load_json("configs", cell["config"])
    mix = {**common.load_json("traffic", cell["traffic"]), **overrides.get("mix", {})}
    model = {**config["model"], **overrides.get("model", {})}
    ctx = Context(name, cell, mix, seed, seconds, traced, torch.device(device),
                  time.perf_counter() if t_process is None else t_process,
                  cfg=model, family=config["family"], members=tuple(cell["members"]))
    ctx.vocab = model["vocab_size"]
    ctx.padded_vocab = -(-model["vocab_size"] // model["vocab_multiple"]) * model[
        "vocab_multiple"]
    mid = max(0.0, (seconds - cell["trace_s"]) / 2)
    ctx.slice = trace.Slice(mid, mid + cell["trace_s"], traced)
    return ctx


def run_cell(name: str, seed: int, seconds: float, traced: bool, device="cuda",
             overrides: Optional[dict] = None, t_process: Optional[float] = None,
             control: bool = False) -> dict:
    """One run of cell ``name``: returns the result (the contract's last
    line) and, under ``"compared"``, each number beside its limit.
    ``overrides`` replace keys of the cell, its config's ``model`` and its
    mix (``{"cell": {...}, "model": {...}, "mix": {...}}``); ``control``
    adds the fp8 control's numbers at the same samples."""
    ctx = make_context(name, seed, seconds, traced, device, overrides, t_process)
    loop = importlib.import_module(f"perfbench.{ctx.cell['loop']}")

    with torch.no_grad():
        build(ctx)
        loop.run(ctx)
    if ctx.slice.state == "done":
        ctx.summary = ctx.slice.summary()
        ctx.summary.useful_flops = ctx.useful_flops
        ctx.summary.rooflines = loop.rooflines(ctx)
    ctx.slice = None
    # free the program's state before the reference runs
    ctx.engine = ctx.store = ctx.decoder = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    found = check.numbers(ctx)
    limits = ctx.cell["limits"]
    correct = check.verdict(found, limits) and ctx.failed == 0
    out = result(ctx, found, limits, correct)
    if control:
        low = check.numbers(ctx, control=True)
        out["control"] = {"numbers": low, "correct": check.verdict(low, limits)}
        out["compared"] = out.pop("compared")  # stays the last key
    return out


def result(ctx: Context, found: dict, limits: dict, correct: bool) -> dict:
    bench = common.benchmark()
    wanted = "per_layer" if ctx.traced else "end_to_end"
    metrics = {}
    for m in bench[wanted]:
        if ctx.name not in m.get("workloads", [ctx.name]):
            continue
        if ctx.traced:
            value = common.load_reader(m["name"])(ctx)
        elif m["name"] == "setup_s":
            value = ctx.setup_s
        elif m["name"] == "peak_mem_gib":
            value = ctx.window_peak_bytes / 2 ** 30 if ctx.device.type == "cuda" else None
        else:
            value = ctx.e2e.get(m["name"])
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": torch.cuda.get_device_name(0) if ctx.device.type == "cuda" else "cpu",
           "count": 1,
           "memory_peak_bytes": max(ctx.setup_peak_bytes, ctx.window_peak_bytes)}
    out = {"correct": bool(correct), "attempted": ctx.attempted, "failed": ctx.failed,
           "metrics": metrics, "device": dev}
    if ctx.traced and ctx.summary is not None:
        s = ctx.summary
        dev["busy_s"], dev["window_s"] = s.busy_s, s.window_s
        top = sorted(s.by_kernel.items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[n[:160], t] for n, t in top],
                            "idle_gaps": [[n[:160], t] for n, t in s.idle_gaps]}
    out["compared"] = {k: {"value": found.get(k), "limit": v} for k, v in limits.items()}
    return out
