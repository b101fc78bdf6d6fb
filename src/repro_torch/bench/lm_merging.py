"""GEMEL merging applied to an LM zoo: pod sizing and merge-and-serve (the
port of ``benchmarks/lm_merging.py``).

    PYTHONPATH=src python -m repro_torch.bench.lm_merging [--device cuda|cpu] [--retrain]

The default (tiny) config has head dim 16; ``chip_smoke.py`` runs the
bench on the card at its defaults and at stablelm-1.6b's width.

Five transformer fine-tune variants — (A, B, D, E) of common trunk
provenance with divergent heads, C an independent init — go through the
whole pipeline: a CKA-prefiltered ``StagedPlanner`` search over the trunk
(heads stay private), the ``MergePlan`` shipped as JSON, hot-swapped into a
live ``MergeAwareEngine`` on a fresh store, and shared-prefix batched
serving.  Request deadlines interleave the variants, so every shared
micro-batch carries rows of all four merged heads: the per-member path fans
out four suffix dispatches per micro-batch, the suffix bank exactly one.
The merged scenario is served both ways beside the unmerged store;
``BENCH_lm_serve.json`` (under ``artifacts/torch/``) records memory saved,
the three lanes' throughput, the bank's dispatch counts and the replay
check of every served row (:func:`verify_bitwise`).

Everything the lanes take is one :class:`LMScenario`: the zoo, the
calibration batch, the request tokens and the planner's registrations.
:func:`numpy_scenario` draws the zoo on its device (:func:`lm_zoo`) and
the tokens from numpy; ``chip_smoke.py`` calls it at full-width
stablelm-1.6b on the card, and the CPU parity tests inject the JAX bench's
own draws instead.  The lanes' stores share the zoo's tensors (a store
rebinds, it never writes a buffer), so the zoo is held once.

``--retrain`` swaps the calibration-coherence surrogate for the joint
``MergeTrainer`` (a plumbing proof, at ``accuracy_target=0.0``).  It runs on
the CPU: on the card the Hopper kernels have no backward and refuse a call
autograd would record (``ops.require_no_grad``), as the JAX package cannot
retrain an LM through its Pallas kernels.

:func:`pod_sizing` sizes a pod of fine-tuned variants of the assigned
architectures from their full configs' ``meta`` parameter trees (nothing is
allocated): the memory an Optimal and a GEMEL-capped merge save, and the
signature overlap of six architecture pairs (``lm_merging.json``).  The
JAX bench builds those trees in its stacked layout (``scan_layers=True``:
one record per stack of blocks), so its per-model cap of 12 leaves counts
stacked leaves; :func:`stacked_records_tree` folds the port's per-layer
meta leaves into that layout for the records alone.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.bench.common import check_gates, emit
from repro_torch.configs.registry import all_arch_ids, load_arch
from repro_torch.core import MergePlan, ParamStore, RepresentationSimilarityScorer, StagedPlanner
from repro_torch.core.groups import LayerGroup, enumerate_groups, potential_savings
from repro_torch.core.merging import MergeTrainer
from repro_torch.core.policy import CoherenceSurrogateTrainer, calibration_activations
from repro_torch.core.signatures import signature_match_fraction
from repro_torch.models.registry import get_adapter
from repro_torch.serving.costs import costs_for
from repro_torch.serving.executor import MergeAwareEngine, ModelProgram, Request
from repro_torch.serving.workload import deadline_microbatches, instances_from_store, pad_stack
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import flatten_paths, unflatten_paths

# a pod workload: fine-tuned variants per arch (the paper's per-feed models
# of one architecture; here one architecture, different domains)
POD_WORKLOAD = {
    "qwen3-14b": 3,
    "olmo-1b": 4,
    "olmoe-1b-7b": 2,
    "falcon-mamba-7b": 2,
    "stablelm-1.6b": 3,
}
# the GEMEL-capped merge's per-model budget of shared (stacked) leaves
POD_CAP = 12
# the layer stacks the JAX bench's full configs keep as one (L, ...) leaf
STACKED = ("blocks", "repeats", "enc_blocks", "dec_blocks")
CROSS_ARCH_PAIRS = (("olmo-1b", "olmoe-1b-7b"), ("qwen2-72b", "qwen3-14b"),
                    ("stablelm-1.6b", "olmo-1b"), ("internvl2-2b", "olmo-1b"),
                    ("deepseek-moe-16b", "olmoe-1b-7b"),
                    ("recurrentgemma-9b", "falcon-mamba-7b"))

MIN_SIMILARITY = 0.7
MIDS = ("lm-A", "lm-B", "lm-C", "lm-D", "lm-E")  # C is the foreign init
BUCKETS = (1, 2, 4)
REQS_PER_MODEL = 8
PROMPT_TOKENS = 8


def stacked_records_tree(params: dict) -> dict:
    """``params`` with each per-layer stack of :data:`STACKED`
    (``blocks/<i>/...``) folded into one leaf per path of shape (L, ...),
    the layout the JAX bench's records see.  For ``meta`` trees
    ``torch.stack`` allocates nothing; the port never stacks weights."""
    out = dict(params)
    for key in STACKED:
        if key not in params:
            continue
        layers = [flatten_paths(params[key][str(i)]) for i in range(len(params[key]))]
        out[key] = unflatten_paths({p: torch.stack([f[p] for f in layers])
                                    for p in layers[0]})
    return out


def _records_for(arch: str, variant: int) -> list:
    mod = load_arch(arch)
    cfg = mod.full_config()
    adapter = get_adapter(mod.FAMILY)
    return adapter.records(cfg, stacked_records_tree(adapter.eval_params(cfg)),
                           f"{arch}@{variant}")


def pod_sizing() -> list:
    """The pod workload's savings at Optimal and under GEMEL's memory-forward
    cap, then the cross-architecture signature overlap (the LM Fig 4)."""
    recs = []
    for arch, n in POD_WORKLOAD.items():
        for v in range(n):
            recs.extend(_records_for(arch, v))
    pot = potential_savings(recs)
    total = pot["total_bytes"]
    shared = collections.Counter()
    saved = committed = 0
    for g in enumerate_groups(recs):
        active = [r for col in g.columns() if len(col) >= 2 for r in col]
        if len(active) < 2:
            continue
        counts = collections.Counter(r.model_id for r in active)
        if any(shared[m] + c > POD_CAP for m, c in counts.items()):
            continue
        shared.update(counts)
        saved += LayerGroup(g.signature, active).savings
        committed += 1
    rows = [{
        "analysis": "pod_workload",
        "models": sum(POD_WORKLOAD.values()),
        "total_gb": total / 1e9,
        "optimal_saved_pct": 100 * pot["fraction_saved"],
        "gemel_saved_pct": 100 * saved / total,
        "groups_committed": committed,
    }]
    arch_recs = {a: _records_for(a, 0) for a in all_arch_ids()}
    for a, b in CROSS_ARCH_PAIRS:
        frac = signature_match_fraction(arch_recs[a], arch_recs[b])
        rows.append({
            "analysis": "cross-arch", "models": 2, "total_gb": "",
            "optimal_saved_pct": "", "gemel_saved_pct": "",
            "groups_committed": f"{a}|{b}: {100*frac:.1f}% identical",
        })
    return rows


def _perturb(params, seed, scale, select=None):
    """Gaussian-perturb leaves (optionally only paths accepted by
    ``select``) — emulates fine-tuning divergence without a training run.
    The noise is drawn with numpy (``default_rng(seed)``, leaves in sorted
    path order) and added in each leaf's dtype on its device; unselected
    leaves pass through as the same tensors."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in sorted(flatten_paths(params).items()):
        if select is None or select(path):
            noise = torch.from_numpy(rng.standard_normal(tuple(leaf.shape), dtype=np.float32))
            leaf = leaf + scale * noise.to(device=leaf.device, dtype=leaf.dtype)
        out[path] = leaf
    return unflatten_paths(out)


def perturb(params, seed: int, scale: float, select) -> dict:
    """Gaussian-perturb the leaves whose path ``select`` accepts (others
    pass through as the same tensors).  The noise is drawn on the leaves'
    device (one ``torch.Generator`` seeded with ``seed``, leaves in sorted
    path order) and added in each leaf's dtype, so a full-width zoo is
    drawn on the card: its ~5e9 draws take minutes with numpy on the host.
    :func:`_perturb` keeps numpy's draws, the same on every device, for
    the small zoos of the drift and plan-search benches."""
    flat = flatten_paths(params)
    gen = torch.Generator(device=next(iter(flat.values())).device).manual_seed(seed)
    out = {}
    for path in sorted(flat):
        leaf = flat[path]
        if select(path):
            noise = torch.randn(leaf.shape, generator=gen, device=leaf.device)
            leaf = leaf + scale * noise.to(leaf.dtype)
        out[path] = leaf
    return unflatten_paths(out)


def is_head(path: str) -> bool:
    return path.startswith(("final_norm/", "lm_head/"))


def lm_zoo(adapter, cfg, device=None) -> dict:
    """(A, B, D, E): common trunk provenance (trunk + 0.005·N(0,1)),
    independently 'fine-tuned' heads (+ 1.0·N(0,1)) — the merged group whose
    suffix fan-out the bank fuses.  C: an independent init (seed 42),
    architecturally identical, functionally foreign.  Keyed in the JAX
    bench's order (A, C, B, D, E), which orders the planner's records.
    Drawn on ``device`` (:func:`perturb`)."""
    base = adapter.init(cfg, seed=0, device=device)
    zoo = {"lm-A": base, "lm-C": adapter.init(cfg, seed=42, device=device)}
    for i, mid in enumerate(("lm-B", "lm-D", "lm-E")):
        v = perturb(base, 2 * i + 1, 0.005, lambda p: not is_head(p))
        zoo[mid] = perturb(v, 2 * i + 2, 1.0, is_head)
    return zoo


@dataclasses.dataclass
class LMScenario:
    """The inputs of one LM merge-and-serve study.  ``zoo`` ({model_id:
    params}; its order orders the stores and the planner's records) is
    never mutated: every store is built over its tensors.  ``payload(i,
    j)`` is the (1, S) token payload of member ``mids[i]``'s ``j``-th
    request, ``prompt(i, j, n)`` the (n,) int32 numpy prompt of its
    ``j``-th decode request (``bench.decode_serve``); ``planner_clock()``
    makes each planner's clock."""

    adapter: Any
    cfg: Any
    zoo: dict
    calibration: dict
    payload: Callable[[int, int], torch.Tensor]
    prompt: Callable[[int, int, int], np.ndarray]
    planner_clock: Callable[[], Callable[[], float]] = lambda: time.monotonic

    @property
    def mids(self) -> tuple:
        """The serving order: the members sorted."""
        return tuple(sorted(self.zoo))

    @property
    def device(self) -> torch.device:
        return next(iter(flatten_paths(next(iter(self.zoo.values()))).values())).device


def numpy_scenario(cfg=None, device=None) -> LMScenario:
    """The dense adapter's default (tiny) config, or ``cfg``, on ``device``
    (default ``cuda``): the zoo drawn there by :func:`lm_zoo`, the
    calibration batch (32 sequences of 8 tokens), request tokens and decode
    prompts drawn from numpy."""
    dev = resolve_device(device)
    adapter = get_adapter("dense")
    cfg = adapter.default_config() if cfg is None else cfg
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (32, 9)).astype(np.int32)
    calibration = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                   "labels": torch.from_numpy(toks[:, 1:]).to(dev)}

    def payload(i, j):
        rng = np.random.default_rng((100, i, j))
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, PROMPT_TOKENS))
                                .astype(np.int32)).to(dev)

    def prompt(i, j, n):
        return np.random.default_rng((1000, i, j)).integers(0, cfg.vocab_size, n).astype(np.int32)

    return LMScenario(adapter, cfg, lm_zoo(adapter, cfg, dev), calibration, payload, prompt)


def plan_variants(scn: LMScenario, retrain: bool = False):
    """CKA-prefiltered staged search over the trunk (heads stay private):
    the coherence surrogate, or with ``retrain`` ``MergeTrainer(max_epochs=
    2)``.  Returns (PlanResult, cloud store)."""
    adapter, cfg = scn.adapter, scn.cfg
    store = ParamStore.from_models(dict(scn.zoo))
    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m, p in scn.zoo.items() for r in adapter.records(cfg, p, m) if r.path in trunk]
    with torch.no_grad():
        acts = calibration_activations({m: (adapter, cfg, p) for m, p in scn.zoo.items()},
                                       scn.calibration)
    scorer = RepresentationSimilarityScorer(acts, MIN_SIMILARITY)
    # accuracy_target=0.0: synthetic random-token accuracy cannot vet a
    # merge, so --retrain proves the joint-training plumbing only
    regs = [adapter.registered(cfg, m, i + 10, accuracy_target=0.0, device=scn.device)
            for i, m in enumerate(sorted(scn.zoo))]
    trainer = (MergeTrainer(max_epochs=2) if retrain
               else CoherenceSurrogateTrainer(acts, MIN_SIMILARITY))
    planner = StagedPlanner(store, regs, recs, trainer, scorer=scorer, clock=scn.planner_clock())
    if retrain:
        return planner.run(), store
    with torch.no_grad():
        return planner.run(), store


def lm_engine(scn: LMScenario, store, suffix_bank: bool = True) -> MergeAwareEngine:
    """An engine over every member, at a capacity that holds the whole
    unmerged zoo (the reference's 10**9 does so for its tiny zoo): the
    study is about sharing, not swapping.  tiny-yolo's cost table stands in
    for the scheduler's accounting; bytes come from the store."""
    programs = [ModelProgram.from_adapter(scn.adapter, m, cfg=scn.cfg) for m in scn.mids]
    return MergeAwareEngine(
        store, instances_from_store(store, "tiny-yolo", model_ids=list(scn.mids)),
        programs, capacity_bytes=10 ** 9 + store.resident_bytes(),
        costs={"tiny-yolo": costs_for("tiny-yolo")}, buckets=BUCKETS, suffix_bank=suffix_bank)


def lm_requests(scn: LMScenario) -> list:
    """REQS_PER_MODEL requests per member; deadlines interleave the members
    round-robin, so a merged group's EDF micro-batches carry rows of every
    member."""
    mids = scn.mids
    return [Request(m, scn.payload(i, j), 0.0, 10.0 + (j * len(mids) + i) * 1e-3)
            for i, m in enumerate(mids) for j in range(REQS_PER_MODEL)]


def _serve(scn: LMScenario, store, plan=None, suffix_bank: bool = True) -> tuple:
    """A fresh engine over ``store`` (``plan`` hot-swapped in first), the
    whole trace submitted and served after a warm-up.  Returns (engine,
    stats, the swap's report or None)."""
    eng = lm_engine(scn, store, suffix_bank=suffix_bank)
    swap = eng.apply_plan(plan) if plan is not None else None
    reqs = lm_requests(scn)
    for r in reqs:
        eng.submit(r)
    return eng, eng.serve(horizon_s=60.0, warmup=reqs[0].payload), swap


def prefix_entries(eng) -> int:
    """What the JAX engine's ``prefix_jits`` counts for a run that serves
    every group: the distinct (prefix callable, binding signature) pairs of
    its shared groups, one compiled prefix each.  The port compiles
    nothing, so it counts the entries a compiler would key."""
    return len({(MergeAwareEngine._callable_key(eng.programs[iid].prefix), eng._binding_sig(iid))
                for group in eng.prefix_groups() if len(group) > 1 for iid in group})


@torch.no_grad()
def verify_bitwise(eng, store, buckets=BUCKETS, since=0, gaps=None) -> tuple:
    """Served rows against a replay of the engine's own dispatch on the same
    bindings, each instance through its own program (so a mixed zoo's
    griffin suffix never replays a transformer head): each group's
    micro-batches are rebuilt exactly (``deadline_microbatches`` is
    deterministic and a group drains in one visit), then shared groups run
    the prefix once on the same padded batch and the same suffix dispatch
    as the engine — the suffix bank for a micro-batch with rows of several
    members of a bankable group, otherwise each member's head on its rows
    gathered and padded onto the bucket ladder — and singletons the
    composed forward.  ``since`` restricts the check to completions
    appended after that index.  Returns ``(bitwise, bank_gap,
    bank_gap_over_row_max)``: ``bitwise`` is True iff every row equals its
    replay bitwise (``gaps``, when a list, receives ``(instance_id, meta,
    max_abs_gap)`` for each row that does not); ``bank_gap`` is the largest
    absolute gap of a banked row to the member's own ``suffix`` run over
    the whole batch, the JAX package's check, which holds the bank against
    a second path, and ``bank_gap_over_row_max`` the largest such gap over
    the largest magnitude of the member's own row (both 0.0 when no
    micro-batch was banked).

    The JAX package's replay runs each member's suffix over the WHOLE batch
    and takes the member's row; that is bitwise there because XLA's CPU
    GEMMs give a row the same bits at any batch size.  torch's CPU GEMMs do
    not, and on the card the bank is its own kernel, so this replay repeats
    the dispatch the engine made."""
    progs = eng.programs
    completions = eng.completions[since:]
    res = {id(c.request): c.result for c in completions}
    by_iid: dict = {}
    for c in completions:
        by_iid.setdefault(c.request.instance_id, []).append(c.request)
    bad = [] if gaps is None else gaps
    n_bad = len(bad)
    bank_gap = bank_rel = 0.0

    def check(r, want):
        got = res[id(r)]
        if not torch.equal(got, want):
            bad.append((r.instance_id, r.meta, (got.float() - want.float()).abs().max().item()))

    def params(iid):
        return store.materialize(progs[iid].model_id)

    for group in eng.prefix_groups():
        greqs = [r for iid in group for r in by_iid.get(iid, [])]
        bankable = len(group) > 1 and eng._group_bankable(tuple(group))
        lead = progs[group[0]]
        for mb in deadline_microbatches(greqs, buckets):
            batch, _ = pad_stack([r.payload for r in mb.requests], mb.bucket)
            if len(group) == 1:
                out = lead.forward(params(group[0]), batch)
                for j, r in enumerate(mb.requests):
                    check(r, out[j])
                continue
            feats = lead.prefix(params(group[0]), batch)
            if bankable and len({r.instance_id for r in mb.requests}) > 1:
                bank = store.materialize_bank(tuple(progs[i].model_id for i in group),
                                              lead.suffix_paths)
                out = lead.bank_suffix(bank, feats)
                slot = {iid: i for i, iid in enumerate(group)}
                own = {iid: progs[iid].suffix(params(iid), feats)
                       for iid in {r.instance_id for r in mb.requests}}
                for j, r in enumerate(mb.requests):
                    got, mine = out[slot[r.instance_id], j].float(), own[r.instance_id][j].float()
                    check(r, out[slot[r.instance_id], j])
                    gap = (got - mine).abs().max().item()
                    bank_gap = max(bank_gap, gap)
                    bank_rel = max(bank_rel, gap / max(mine.abs().max().item(), 1e-30))
                continue
            rows: dict = {}
            for j, r in enumerate(mb.requests):
                rows.setdefault(r.instance_id, []).append(j)
            for iid, idx in rows.items():
                if len(idx) == mb.bucket:
                    sub = feats
                else:
                    sb = next(b for b in buckets if len(idx) <= b)
                    take = idx + [idx[-1]] * (sb - len(idx))
                    sub = feats[torch.tensor(take, device=feats.device)]
                out = progs[iid].suffix(params(iid), sub)
                for k, j in enumerate(idx):
                    check(mb.requests[j], out[k])
    return len(bad) == n_bad, bank_gap, bank_rel


def _lane_row(path: str, resident: int, stats: dict) -> dict:
    return {"path": path, "resident_bytes": resident, "completed": stats["completed"],
            "requests_per_s": stats["requests_per_s"], "prefix_runs": stats["prefix_runs"],
            "suffix_dispatches": stats["suffix_dispatches"], "sla_fraction": stats["sla_fraction"]}


def ship_plan(scn: LMScenario, retrain: bool = False) -> dict:
    """The cloud step: plan (:func:`plan_variants`), ``to_json``,
    ``from_json``.  Returns {"result": PlanResult, "plan": the decoded
    MergePlan, "plan_bytes", "seconds": {step: host s}}."""
    seconds = {}
    t0 = time.perf_counter()
    res, cloud = plan_variants(scn, retrain=retrain)
    del cloud
    seconds["plan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    payload = res.plan.to_json()
    seconds["to_json"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = MergePlan.from_json(payload)
    seconds["from_json"] = time.perf_counter() - t0
    return {"result": res, "plan": plan, "plan_bytes": len(payload), "seconds": seconds}


def merge_and_serve(scn: LMScenario, retrain: bool = False, shipped=None, on_lane=None) -> tuple:
    """The three lanes on the same trace: the unmerged store, then the
    shipped plan hot-swapped into a live engine and served with per-member
    suffixes, then again with the suffix bank, whose rows
    :func:`verify_bitwise` replays.  ``shipped`` (:func:`ship_plan`'s
    result) skips the cloud step.  ``on_lane(name, engine, stats)`` sees
    each lane before its store is dropped; each lane's store and engine go
    before the next one's are built.  Returns (rows, derived)."""
    shipped = ship_plan(scn, retrain=retrain) if shipped is None else shipped
    res, plan = shipped["result"], shipped["plan"]
    cross = [pg for pg in plan.groups if any(len(c.members) >= 2 for c in pg.columns)]

    lanes = {}
    for name, with_plan, bank in (("unmerged", False, True), ("merged-plan", True, False),
                                  ("merged-plan-bank", True, True)):
        store = ParamStore.from_models(dict(scn.zoo))
        eng, stats, swap = _serve(scn, store, plan if with_plan else None, suffix_bank=bank)
        lane = dict(stats=stats, resident=store.resident_bytes(), swap=swap)
        if bank:
            lane["bitwise"], lane["bank_gap"], _ = verify_bitwise(eng, store)
            lane["prefix_jits"] = prefix_entries(eng)
        if on_lane is not None:
            on_lane(name, eng, stats)
        lanes[name] = lane
        del eng, store
    base, nobank, merged = lanes["unmerged"], lanes["merged-plan"], lanes["merged-plan-bank"]
    bs, ns, ms = base["stats"], nobank["stats"], merged["stats"]
    rows = [_lane_row("unmerged", base["resident"], bs),
            _lane_row("merged-plan", nobank["resident"], ns),
            _lane_row("merged-plan-bank", merged["resident"], ms)]
    saved = base["resident"] - merged["resident"]
    derived = {
        "trainer": "merge-trainer" if retrain else "coherence-surrogate",
        "plan_bytes": shipped["plan_bytes"],
        "committed_groups": res.committed,
        "cross_variant_groups": len(cross),
        "retrain_attempts": res.attempted,
        "pruned_prefilter": res.pruned,
        "memory_saved_bytes": saved,
        "memory_saved_pct": 100 * saved / base["resident"],
        "shared_keys": len(merged["swap"]["shared_keys"]),
        "epoch_bumps": merged["swap"]["epoch_bumps"],
        "prefix_jits": merged["prefix_jits"],
        "outputs_bitwise_identical": merged["bitwise"],
        "throughput_ratio": ms["requests_per_s"] / max(bs["requests_per_s"], 1e-9),
        # suffix-bank acceptance (DESIGN.md S2): one dispatch per shared
        # micro-batch, >= 1.5x the per-member fan-out engine on this scenario
        "bank_speedup_rps": ms["requests_per_s"] / max(ns["requests_per_s"], 1e-9),
        "suffix_dispatches": ms["suffix_dispatches"],
        "suffix_dispatches_nobank": ns["suffix_dispatches"],
        "shared_microbatches": ms["microbatches"] - ms["forward_runs"],
        "bank_hits": ms["bank_hits"],
        "bank_gap": merged["bank_gap"],
    }
    return rows, derived


def gates(d: dict) -> dict:
    """The bench's own acceptance check and the structural suffix-bank
    gates of ``scripts/ci.sh`` (S2).  Its timed one, ``bank_speedup_rps >=
    1.5``, is :func:`timed_gates`: printed, not held, by :func:`main`, as
    the reference bench's own check leaves it to CI."""
    return {
        "cross_variant_groups >= 1": d["cross_variant_groups"] >= 1,
        "outputs_bitwise_identical": d["outputs_bitwise_identical"],
        "memory_saved_bytes > 0": d["memory_saved_bytes"] > 0,
        "suffix_dispatches == shared_microbatches":
            d["suffix_dispatches"] == d["shared_microbatches"],
        "suffix_dispatches < suffix_dispatches_nobank":
            d["suffix_dispatches"] < d["suffix_dispatches_nobank"],
    }


def timed_gates(d: dict) -> dict:
    return {"bank_speedup_rps >= 1.5": d["bank_speedup_rps"] >= 1.5}


def run(scn: LMScenario = None, device=None, retrain: bool = False) -> dict:
    emit("lm_merging", pod_sizing(), {
        "note": "fine-tuned variants of one arch share 100% of signatures; "
                "cross-arch overlap mirrors the paper's same/cross-family split",
    })
    scn = numpy_scenario(device=device) if scn is None else scn
    rows, derived = merge_and_serve(scn, retrain=retrain)
    return emit("BENCH_lm_serve", rows, derived)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    ap.add_argument("--retrain", action="store_true",
                    help="the joint MergeTrainer instead of the coherence surrogate "
                         "(CPU only: the CUDA kernels have no backward)")
    args = ap.parse_args(argv)
    out = run(device=args.device, retrain=args.retrain)
    print(f"# timed gates (not held): {timed_gates(out['derived'])}")
    check_gates("lm_serve", gates(out["derived"]))


if __name__ == "__main__":
    main()
