"""Mixed-family zoo: ONE ``MergeAwareEngine`` serving dense, ssm, hybrid
and moe variants off one merged ``ParamStore`` (the port of
``benchmarks/mixed_zoo.py``).

    PYTHONPATH=src python -m repro_torch.bench.mixed_zoo [--device cuda|cpu] [--smoke]

Two fine-tune variants per family — ``dense`` (transformer), ``ssm``
(Mamba), ``hybrid`` (Griffin), ``moe`` — all behind the same
``MergeableAdapter`` contract.  Every variant carries the same
token-embedding table where the shapes allow it (LM fleets share a
tokenizer's table across backbones; at the adapters' tiny defaults all
eight do), trunks diverge by a small fine-tuning perturbation within each
family and heads diverge hard.  The pipeline runs end to end:

1. **Plan** — the family-aware ``RepresentationSimilarityScorer`` (an ssm
   trunk never clusters with a transformer trunk even where shapes
   coincide; the embedding, final norm and head stay cross-family with CKA
   deciding) and ``StagedPlanner`` over all eight members' trunk records,
   the plan shipped as JSON.
2. **Serve** — the unmerged store, then the shipped plan hot-swapped into a
   live engine on a fresh store: shared-prefix micro-batches within each
   family's merged pair, suffix-bank fan-out for the private heads.  The
   ``kernels.ops`` dispatch counters are reset before the merged serve and
   read after the decode: the scan kernels must have fired.
3. **Verify** — every served row against a replay of the engine's own
   dispatch on the same bindings, each instance through its own program
   (``lm_merging.verify_bitwise``), bitwise; banked rows against each
   member's own suffix.
4. **Decode** — the same engine's streaming tier with all four families in
   flight in one decoder (KV pages for dense and moe, the first-slot
   recurrent state for ssm and hybrid), one slot per family, every
   completion replayed through its family's unpaged ``decode_step``
   (``decode_serve.replay_check``): bitwise on the CPU; on the card within
   the replay tolerance of the dtype, since the bank is its own kernel.

The reference's interpret leg (Pallas kernel bodies on the CPU) has no
counterpart: the port has no interpret mode.  On the CPU the plain
versions run; on the card the kernels run, and ``chip_smoke.py`` holds
each against its plain version.  ``chip_smoke.py`` runs this bench at its
defaults (head dim 16) and at the full widths of olmo-1b, olmoe-1b-7b,
falcon-mamba-7b and recurrentgemma-9b, depth cut.

Everything the run takes is one :class:`ZooScenario`; :func:`numpy_scenario`
draws the zoo on its device (:func:`zoo_members`) and the tokens from
numpy, and the CPU parity tests inject the JAX bench's own draws instead.
``BENCH_mixed_zoo.json`` goes to ``artifacts/torch/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.bench.common import check_gates, emit
from repro_torch.bench.decode_serve import REPLAY_TOL, replay_check
from repro_torch.bench.lm_merging import verify_bitwise
from repro_torch.core import MergePlan, ParamStore, RepresentationSimilarityScorer, StagedPlanner
from repro_torch.core.policy import CoherenceSurrogateTrainer, calibration_activations
from repro_torch.kernels import ops as kops
from repro_torch.models.registry import get_adapter
from repro_torch.serving.costs import costs_for
from repro_torch.serving.decode import DecodeRequest
from repro_torch.serving.executor import MergeAwareEngine, ModelProgram, Request
from repro_torch.serving.workload import instances_from_store
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import flatten_paths, unflatten_paths

FAMILIES = ("dense", "ssm", "hybrid", "moe")
VARIANTS = ("A", "B")
MIN_SIMILARITY = 0.7
TRUNK_SCALE, HEAD_SCALE = 0.005, 1.0
BUCKETS = (1, 2, 4)
SEQ = 8
PAGE_SIZE = 4
MAX_LEN = 16
PROMPT_LEN = 4
MAX_NEW = 8
# one slot per family: every trunk group carries one row at a time, the
# batch the unpaged replay steps at
DECODE_KW = dict(page_size=PAGE_SIZE, num_pages=96, max_slots=len(FAMILIES), max_len=MAX_LEN,
                 buckets=(1, 2, 4, 8))


def is_head(path: str) -> bool:
    return path.startswith(("final_norm/", "lm_head/"))


def zoo_members(configs: Optional[dict] = None, device=None) -> dict:
    """{model_id: (adapter, cfg, params)}: two variants per family of
    ``configs`` ({family: cfg}, default each adapter's tiny config), keyed
    in the reference's order (family by family, A then B).  Each family's
    base is drawn from seed = its index; one token-embedding table per
    (shape, dtype), drawn once (0.02 N(0, 1), seed 999 + its index) and
    shared by every family whose table has that shape and dtype.  A keeps
    the base trunk (the same tensors), B's trunk gets + 0.005 N(0, 1), and
    both heads + 1.0 N(0, 1), drawn on ``device`` from seed 100 + 10 family
    + variant, leaves in sorted path order."""
    dev = resolve_device(device)
    tables: dict = {}
    members = {}
    for fi, fam in enumerate(FAMILIES):
        adapter = get_adapter(fam)
        cfg = adapter.default_config() if configs is None else configs[fam]
        base = flatten_paths(adapter.init(cfg, seed=fi, device=dev))
        t = base["embed/table"]
        key = (tuple(t.shape), t.dtype)
        if key not in tables:
            gen = torch.Generator(device=dev).manual_seed(999 + len(tables))
            tables[key] = (0.02 * torch.randn(t.shape, generator=gen, device=dev)).to(t.dtype)
        base["embed/table"] = tables[key]
        for vi, variant in enumerate(VARIANTS):
            gen = torch.Generator(device=dev).manual_seed(100 + 10 * fi + vi)
            flat = dict(base)
            for path in sorted(flat):
                scale = HEAD_SCALE if is_head(path) else (TRUNK_SCALE if variant == "B" else 0.0)
                if path == "embed/table" or not scale:
                    continue  # the shared table stays the cross-family merge target
                leaf = flat[path]
                noise = torch.randn(leaf.shape, generator=gen, device=dev)
                flat[path] = leaf + (scale * noise).to(leaf.dtype)
            members[f"{fam}-{variant}"] = (adapter, cfg, unflatten_paths(flat))
    return members


@dataclasses.dataclass
class ZooScenario:
    """The inputs of one mixed-zoo run.  ``members`` ({model_id: (adapter,
    cfg, params)}, its order orders the stores and the planner's records)
    is never mutated.  ``payload(i, j)`` is the (1, seq) token payload of
    the ``j``-th request of the ``i``-th member in sorted order,
    ``prompt(i, j)`` the int32 numpy prompt of family ``i``'s variant
    ``j``; ``planner_clock()`` makes the planner's clock."""

    members: dict
    calibration: dict
    payload: Callable[[int, int], torch.Tensor]
    prompt: Callable[[int, int], np.ndarray]
    max_new: int = MAX_NEW
    decode_kw: dict = dataclasses.field(default_factory=lambda: dict(DECODE_KW))
    planner_clock: Callable[[], Callable[[], float]] = lambda: time.monotonic

    @property
    def mids(self) -> tuple:
        return tuple(sorted(self.members))

    @property
    def device(self) -> torch.device:
        params = next(iter(self.members.values()))[2]
        return next(iter(flatten_paths(params).values())).device


def numpy_scenario(configs: Optional[dict] = None, device=None, seq: int = SEQ,
                   prompt_len: int = PROMPT_LEN, **kw) -> ZooScenario:
    """:func:`zoo_members` on ``device`` (default ``cuda``); the calibration
    batch (32 sequences of 8 tokens), request payloads of ``seq`` tokens and
    decode prompts of ``prompt_len`` drawn from numpy.  ``kw`` sets the
    scenario's other fields."""
    dev = resolve_device(device)
    members = zoo_members(configs, dev)
    vocab = min(cfg.vocab_size for _, cfg, __ in members.values())
    toks = np.random.default_rng(7).integers(0, vocab, (32, 9)).astype(np.int32)
    calibration = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                   "labels": torch.from_numpy(toks[:, 1:]).to(dev)}

    def payload(i, j):
        rng = np.random.default_rng((100, i, j))
        return torch.from_numpy(rng.integers(0, vocab, (1, seq)).astype(np.int32)).to(dev)

    def prompt(i, j):
        return np.random.default_rng((1000, i, j)).integers(0, vocab, prompt_len).astype(np.int32)

    return ZooScenario(members, calibration, payload, prompt, **kw)


@torch.no_grad()
def plan_zoo(scn: ZooScenario) -> tuple:
    """The family-aware CKA prefilter and the staged search over every
    member's trunk records (calibration activations computed once, for the
    scorer and the coherence surrogate).  Returns (PlanResult, the
    planning store, the scorer)."""
    members = scn.members
    store = ParamStore.from_models({m: p for m, (_, __, p) in members.items()})
    recs = []
    for m, (adapter, cfg, params) in members.items():
        trunk = adapter.split(cfg).prefix_paths
        recs += [r for r in adapter.records(cfg, params, m) if r.path in trunk]
    acts = calibration_activations(members, scn.calibration)
    scorer = RepresentationSimilarityScorer(
        acts, MIN_SIMILARITY, families={m: a.family for m, (a, _, __) in members.items()})
    trainer = CoherenceSurrogateTrainer(acts, MIN_SIMILARITY)
    regs = [adapter.registered(cfg, m, i + 10, accuracy_target=0.0, device=scn.device)
            for i, (m, (adapter, cfg, _)) in enumerate(sorted(members.items()))]
    res = StagedPlanner(store, regs, recs, trainer, scorer=scorer,
                        clock=scn.planner_clock()).run()
    return res, store, scorer


def zoo_engine(scn: ZooScenario, store, suffix_bank: bool = True) -> MergeAwareEngine:
    """One engine over all eight programs, at a capacity that holds the
    whole unmerged zoo (the reference's 10**9 does so for its tiny zoo)."""
    programs = [ModelProgram.from_adapter(adapter, m, cfg=cfg)
                for m, (adapter, cfg, _) in sorted(scn.members.items())]
    return MergeAwareEngine(
        store, instances_from_store(store, "tiny-yolo", model_ids=list(scn.mids)),
        programs, capacity_bytes=10 ** 9 + store.resident_bytes(),
        costs={"tiny-yolo": costs_for("tiny-yolo")}, buckets=BUCKETS,
        suffix_bank=suffix_bank)


def zoo_requests(scn: ZooScenario, n_per_model: int) -> list:
    """Deadlines interleave families and variants round-robin, so every
    serve pass mixes the merged pairs' micro-batches of all four families."""
    mids = scn.mids
    return [Request(m, scn.payload(i, j), 0.0, 10.0 + (j * len(mids) + i) * 1e-3)
            for i, m in enumerate(mids) for j in range(n_per_model)]


def decode_requests(scn: ZooScenario) -> list:
    """One request per member, wave-ordered (every A variant, then every
    B): with one slot per family each trunk group carries one live row at
    a time."""
    return [DecodeRequest(f"{fam}-{variant}", scn.prompt(i, j), max_new_tokens=scn.max_new,
                          deadline_s=60.0)
            for j, variant in enumerate(VARIANTS) for i, fam in enumerate(FAMILIES)]


def _serve(scn: ZooScenario, store, n_per_model: int, plan=None) -> tuple:
    eng = zoo_engine(scn, store)
    swap = eng.apply_plan(plan) if plan is not None else None
    reqs = zoo_requests(scn, n_per_model)
    for r in reqs:
        eng.submit(r)
    return eng, eng.serve(horizon_s=60.0, warmup=reqs[0].payload), swap


def _stats_row(path: str, resident: int, stats: dict) -> dict:
    return {
        "path": path, "resident_bytes": resident,
        "completed": stats.get("completed", ""),
        "requests_per_s": stats.get("requests_per_s", ""),
        "prefix_runs": stats.get("prefix_runs", ""),
        "suffix_dispatches": stats.get("suffix_dispatches", ""),
        "tokens_decoded": stats.get("tokens_decoded", ""),
        "sla_fraction": stats.get("sla_fraction", ""),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_zoo(scn: ZooScenario, n_per_model: int) -> tuple:
    """The whole pipeline.  Returns (rows, derived, info): ``derived`` holds
    the reference's keys (its interpret leg aside); ``info`` the scenario
    facts a card run prints — host seconds of each stage, the scorer's
    ``pruned_cross_family``, the serve's and the decode's stats, the
    replay checks."""
    members = scn.members
    fam_of = {m: a.family for m, (a, _, __) in members.items()}
    params_of = {m: p for m, (_, __, p) in members.items()}
    seconds = {}

    def stage(name, t0):
        _sync(scn.device)
        seconds[name] = time.perf_counter() - t0

    # CLOUD: plan over the mixed zoo, ship JSON
    t0 = time.perf_counter()
    res, cloud, scorer = plan_zoo(scn)
    stage("plan", t0)
    del cloud
    t0 = time.perf_counter()
    payload = res.plan.to_json()
    stage("to_json", t0)
    t0 = time.perf_counter()
    plan = MergePlan.from_json(payload)
    stage("from_json", t0)
    plan_bytes = len(payload)
    del payload
    cross_member = [pg for pg in plan.groups if any(len(c.members) >= 2 for c in pg.columns)]
    cross_family = [pg for pg in plan.groups
                    if any(len({fam_of[r.model_id] for r in c.members}) >= 2
                           for c in pg.columns)]

    # EDGE baseline: the unmerged twin serves the same trace
    t0 = time.perf_counter()
    base_store = ParamStore.from_models(params_of)
    base_resident = base_store.resident_bytes()
    base_eng, base_stats, _ = _serve(scn, base_store, n_per_model)
    stage("serve_unmerged", t0)
    del base_eng, base_store

    # EDGE merged: hot-swap the shipped plan, then serve with the dispatch
    # counters watching the hot path
    store = ParamStore.from_models(params_of)
    eng = zoo_engine(scn, store)
    t0 = time.perf_counter()
    swap = eng.apply_plan(plan)
    stage("apply_plan", t0)
    del plan
    merged_resident = store.resident_bytes()
    kops.reset_dispatch_counts()
    reqs = zoo_requests(scn, n_per_model)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    merged_stats = eng.serve(horizon_s=60.0, warmup=reqs[0].payload)
    stage("serve_merged", t0)
    t0 = time.perf_counter()
    bitwise, bank_gap, bank_rel = verify_bitwise(eng, store, buckets=BUCKETS)
    stage("verify", t0)

    # streaming decode: all four families in flight through ONE decoder
    t0 = time.perf_counter()
    dec_stats = eng.serve_decode(decode_requests(scn), record_logits=True, **scn.decode_kw)
    stage("decode", t0)
    counts = kops.dispatch_counts()
    dtype = next(iter(members.values()))[1].dtype
    t0 = time.perf_counter()
    replay = replay_check(eng.last_decoder, REPLAY_TOL["cpu" if scn.device.type == "cpu" else dtype])
    stage("decode_replay", t0)

    rows = [
        _stats_row("unmerged", base_resident, base_stats),
        _stats_row("merged-plan", merged_resident, merged_stats),
        _stats_row("merged-decode", merged_resident, dec_stats),
    ]
    derived = {
        "families_served": len(set(fam_of.values())),
        "models": len(members),
        "plan_bytes": plan_bytes,
        "committed_groups": res.committed,
        "cross_member_groups": len(cross_member),
        "cross_family_groups": len(cross_family),
        "memory_saved_bytes": base_resident - merged_resident,
        "memory_saved_pct": 100 * (base_resident - merged_resident) / base_resident,
        "epoch_bumps": swap["epoch_bumps"],
        "outputs_bitwise_ref": bitwise,
        "decode_outputs_bitwise": replay["bitwise"],
        **{f"dispatch_{k}": counts.get(k, 0) for k in (
            "mamba_scan", "rg_lru_scan", "flash_attention", "decode_attention",
            "page_gather", "bank_matmul")},
    }
    info = {
        "seconds": seconds, "pruned_cross_family": scorer.pruned_cross_family,
        "pruned_prefilter": res.pruned, "retrain_attempts": res.attempted,
        "base_resident_bytes": base_resident, "merged_resident_bytes": merged_resident,
        "shared_keys": len(swap["shared_keys"]), "serve_stats": merged_stats,
        "decode_stats": dec_stats, "bank_gap": bank_gap, "bank_gap_over_row_max": bank_rel,
        "decode_replay": replay, "cross_family_signatures": sorted(
            {pg.signature[0] for pg in cross_family}),
    }
    return rows, derived, info


def gates(derived: dict, info: dict, device: torch.device) -> dict:
    """The reference's acceptance gates (``scripts/ci.sh``'s mixed-zoo
    lane) but its interpret ones.  Served rows equal the replay of the
    engine's dispatch bitwise on either device, and banked rows are within
    2e-2 of the row maximum of each member's own suffix.  Decode: bitwise
    against the unpaged replay on the CPU; on the card, where the bank is
    its own kernel, within the replay tolerance of the dtype."""
    g = {
        "families_served == 4": derived["families_served"] == 4,
        "cross_member_groups >= 1": derived["cross_member_groups"] >= 1,
        "cross_family_groups >= 1": derived["cross_family_groups"] >= 1,
        "memory_saved_bytes > 0": derived["memory_saved_bytes"] > 0,
        "outputs_bitwise_ref": bool(derived["outputs_bitwise_ref"]),
        "bank_gap_over_row_max <= 2e-2": info["bank_gap_over_row_max"] <= 2e-2,
        **{f"{k} dispatched": derived[f"dispatch_{k}"] > 0 for k in (
            "mamba_scan", "rg_lru_scan", "flash_attention", "decode_attention",
            "page_gather", "bank_matmul")},
    }
    if device.type == "cpu":
        g["decode_outputs_bitwise"] = bool(derived["decode_outputs_bitwise"])
    else:
        g["decode replay within tolerance"] = bool(info["decode_replay"]["ok"])
    return g


def run(scn: Optional[ZooScenario] = None, device=None, smoke: bool = False) -> tuple:
    scn = numpy_scenario(device=device) if scn is None else scn
    rows, derived, info = run_zoo(scn, 4 if smoke else 8)
    out = emit("BENCH_mixed_zoo_smoke" if smoke else "BENCH_mixed_zoo", rows, derived)
    return out, info, scn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    ap.add_argument("--smoke", action="store_true", help="4 requests a member, not 8")
    args = ap.parse_args(argv)
    out, info, scn = run(device=args.device, smoke=args.smoke)
    check_gates("mixed_zoo", gates(out["derived"], info, scn.device))


if __name__ == "__main__":
    main()
