"""Streaming decode serving benchmark (the port of
``benchmarks/decode_serve.py``; DESIGN.md D1): paged KV + continuous
batching over merged variants against the per-request decode baseline.

    PYTHONPATH=src python -m repro_torch.bench.decode_serve [--device cuda|cpu] [--smoke]

The default (tiny) config has head dim 16, which the attention kernels do
not compile, so it runs on the CPU only; ``chip_smoke.py`` runs the bench
on the card at stablelm-1.6b's width.

Three lanes over the LM fine-tune-variant scenario (``bench.lm_merging``):

1. **baseline** — ``EdgeExecutor.serve_decode``: each request served to
   completion on its own contiguous KV cache, the prompt in one chunked
   step, then one ``decode_step`` per generated token;
2. **merged-paged** — the shipped MergePlan hot-swapped into a live
   ``MergeAwareEngine``, then ``serve_decode``: continuous batching over the
   paged pool, ONE shared-trunk and ONE suffix-bank dispatch per step for
   the merged (A, B, D, E) group, foreign C through the paged singleton
   step.  A second, smaller trace with logits recorded is replayed through
   the unpaged ``decode_step`` (:func:`replay_check`);
3. **mid-decode hot swap** — start UNMERGED and apply the plan while
   requests are in flight (after step 4): one epoch bump, no request lost,
   the merged group forming on the very next step.

On a card both decode lanes replay CUDA graphs of their steps, as the JAX
package runs jitted ones.  ``--smoke`` shrinks the trace and writes
``BENCH_decode_smoke`` instead of ``BENCH_decode`` (under
``artifacts/torch/``).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.bench.common import check_gates, emit
from repro_torch.bench.lm_merging import LMScenario, lm_engine, numpy_scenario, ship_plan
from repro_torch.core import ParamStore
from repro_torch.serving.costs import costs_for
from repro_torch.serving.decode import DecodeRequest, replay_unpaged
from repro_torch.serving.executor import EdgeExecutor, ModelProgram
from repro_torch.serving.workload import instances_from_store

PROMPT_LEN = 4
MAX_NEW = 12
REQS_PER_MODEL = 16
PAGE_SIZE = 8
MAX_LEN = 16  # = prompt + max_new - 1, rounded to a page multiple
NUM_PAGES = 128
MAX_SLOTS = 32
BUCKETS = (1, 2, 4, 8, 16, 32)
SWAP_STEP = 4
# the replay check holds each streamed logits row to the unpaged replay's
# after dividing both by the replay row's largest magnitude: 1e-5 on the
# CPU, where torch's GEMMs give a row other bits at another batch size
# (float32 at the bench's config); on the card the JAX package's
# kernel-test tolerances by dtype, as chip_smoke.py's replay check
REPLAY_TOL = {"cpu": 1e-5, "float32": 2e-3, "bfloat16": 2e-2}


def decode_requests(scn: LMScenario, n_per_model: int, prompt_len: int, max_new: int) -> list:
    """Interleaved across variants (A, B, C, D, E, A, ...) so the in-flight
    batch always mixes members of the merged group."""
    return [DecodeRequest(m, scn.prompt(i, j, prompt_len), max_new_tokens=max_new,
                          deadline_s=60.0)
            for j in range(n_per_model) for i, m in enumerate(scn.mids)]


def baseline_executor(scn: LMScenario, store) -> EdgeExecutor:
    """The per-request lane's executor, at a capacity that holds the whole
    unmerged zoo (the reference's 10**9 does so for its tiny zoo)."""
    return EdgeExecutor(
        store, instances_from_store(store, "tiny-yolo", model_ids=list(scn.mids)),
        {m: scn.adapter.bound_forward(scn.cfg) for m in scn.mids},
        capacity_bytes=10 ** 9 + store.resident_bytes(),
        costs={"tiny-yolo": costs_for("tiny-yolo")})


def replay_tol(scn: LMScenario) -> float:
    return REPLAY_TOL["cpu" if scn.device.type == "cpu" else scn.cfg.dtype]


def replay_check(decoder, tol: float) -> dict:
    """Every completion replayed teacher-forced through the unpaged
    ``decode_step`` at batch 1 (``serving.decode.replay_unpaged``).
    ``bitwise``: every token and logits row equal bitwise (the JAX bench's
    check, which its CPU meets: XLA's GEMMs are row-stable across the batch
    size, torch's and the card's are not).  ``ok``: every row within
    ``tol`` of the replay's, scaled by the replay row's largest magnitude,
    and no token other than the replay's argmax where the replay's top-2
    margin exceeds ``tol`` (1 + |top|) (a confident flip)."""
    bitwise, close, worst, flips, confident = True, True, 0.0, 0, 0
    for c in decoder.completions:
        rows = replay_unpaged(decoder, c)
        bitwise &= len(rows) == len(c.tokens)
        for i, row in enumerate(rows):
            want, got = torch.from_numpy(row), torch.from_numpy(c.logits[i])
            bitwise &= torch.equal(got, want) and c.tokens[i] == int(want.argmax())
            scale = max(want.abs().max().item(), 1e-30)
            worst = max(worst, (got - want).abs().max().item() / scale)
            close &= torch.allclose(got / scale, want / scale, rtol=tol, atol=tol)
            if c.tokens[i] != int(want.argmax()):
                flips += 1
                top1, top2 = torch.topk(want, 2).values.tolist()
                confident += top1 - top2 > tol * (1 + abs(top1))
    return dict(bitwise=bitwise, ok=close and confident == 0, max_err_over_row_max=worst,
                argmax_mismatches=flips, confident_argmax_mismatches=confident, tol=tol)


def _lane_row(lane: str, stats: dict) -> dict:
    return {"lane": lane, "tokens_per_s": stats["tokens_per_s"],
            "tokens_decoded": stats["tokens_decoded"], "steps": stats["steps"],
            "completed": stats["completed"], "elapsed_s": stats["elapsed_s"]}


def run_lanes(scn: LMScenario, n_per_model: int, max_new: int, plan=None, on_lane=None) -> tuple:
    """The three lanes, each on its own store over the zoo's tensors, built
    and dropped in turn.  ``plan`` skips the cloud step with a decoded
    plan.  ``on_lane(name, engine_or_executor, stats)`` sees each lane (and
    ``"verify"``, the logits-recording pass) before it is dropped.
    Returns (rows, derived)."""
    adapter, cfg, mids = scn.adapter, scn.cfg, scn.mids
    plan = ship_plan(scn)["plan"] if plan is None else plan
    reqs = decode_requests(scn, n_per_model, PROMPT_LEN, max_new)
    decode_kw = dict(page_size=PAGE_SIZE, num_pages=NUM_PAGES, max_slots=MAX_SLOTS,
                     max_len=MAX_LEN, buckets=BUCKETS)
    report = on_lane or (lambda *a: None)

    # lane 1: per-request baseline on the unmerged store
    base = baseline_executor(scn, ParamStore.from_models(dict(scn.zoo)))
    programs = [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in mids]
    base_stats = base.serve_decode(reqs, programs, max_len=MAX_LEN)
    report("per-request-baseline", base, base_stats)
    del base

    # lane 2: merged + paged + continuous batching (no logits recorded: that
    # would read every step back to the host and tax the measurement)
    eng = lm_engine(scn, ParamStore.from_models(dict(scn.zoo)))
    swap = eng.apply_plan(plan)
    eng_stats = eng.serve_decode(reqs, **decode_kw)
    report("merged-paged-continuous", eng, eng_stats)
    # the check: a small trace with logits recorded, every completion
    # replayed token by token through the UNPAGED decode_step
    verify_reqs = decode_requests(scn, 2, PROMPT_LEN, max_new)
    verify_stats = eng.serve_decode(verify_reqs, record_logits=True, **decode_kw)
    replay = replay_check(eng.last_decoder, replay_tol(scn))
    report("verify", eng, verify_stats)
    del eng

    # lane 3: mid-decode hot swap on a fresh UNMERGED engine
    swap_eng = lm_engine(scn, ParamStore.from_models(dict(scn.zoo)))
    swap_state = {}

    def on_step(dec, step):
        if step == SWAP_STEP and not swap_state:
            swap_state["in_flight_at_swap"] = len(dec.slots)
            swap_state["apply"] = swap_eng.apply_plan(plan)

    swap_stats = swap_eng.serve_decode(reqs, on_step=on_step, **decode_kw)
    report("mid-decode-hot-swap", swap_eng, swap_stats)
    del swap_eng

    rows = [_lane_row("per-request-baseline", base_stats),
            _lane_row("merged-paged-continuous", eng_stats),
            _lane_row("mid-decode-hot-swap", swap_stats)]
    derived = {
        "decode_speedup": eng_stats["tokens_per_s"] / max(base_stats["tokens_per_s"], 1e-9),
        "outputs_bitwise_identical": replay["bitwise"],
        "outputs_match_replay": replay["ok"],
        "replay_max_err_over_row_max": replay["max_err_over_row_max"],
        "replay_argmax_mismatches": replay["argmax_mismatches"],
        "replay_confident_argmax_mismatches": replay["confident_argmax_mismatches"],
        "replay_tol": replay["tol"],
        "plan_epoch_bumps": swap["epoch_bumps"],
        # merged-group dispatch discipline: ONE shared trunk + ONE bank
        # fan-out per step in which the merged group had live rows
        "group_steps": eng_stats["group_steps"],
        "trunk_dispatch_per_group_step": (eng_stats["trunk_dispatches"]
                                          / max(eng_stats["group_steps"], 1)),
        "bank_dispatch_per_group_step": (eng_stats["bank_dispatches"]
                                         / max(eng_stats["group_steps"], 1)),
        "head_dispatches": eng_stats["head_dispatches"],
        "lost_in_flight": eng_stats["lost_in_flight"],
        "pool_identity_ok": eng_stats["pool_identity_ok"] and swap_stats["pool_identity_ok"],
        "pool_high_water_pages": eng_stats["pool_high_water_pages"],
        "max_active": eng_stats["max_active"],
        # mid-decode hot swap acceptance
        "swap_epoch_bumps": swap_stats["epoch_bumps"],
        "swap_in_flight_at_swap": swap_state.get("in_flight_at_swap", 0),
        "swap_survivors": swap_stats["swap_survivors"],
        "swap_lost_in_flight": swap_stats["lost_in_flight"],
        "swap_completed": swap_stats["completed"],
        "swap_trunk_dispatches": swap_stats["trunk_dispatches"],
        "swap_bank_dispatches": swap_stats["bank_dispatches"],
        "requests": len(reqs),
    }
    return rows, derived


def gates(d: dict, smoke: bool = False) -> dict:
    """The streaming-decode gates of ``scripts/ci.sh`` (D1), the replay
    held at ``replay_tol`` instead of bitwise (:func:`replay_check`); the
    timed one, ``decode_speedup >= 2``, only on the full trace, as the
    reference's check does."""
    g = {
        "outputs_match_replay": d["outputs_match_replay"],
        "trunk_dispatch_per_group_step == 1": d["trunk_dispatch_per_group_step"] == 1.0,
        "bank_dispatch_per_group_step == 1": d["bank_dispatch_per_group_step"] == 1.0,
        "swap_epoch_bumps == 1": d["swap_epoch_bumps"] == 1,
        "swap_lost_in_flight == 0": d["swap_lost_in_flight"] == 0,
        "swap_completed == requests": d["swap_completed"] == d["requests"],
        "lost_in_flight == 0": d["lost_in_flight"] == 0,
        "pool_identity_ok": d["pool_identity_ok"],
    }
    if not smoke:
        g["decode_speedup >= 2"] = d["decode_speedup"] >= 2.0
    return g


def run(scn: LMScenario = None, device=None, smoke: bool = False) -> dict:
    scn = numpy_scenario(device=device) if scn is None else scn
    if smoke:
        rows, derived = run_lanes(scn, n_per_model=2, max_new=4)
        return emit("BENCH_decode_smoke", rows, derived)
    rows, derived = run_lanes(scn, REQS_PER_MODEL, MAX_NEW)
    return emit("BENCH_decode", rows, derived)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    ap.add_argument("--smoke", action="store_true",
                    help="small trace, writes BENCH_decode_smoke")
    args = ap.parse_args(argv)
    out = run(device=args.device, smoke=args.smoke)
    check_gates("decode_serve", gates(out["derived"], smoke=args.smoke))


if __name__ == "__main__":
    main()
