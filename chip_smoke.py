#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and the script
exits non-zero; every phase opens with a ``phase_start`` line giving the
device memory still allocated and closes with its seconds):

1. device: name, count, torch version and the card's power limit;
2. build: compiles the hand-written CUDA kernels from ``kernels/csrc``,
   fails on any ptxas spill, and counts the tensor-core instructions
   (``HGMMA``, ``HMMA``) of each kernel function in the built library;
3. kernels: each Hopper kernel against its plain PyTorch version on the
   card at the main paths' shapes (the bank also at the falcon-mamba and
   decode heads; the attention kernels also at olmo/olmoe's 16 heads of
   128 and the tiny configs' head dim 16) and a few edge shapes, with the
   route taken, kernel,
   plain, library and bound times (bytes, operations or, for the scan,
   exponentials at the special-function units' rate); the wgmma bank
   also bitwise against its own rows at M = 1 and N = 1; every
   decode_attention row bitwise alone (B = 1) and in its batch, with
   lengths straddling its key chunks; a mamba_scan serve scan bitwise
   against the same steps chained at S = 1 (``mamba_chain``), and the
   same for rg_lru_scan in float32 and bf16 (``rg_lru_chain``: its
   "scan" route against its "step" route); every rg_lru_scan row names
   the route its launch counted, "plain" included (d = 1001);
4. small_cnn merge-and-serve: two members, trunk merged, through
   ``MergeAwareEngine``; completions against direct forwards;
5. ``paper_sim`` (host only): ``examples/merge_and_serve.py``'s simulated
   comparison for each of the paper's 15 workloads at memory setting
   ``min`` — time/space sharing (``none``) against every identical layer
   merged (``optimal``): instances, effective accuracy, processed fraction
   and modelled swap time of both, and the accuracy gain; MP2 at all four
   settings.  These are the paper's Table 1/2 cost model, not this card's
   times.  Gate: merging swaps no more and is no less accurate, for every
   workload;
6. for each full-width group below, cut in depth (``FAMILY_LAYERS``:
   stablelm-1.6b 12 of 24 layers, falcon-mamba-7b 8 of 64,
   recurrentgemma-9b 6 of 38 as two (rec, rec, attn) periods; printed as
   ``layers`` / ``published_layers``), three fine-tune variants (shared base,
   trunk perturbed by 0.005, head by 1.0), every trunk group merged, 8
   requests of 128 tokens per member served through ``MergeAwareEngine``
   (``<prefix>_merge`` / ``_serve``): kernel launch counts (every bank and
   flash launch on the tensor-core route, every scan on mamba_scan's and
   rg_lru_scan's "scan" route), residency, and
   every served row against the member's direct forward on the same
   padded batch; then one more micro-batch under ``torch.profiler``
   (``_profile``: device time by kernel, device idle share, rg_lru_scan's
   device time):
   * stablelm-1.6b (dense: ``flash_attention``, ``bank_matmul`` suffix bank),
     with GEMEL's comparison against time/space sharing at a swap
     capacity (the merged group's bytes, the largest bucket's activation
     and 0.05e9: one unmerged member fits, two never do), the modelled DMA
     on at 16 GB/s: before the merge, ``EdgeExecutor`` serves the same 24
     requests one at a time on the unmerged store (``stablelm_timeshare``)
     and decodes two requests per member one at a time on a contiguous
     cache (``stablelm_timeshare_decode``); after it, a second engine at
     that capacity serves fresh copies of the 24 (``..._engine``).  Each
     line reports completed, skipped, SLA, requests (or tokens) a second,
     the scheduler's loads, loaded bytes and evictions, the modelled DMA
     seconds and launches.  Gates: every request accounted for, served rows
     against direct forwards, flash (and no bank) in the time-shared serve,
     decode_attention (and no gather or bank) in its decode with first
     tokens matching the direct forwards' argmax outside near-ties, the
     bank on ``wgmma`` in the engine, which loads strictly fewer bytes;
   * falcon-mamba-7b (ssm: ``mamba_scan``, ``bank_matmul`` suffix bank),
   * recurrentgemma-9b (hybrid: ``rg_lru_scan``, ``flash_attention`` at
     head dim 256, a tied head served per member);
7. streaming decode on the merged stablelm-1.6b, falcon-mamba-7b and
   recurrentgemma-9b stores (``<prefix>_decode``): 8 requests of 96 prompt
   tokens per member, 32 new tokens each, through
   ``MergeAwareEngine.serve_decode`` (a pool of 128 pages of 16, 8 slots,
   chunked prefill, max_len 128, for recurrentgemma 2048 = its window; KV
   pages for stablelm, one state slot per request for falcon-mamba and for
   recurrentgemma, whose slot holds the (h, conv) of its 4 recurrent layers
   and a 2048-slot KV ring for each of its 2 attention layers); dispatch
   discipline (a banked head per group step, or for recurrentgemma's tied
   head one head per member), kernel launch counts over the streaming run
   (every mamba scan and rg_lru_scan on its "step" route; rg_lru_scan
   once per recurrent layer per trunk pass, each at S = 1), pool
   accounting, one request per
   member replayed teacher-forced through the unpaged decode (with a
   batch-8 control; ``chip_griffin_rows.py`` finds which operations make
   recurrentgemma's rows depend on the batch size); then pure
   decode steps with all 8 slots live, timed and under ``torch.profiler``
   (``_decode_profile``).  For stablelm, ``stablelm_timeshare_decode_speedup``
   then sets its tokens a second over the per-request lane's, beside the
   JAX package's own gate of 2 (reported, not asserted), and
   ``stablelm_ckpt`` puts the merged group through the checkpoint
   manager: an unmerged copy of the same members and the merged store
   ``save_store``d (``keep=1``: the unmerged one GC'd), file bytes beside
   ``resident_bytes()`` (merged within 1%), save and restore seconds, the
   merged store restored onto the card and a fresh engine built on it;
   the same 24 requests served and 6 stream-decoded (chunked prefill,
   paged) through the engine before the save and the restored one, rows,
   tokens and logits bitwise, the four LM kernels launched in the
   restored lanes;
8. GEMEL's planning step on a full-width stablelm-1.6b zoo cut to 6 of
   its 24 layers (``PLAN_LAYERS``; ``stablelm_plan_cloud`` /
   ``stablelm_plan``; phase 9c measures the transport at the whole
   depth): lm-A/B/D of phase 6 and
   a foreign lm-C; the CKA-prefiltered ``StagedPlanner`` with the
   coherence surrogate over the trunk records (calibration: 32 sequences
   of 8 tokens), the plan shipped as JSON with its bf16 weights, the cloud
   store freed, then ``MergeAwareEngine.apply_plan`` on a live engine over
   a fresh unmerged store with 8 requests of 128 tokens per member already
   queued, and the serve.  Gates: a cross-variant group, one epoch bump,
   every request served, one bank dispatch per shared micro-batch, rows
   against direct forwards, shared buffers bitwise the cloud's (by
   digest), resident bytes no more than the hand merge of lm-A/B/D plus
   lm-C unmerged, tensor-core routes only;
8b. the LM benches at full stablelm-1.6b width: ``stablelm_lm_serve``
   (``repro_torch.bench.lm_merging``: the JAX bench's five members, lm-C
   foreign, planned, shipped and served unmerged, merged per member and
   merged through the bank; the structural suffix-bank gates of
   scripts/ci.sh, each member's argmax agreement with its original,
   ``bank_speedup_rps`` beside the JAX gate of 1.5) and
   ``stablelm_decode_serve`` (``repro_torch.bench.decode_serve`` on that
   zoo and plan: the per-request lane, the merged paged lane, its
   replay and the mid-decode hot swap; the structural D1 gates, the
   replay at 2e-2 of the row maximum, graph replays in both lanes;
   ``decode_speedup`` beside the JAX gate of 2 with each lane's wall and
   device time a step and idle share).  The decode steps of phase 7,
   phase 6's per-request lane and these lanes replay CUDA graphs
   (``repro_torch.serving.graphs``);
9. GEMEL's drift loop (``repro_torch.bench.drift_adapt``) on seven
   full-width stablelm-1.6b members cut to 6 of their 24 layers
   (``DRIFT_LAYERS``; ``stablelm_drift``): first the
   pre-drift agreement that lm_zoo's recipe (trunk + 0.005) leaves each
   merged variant, then a zoo of trunk + 0.0002, head + 1.0 variants
   (each merge lossy; each member's pre-drift agreement printed) planned
   with the CKA prefilter and the coherence surrogate, shipped as JSON and
   hot-swapped into a live engine; a ``ManualClock`` timeline of 8
   periods of 10 s under ``LifecycleController`` (checks: per-position
   argmax agreement with each member's current original on 16 prompts of
   32 tokens, target 0.5), lm-B's original replaced at period 3, and a
   static timeline on the same decoded plan.  Gates: breach within a
   period with the revert in the same tick (one epoch bump, requests
   pending), one revert, one swap, 20 s to recover, every request served,
   savings restored >= 0.8, warm <= cold re-plan attempts, the static
   lane's lm-B under target, post-swap rows bitwise their replay, banked
   rows within 2e-2 of each member's own suffix over the batch, and rows
   within 2e-2 of the direct forwards.  Then on that engine
   (``stablelm_swap_failure``) a swap failure armed after one column: the
   deployed plan's apply raises with one epoch bump, bindings restored and
   the queue kept, and a clean re-apply serves it.  Then the ported
   ``drift_adapt`` and ``overload`` benches at their small-CNN scale,
   each with its scripts/ci.sh gates, and after them the ported
   ``serve_throughput`` (240 requests, with the per-member suffix lane)
   and ``plan_search`` benches with theirs;
9b. the paper's evaluation benches (``paper_benches``, host only): every
   ported host bench — Tables 1-3, Figs 3-5 and 9-13, fig14's surrogate
   sweep, the ordering ablation — over the 15 workloads, each bench's
   derived numbers beside the paper's string it carries; the paper's cost
   model, not this card's times.  Gates on fig10's rows: GEMEL swaps no
   more than time/space sharing and is no less accurate, but for the one
   row (MP4 at 75%) where the JAX package's model reads lower too;
9c. ``fig7_sharing_accuracy``: the bench's two small CNNs pretrained on
   the card, the first 0, 2, 4, 6, 8 and all layers shared, 8 epochs of
   joint retraining each, under deterministic cuDNN; gate: every layer
   shared leaves the least relative accuracy no higher than none; then
   ``stablelm_plan_wire``: fig14's plan-wire lane
   (``repro_torch.bench.fig14_bandwidth``) on the full-width
   stablelm-1.6b zoo of phase 8b, planned at the threshold that leaves
   lm-C some shared columns and not all (0.7 when it does, else
   ``tap_cka``'s separating one), plan v1 deployed on an edge store, the
   columns lm-C does not bind "retrained" on the cloud, plan v2 exported
   ``full``, ``delta`` and ``delta_q8`` (JSON and payload bytes, entry
   kinds, ``to_json`` / ``from_json`` / ``apply_plan`` seconds), the
   delta_q8 plan applied; gates: lm-C bitwise, the others within the
   drift monitor's threshold, both entry kinds, flash launched;
   ``wire_ratio_delta_q8`` printed beside the reference's 0.35 (the
   cloud keeps the reference's float32 sums, so the changed buffers ship
   as float32 ``full`` entries);
9d. GEMEL across model families (``repro_torch.bench.mixed_zoo``): the
   mixed zoo at the adapters' defaults (``mixed_zoo``: head dim 16,
   float32) and at the published widths of olmo-1b, olmoe-1b-7b,
   falcon-mamba-7b and recurrentgemma-9b, depth cut
   (``MIXED_ZOO_LAYERS``, printed; ``mixed_zoo_full``): two variants a
   family planned with the family-aware CKA prefilter, shipped as JSON,
   hot-swapped into one engine on a fresh store, served (8 requests a
   member) and stream-decoded with all four families in one decoder (one
   slot per family); resident bytes unmerged and merged, plan bytes,
   committed, cross-member and cross-family groups, ``pruned_cross_family``,
   each stage's seconds, peak device memory and each kernel's launches.
   Gates: the bench's (four families, a cross-member and a cross-family
   group, memory saved, served rows bitwise their replay, banked rows
   within 2e-2 of the row maximum, the decode replay within the dtype's
   tolerance) and all six kernels launched.  Before them,
   ``lm_bench_defaults`` runs ``python -m repro_torch.bench.<name>`` for
   lm_merging, decode_serve and fig14_bandwidth at their defaults (head
   dim 16), each holding its own gates;
9e. the family call surface of all ten architectures
   (``arch_families``): each of ``configs.registry.all_arch_ids()``
   through ``get_family(FAMILY)`` at full width, bf16, depth cut where
   ``ARCH_LAYERS`` says (qwen3-14b 4 of 40, qwen2-72b 2 of 80,
   deepseek-moe-16b 3 of 28, olmoe-1b-7b 2 of 16, falcon-mamba-7b 8,
   recurrentgemma-9b 6; the rest whole), each freed before the next: the
   forward over 2 prompts of 128 tokens (internvl2-2b: 256 patch
   embeddings + 64 text tokens; seamless-m4t-medium: 128 frames + 64
   target tokens), the prefill, 8 greedy decode steps, each step's logits
   and the prefill's held against the forward over the prompt and the
   tokens so far (``ARCH_BF16_TOL``, 3e-2 of the row maximum, and on the
   weights upcast in float32 ``ARCH_F32_TOL``, 1e-4; moe at capacity
   factor 8.0 for this check, as the JAX package's, its bf16 check held
   where its routing agrees with the forward's at the checked position,
   its flipped decisions printed); weight bytes, forward / prefill /
   per-step ms, launches by kernel.  Then three internvl2-2b and three
   seamless-m4t-medium variants (``lm_zoo``'s recipe) with every trunk
   column merged in one ``ParamStore`` (resident bytes before and after;
   each member's accuracy from the store equal to that on its merged
   tree), and ``bench.lm_merging.pod_sizing``'s rows (host, meta
   tensors).  Gate: flash, decode, mamba_scan and rg_lru_scan launched;
   the kernel checks of phase 3 include this phase's head layouts;
9f. the training tier (``seamless_train``): ``Trainer.fit`` on
   seamless-m4t-medium at full width, depth cut to 2 + 2 of its 12 + 12
   layers (printed), bf16: AdamW under ``warmup_cosine``, 2
   microbatches, int8 gradient compression with error feedback, the
   heartbeat and straggler monitors, batches of ``launch.train.batches``
   (4 x 128 frames and 128 tokens).  6 steps straight, then 3 with a
   checkpoint, a "crash" and a fresh Trainer resuming to 6: params,
   moments, feedback and history bitwise the straight run's, no kernel
   launched (the encdec loss calls none); per-step loss, grad norm and
   ms, state and checkpoint bytes, save and restore seconds.  Then
   ``launch.train.main`` on ``cuda``: seamless-m4t-medium's smoke config
   with a checkpoint directory runs; stablelm-1.6b's raises the kernels'
   no-backward error before its first step (nothing falls back);
10. joint retraining on the card (``small_cnn_retrain``):
   ``examples/quickstart.py``'s two pretrained small CNNs through
   ``IncrementalMerger`` with ``MergeTrainer``; each attempt's shared
   gradients against the members' separate ones, and its joint loss
   before and after retraining;
11. the four serving examples of ``repro_torch.examples`` on the card at
   their own sizes (``examples``): merge_and_serve's 40 engine requests
   and cloud_edge_plan's hot swap (one epoch bump, 9 queued requests
   kept), their served rows against direct forwards, drift_and_revert's
   own draws and a drift made certain (B breached and reverted),
   quickstart's pretraining and merge; ``bank_matmul`` launched;
12. the dry run (``dryrun``): ``launch.dryrun`` in this process over
   every architecture's ``decode_32k`` and stablelm-1.6b's ``train_4k`` /
   ``prefill_32k`` (meta tensors), then ``bench.roofline.run()`` over
   them; then the count against the card (``dryrun_card``): full-width
   stablelm-1.6b's prefill of 1 x 32768 tokens and decode of 4 rows at a
   full 32768-slot cache traced and run for real through the kernels:
   argument bytes exact, outputs' shapes and dtypes equal, each warm time
   (CUDA events) at least the trace's roofline bound, the share printed
   with a profiled call's device time and idle share.

Each family's store, engine and decoder are released before the next
family's phase.  Then the ``{"kernels": [...]}`` line (each kernel's
launches summed over every serve, decode, lane and plan run above,
small_cnn's serve included, by route where a kernel has more than one;
``check_launches_by_route`` the same counted over phase 3's checks, where
a route no main-path shape takes shows; ``route`` is "cuda" for all,
``cuda_route`` the design the main row took) and, last, the device line.
Needs one card; imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; fp32 non-tensor
# exponentials a clock per SM on the special-function units (the CUDA C++
# Programming Guide's arithmetic throughput table, compute capability 9.0);
# times SMs and the SM clock, set in main()
EXP_PER_CLOCK_PER_SM = 16
EXP_PER_S = 0.0
# the JAX package's own kernel-test tolerances (tests/test_kernels.py TOL):
# float32 results differ only in summation order, bf16 ones also in where
# the final rounding lands
TOL = {"float32": dict(rtol=2e-3, atol=2e-3), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
BUCKETS = (1, 2, 4, 8)
REQS_PER_MEMBER = 8
LM_MIDS = ("lm-A", "lm-B", "lm-D")
# the planning phase's zoo: LM_MIDS and a foreign member, and the scorer's
# and surrogate's similarity floor (benchmarks/lm_merging.py's)
PLAN_MIDS = ("lm-A", "lm-B", "lm-C", "lm-D")
PLAN_MIN_SIMILARITY = 0.5
# the planning and drift phases' depth: 6 of stablelm-1.6b's 24 layers at
# full width (the plan's transport at the whole depth is measured by
# stablelm_plan_wire; this keeps the script inside its time limit)
PLAN_LAYERS = 6
DRIFT_LAYERS = 6
# the per-family merge, serve and streaming-decode phases' depth, widths
# whole: at 24 / 64 / 38 layers their decodes and profiles took 87 / 151 /
# 132 s and the script 830-1,086 s; stablelm-1.6b runs whole in phases 8b-9c
FAMILY_LAYERS = {"stablelm": 12, "falcon_mamba": 8, "recurrentgemma": 6}
# the streaming-decode phase: the pool, slot and length knobs of serve_decode
DECODE_KW = dict(page_size=16, num_pages=128, max_slots=8, max_len=128, buckets=BUCKETS,
                 chunked_prefill=True)
# recurrentgemma's decode: the unpaged replay's ring must hold the whole
# 2048-token window, as the paged ring does
RGEMMA_DECODE_KW = dict(DECODE_KW, max_len=2048)
PROMPT_LEN, NEW_TOKENS = 96, 32


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2, per_graph: int = 20) -> float:
    """Mean device time of one call of ``fn``: after ``warmup`` eager calls,
    up to ``per_graph`` calls are captured in one CUDA graph, and the graph
    is replayed until ``reps`` calls ran, between two CUDA events.  The
    graph keeps the host's per-call cost (Python, argument checks, the
    launch itself) out of the time, so a short kernel is not timed by the
    rate at which the host can launch it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    n = min(reps, per_graph)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    rounds = -(-reps // n)
    graph.replay()  # first replay uploads the graph
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (rounds * n)
    del graph
    torch.cuda.empty_cache()
    return ms


def bound(nbytes: float, ops: float, dtype: str, exps: float = 0.0) -> tuple:
    """The least time (ms) the card could take, and what sets it: bytes at
    the memory rate, operations at the peak rate for ``dtype``, or
    exponentials at the special-function units' rate."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": ops / PEAK_OPS[dtype] * 1e3}
    if exps:
        assert EXP_PER_S > 0, "main() reads the SM clock first"
        times["exponentials"] = exps / EXP_PER_S * 1e3
    by = max(times, key=times.get)
    return times[by], by


def exp_rate(torch) -> tuple:
    """(exponentials a second, SMs, max SM clock MHz): the SM clock from
    ``nvidia-smi --query-gpu=clocks.max.sm``, the SM count from the device."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return EXP_PER_CLOCK_PER_SM * sms * mhz * 1e6, sms, mhz


def kernel_name(signature: str) -> str:
    """A demangled kernel signature without its parameter list (the last
    parenthesised group; template arguments such as ``<(int)256>`` stay)."""
    if not signature.endswith(")"):
        return signature
    depth = 0
    for i in range(len(signature) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(signature[i], 0)
        if depth == 0:
            return signature[:i]
    return signature


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_bank(torch, case: str, N, M, K, F, dtype, broadcast, bias, reps, gen):
    from repro_torch.kernels import bank_matmul as kmod
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import bank_matmul_ref

    dt = getattr(torch, dtype)
    x = torch.randn((M, K) if broadcast else (N, M, K), generator=gen, device="cuda").to(dt)
    w = torch.randn((N, K, F), generator=gen, device="cuda").to(dt)
    b = torch.randn((N, F), generator=gen, device="cuda").to(dt) if bias else None
    route = kmod.route(x, w)
    out = kmod.bank_matmul(x, w, b)
    torch.cuda.synchronize()
    if route == "wgmma":  # a row's bits do not depend on M or N
        x1 = x[:1] if broadcast else x[:, :1].contiguous()
        assert torch.equal(kmod.bank_matmul(x1, w, b), out[:, :1]), f"bank {case}: M = 1 differs"
        assert torch.equal(kmod.bank_matmul(x if broadcast else x[:1], w[:1],
                                            b[:1] if bias else None), out[:1]), \
            f"bank {case}: N = 1 differs"
    plain = bank_matmul_ref(x, w, b)
    err = (out - plain).abs().max().item()
    torch.testing.assert_close(out, plain, **TOL[dtype])
    ms = cuda_ms(torch, lambda: kmod.bank_matmul(x, w, b), reps)
    plain_ms = cuda_ms(torch, lambda: bank_matmul_ref(x, w, b), reps)
    xb = x.expand(N, M, K) if broadcast else x
    if dtype == "float32":
        lib = ((lambda: torch.baddbmm(b[:, None, :], xb, w)) if bias
               else (lambda: torch.bmm(xb, w)))
    else:  # bf16 in, f32 out in one call; with a bias there is no single call
        lib = None if bias else (lambda: torch.bmm(xb, w, out_dtype=torch.float32))
    library_ms = cuda_ms(torch, lib, reps) if lib is not None else None
    cost = kops.bank_matmul_cost(x, w, b)
    bound_ms, bound_by = bound(cost.bytes, cost.flops, dtype)
    row = dict(kernel="bank_matmul", case=case, route=route, shape=dict(N=N, M=M, K=K, F=F),
               dtype=dtype, broadcast=broadcast, bias=bias, row_stable_bitwise=route == "wgmma",
               max_abs_err=err,
               tol=TOL[dtype], ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    emit("kernel_check", **row)
    return row


def check_flash(torch, case: str, B, S, Hq, Hkv, D, dtype, window, reps, gen):
    import torch.nn.functional as Fn

    from repro_torch.kernels import flash_attention as kmod
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import flash_attention_ref

    dt = getattr(torch, dtype)
    q = torch.randn((B, S, Hq, D), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dt)
    route = kmod.route(q)
    out = kmod.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    plain = flash_attention_ref(q, k, v, causal=True, window=window)
    err = (out.float() - plain.float()).abs().max().item()
    torch.testing.assert_close(out.float(), plain.float(), **TOL[dtype])
    ms = cuda_ms(torch, lambda: kmod.flash_attention(q, k, v, causal=True, window=window), reps)
    plain_ms = cuda_ms(torch, lambda: flash_attention_ref(q, k, v, causal=True, window=window),
                       reps)
    qp = torch.arange(S, device="cuda")[:, None]
    kp = torch.arange(S, device="cuda")[None, :]
    mask = kp <= qp
    if window is not None:
        mask &= (qp - kp) < window
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    gqa = Hq != Hkv
    if window is None:
        lib = lambda: Fn.scaled_dot_product_attention(qt, kt, vt, is_causal=True,  # noqa: E731
                                                      enable_gqa=gqa)
    else:
        lib = lambda: Fn.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,  # noqa: E731
                                                      enable_gqa=gqa)
    library_ms = cuda_ms(torch, lib, reps)
    # QK^T and PV over the (query, key) pairs the mask keeps
    cost = kops.flash_attention_cost(q, k, v, causal=True, window=window)
    bound_ms, bound_by = bound(cost.bytes, cost.flops, dtype)
    row = dict(kernel="flash_attention", case=case, route=route,
               shape=dict(B=B, S=S, Hq=Hq, Hkv=Hkv, D=D),
               dtype=dtype, window=window, max_abs_err=err, tol=TOL[dtype], ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    emit("kernel_check", **row)
    return row


def check_decode(torch, case: str, B, Smax, Hq, Hkv, D, dtype, lengths, reps, gen):
    """decode_attention against its plain version; run twice (the two
    results must be bitwise equal), rows of length 0 must be exact zeros,
    and each row computed alone (B = 1, Smax = its length rounded up to 16)
    must have the bits it has in the batch.  The library call is SDPA with a
    boolean length mask on the rows of length >= 1 (SDPA gives NaN on a
    fully masked row)."""
    import torch.nn.functional as Fn

    from repro_torch.kernels import decode_attention as kmod
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import decode_attention_ref

    dt = getattr(torch, dtype)
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, Smax, Hkv, D), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, Smax, Hkv, D), generator=gen, device="cuda").to(dt)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = kmod.decode_attention(q, k, v, lens)
    again = kmod.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.equal(out, again), f"decode_attention {case}: repeat launch differs"
    zero_rows = (lens == 0).nonzero().flatten().tolist()
    for b in zero_rows:
        assert torch.equal(out[b], torch.zeros_like(out[b])), f"{case}: row {b} not zero"
    for b, n in enumerate(lengths):
        s1 = -(-min(max(n, 0), Smax) // 16) * 16
        alone = kmod.decode_attention(q[b:b + 1], k[b:b + 1, :s1].contiguous(),
                                      v[b:b + 1, :s1].contiguous(), lens[b:b + 1])
        assert torch.equal(alone[0], out[b]), f"decode_attention {case}: row {b} alone differs"
    plain = decode_attention_ref(q, k, v, lens)
    err = (out.float() - plain.float()).abs().max().item()
    torch.testing.assert_close(out.float(), plain.float(), **TOL[dtype])
    ms = cuda_ms(torch, lambda: kmod.decode_attention(q, k, v, lens), reps)
    plain_ms = cuda_ms(torch, lambda: decode_attention_ref(q, k, v, lens), reps)
    live = (lens > 0).nonzero().flatten()
    qt = q[live][:, :, None, :].contiguous()
    kt, vt = k[live].transpose(1, 2).contiguous(), v[live].transpose(1, 2).contiguous()
    mask = (torch.arange(Smax, device="cuda")[None, :] < lens[live][:, None])[:, None, None, :]
    library_ms = cuda_ms(torch, lambda: Fn.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=Hq != Hkv), reps)
    keys = kops.decode_keys(lens, Smax)  # the keys this run's lengths need
    cost = kops.decode_attention_cost(q, k, v, lens)
    bound_ms, bound_by = bound(cost.bytes, cost.flops, dtype)
    row = dict(kernel="decode_attention", case=case,
               shape=dict(B=B, Smax=Smax, Hq=Hq, Hkv=Hkv, D=D), dtype=dtype,
               lengths=dict(min=min(lengths), max=max(lengths), sum=keys),
               chunk=kmod.CHUNK, blocks_working=sum(map(len, kmod.chunk_plan(lens, Smax))) * Hkv,
               zero_rows=len(zero_rows), repeat_bitwise=True, row_alone_bitwise=True,
               max_abs_err=err,
               tol=TOL[dtype], ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    emit("kernel_check", **row)
    return row


def check_gather(torch, case: str, P, W, N, dtype, reps, gen):
    """page_gather against its plain version, bit for bit; the table holds
    repeats.  The plain version IS the library call (``index_select``)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import page_gather as kmod
    from repro_torch.kernels.ref import page_gather_ref

    pool = torch.randn((P, W), generator=gen, device="cuda").to(getattr(torch, dtype))
    table = torch.randint(0, P, (N,), generator=gen, device="cuda", dtype=torch.int32)
    table[1] = table[0]
    out = kmod.page_gather(pool, table)
    torch.cuda.synchronize()
    plain = page_gather_ref(pool, table)
    assert torch.equal(out, plain), f"page_gather {case}: differs from index_select"
    ms = cuda_ms(torch, lambda: kmod.page_gather(pool, table), reps)
    plain_ms = cuda_ms(torch, lambda: page_gather_ref(pool, table), reps)
    library_ms = cuda_ms(torch, lambda: torch.index_select(pool, 0, table), reps)
    cost = kops.page_gather_cost(pool, table)
    bound_ms, bound_by = bound(cost.bytes, cost.flops, dtype)
    row = dict(kernel="page_gather", case=case, shape=dict(P=P, W=W, N=N), dtype=dtype,
               max_abs_err=0.0, bitwise=True, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    emit("kernel_check", **row)
    return row


def check_mamba(torch, case: str, B, S, di, n, dtype, zero_h0, reps, gen):
    """mamba_scan against its plain version.  Both widen the inputs to
    float32 before any arithmetic, so bf16 inputs too are held at the
    float32 tolerance; the comparison covers y and h_last.  No one PyTorch
    call computes the recurrence: the library column is null."""
    from repro_torch.kernels import mamba_scan as kmod
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import mamba_scan_ref

    dt = getattr(torch, dtype)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    args = (torch.nn.functional.softplus(rnd(B, S, di)).to(dt), rnd(B, S, di).to(dt),
            rnd(B, S, n).to(dt), rnd(B, S, n).to(dt), -torch.exp(0.5 * rnd(di, n)),
            torch.zeros((B, di, n), device="cuda") if zero_h0 else rnd(B, di, n))
    route = kmod.route(args[0])
    y, h = kmod.mamba_scan(*args)
    torch.cuda.synchronize()
    yr, hr = mamba_scan_ref(*args)
    err = max((y - yr).abs().max().item(), (h - hr).abs().max().item())
    torch.testing.assert_close(y, yr, **TOL["float32"])
    torch.testing.assert_close(h, hr, **TOL["float32"])
    ms = cuda_ms(torch, lambda: kmod.mamba_scan(*args), reps)
    plain_ms = cuda_ms(torch, lambda: mamba_scan_ref(*args), max(2, reps // 10))
    # per (row, step, channel, state): dt*A, *h, dtx*B, +, *C, + -- 6 float32
    # operations -- and one exponential on the special-function units
    cost = kops.mamba_scan_cost(*args)
    bound_ms, bound_by = bound(cost.bytes, cost.flops, "float32", exps=cost.exps)
    row = dict(kernel="mamba_scan", case=case, route=route, shape=dict(B=B, S=S, di=di, n=n),
               dtype=dtype,
               zero_h0=zero_h0, max_abs_err=err, tol=TOL["float32"], ms=ms, plain_ms=plain_ms,
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
    emit("kernel_check", **row)
    return row


def check_mamba_chain(torch, B, S, di, n, dtype, gen) -> None:
    """One serve scan of S steps ("scan" route) against S chained S = 1
    launches ("step" route) that carry h_last as the next h0: y and h_last
    bitwise equal (a serve scan and decode steps agree exactly)."""
    from repro_torch.kernels import mamba_scan as kmod

    dt = getattr(torch, dtype)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    dts, dtx = torch.nn.functional.softplus(rnd(B, S, di)).to(dt), rnd(B, S, di).to(dt)
    Bm, Cm, A, h0 = rnd(B, S, n).to(dt), rnd(B, S, n).to(dt), -torch.exp(0.5 * rnd(di, n)), \
        rnd(B, di, n)
    y, h = kmod.mamba_scan(dts, dtx, Bm, Cm, A, h0)
    hc, ys = h0, []
    for t in range(S):
        step = [x[:, t:t + 1].contiguous() for x in (dts, dtx, Bm, Cm)]
        yt, hc = kmod.mamba_scan(*step, A, hc)
        ys.append(yt)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(ys, dim=1), y), "mamba_scan: chained steps' y differ"
    assert torch.equal(hc, h), "mamba_scan: chained steps' h_last differs"
    emit("mamba_chain", shape=dict(B=B, S=S, di=di, n=n), dtype=dtype, launches=S + 1,
         y_bitwise=True, h_last_bitwise=True)


def check_rg_lru_chain(torch, B, S, d, dtype, gen) -> None:
    """rg_lru_scan's serve scan of S steps ("scan" route) against S chained
    S = 1 launches ("step" route) that carry h_last as the next h0: y and
    h_last bitwise equal, as for mamba_scan."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import rg_lru as kmod

    dt = getattr(torch, dtype)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    a, b, h0 = torch.sigmoid(rnd(B, S, d)).to(dt), rnd(B, S, d).to(dt), rnd(B, d)
    before = kops.route_launches()["rg_lru_scan"]
    y, h = kmod.rg_lru_scan(a, b, h0)
    hc, ys = h0, []
    for t in range(S):
        yt, hc = kmod.rg_lru_scan(a[:, t:t + 1].contiguous(), b[:, t:t + 1].contiguous(), hc)
        ys.append(yt)
    torch.cuda.synchronize()
    after = kops.route_launches()["rg_lru_scan"]
    routes = {r: after[r] - before[r] for r in after}
    assert routes == {"scan": 1, "step": S, "plain": 0}, routes
    assert torch.equal(torch.cat(ys, dim=1), y), "rg_lru_scan: chained steps' y differ"
    assert torch.equal(hc, h), "rg_lru_scan: chained steps' h_last differs"
    emit("rg_lru_chain", shape=dict(B=B, S=S, d=d), dtype=dtype, launches_by_route=routes,
         y_bitwise=True, h_last_bitwise=True)


def check_rg_lru(torch, case: str, B, S, d, dtype, reps, gen, floor_ms=None):
    """rg_lru_scan against its plain version (y and h_last), at the float32
    tolerance for either input dtype as for mamba_scan; library null.  h0
    is random, as a decode step carries it in from the pool.  The row's
    route is the one whose count (``ops.route_launches()``) the checked
    launch raised, held to ``kernels.rg_lru.route``.  With ``floor_ms``
    (the timing floor) the row says whether the bound lies under it: such
    a time says more about a launch than about the work."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import rg_lru as kmod
    from repro_torch.kernels.ref import rg_lru_ref

    dt = getattr(torch, dtype)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    args = (torch.sigmoid(rnd(B, S, d)).to(dt), rnd(B, S, d).to(dt), rnd(B, d))
    before = kops.route_launches()["rg_lru_scan"]
    y, h = kmod.rg_lru_scan(*args)
    torch.cuda.synchronize()
    after = kops.route_launches()["rg_lru_scan"]
    counted = [r for r in after if after[r] != before[r]]
    route = kmod.route(*args)
    assert counted == [route] and after[route] == before[route] + 1, (before, after, route)
    yr, hr = rg_lru_ref(*args)
    err = max((y - yr).abs().max().item(), (h - hr).abs().max().item())
    torch.testing.assert_close(y, yr, **TOL["float32"])
    torch.testing.assert_close(h, hr, **TOL["float32"])
    ms = cuda_ms(torch, lambda: kmod.rg_lru_scan(*args), reps)
    plain_ms = cuda_ms(torch, lambda: rg_lru_ref(*args), max(2, reps // 10))
    cost = kops.rg_lru_scan_cost(*args)
    bound_ms, bound_by = bound(cost.bytes, cost.flops, "float32")
    row = dict(kernel="rg_lru_scan", case=case, route=route, shape=dict(B=B, S=S, d=d),
               dtype=dtype, h0="carried", bytes_moved=cost.bytes,
               max_abs_err=err, tol=TOL["float32"], ms=ms, plain_ms=plain_ms,
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
    if floor_ms is not None:
        row.update(timing_floor_ms=floor_ms, bound_under_timing_floor=bound_ms < floor_ms)
    emit("kernel_check", **row)
    return row


def kernel_checks(torch) -> dict:
    from repro_torch.kernels import decode_attention as kdecode

    gen = torch.Generator(device="cuda").manual_seed(0)
    # what cuda_ms gives for a kernel that does almost nothing (one element
    # added in place): times near it say little about a kernel's work
    one = torch.zeros(1, device="cuda")
    floor_ms = cuda_ms(torch, lambda: one.add_(1.0), 200)
    emit("timing_floor", op="add_ of one float32 element", ms=floor_ms)
    main = {}
    # stablelm-1.6b head: 3 members, bucket 8 x 128 tokens, d 2048, vocab 100352
    main["bank_matmul"] = check_bank(torch, "stablelm-head", 3, 1024, 2048, 100352,
                                     "bfloat16", False, False, 5, gen)
    # falcon-mamba-7b head (d 4096, vocab 65024); the decode heads, 8 rows a member
    check_bank(torch, "falcon-mamba-head", 3, 1024, 4096, 65024, "bfloat16", False, False, 5,
               gen)
    check_bank(torch, "stablelm-decode-head", 3, 8, 2048, 100352, "bfloat16", False, False,
               20, gen)
    check_bank(torch, "falcon-mamba-decode-head", 3, 8, 4096, 65024, "bfloat16", False, False,
               20, gen)
    # the stablelm_sharded phase's shard-local head: one member of four on
    # each shard, a decode bucket of 4 rows
    check_bank(torch, "stablelm-shard-local", 1, 4, 2048, 100352, "bfloat16", False, False,
               20, gen)
    check_bank(torch, "aligned-bias", 3, 100, 264, 520, "bfloat16", True, True, 50, gen)
    check_bank(torch, "small_cnn-fc1", 2, 8, 16, 64, "float32", True, True, 50, gen)
    check_bank(torch, "small_cnn-fc2", 2, 8, 64, 4, "float32", False, True, 50, gen)
    check_bank(torch, "ragged", 3, 100, 70, 33, "bfloat16", False, True, 50, gen)
    check_bank(torch, "ragged", 3, 100, 70, 33, "float32", True, False, 50, gen)
    for dtype in ("bfloat16", "float32"):
        row = check_flash(torch, "stablelm-trunk", 8, 128, 32, 32, 64, dtype, None, 50, gen)
        if dtype == "bfloat16":
            main["flash_attention"] = row
        check_flash(torch, "gqa-ragged", 2, 200, 8, 2, 128, dtype, None, 50, gen)
        check_flash(torch, "window", 2, 256, 8, 8, 64, dtype, 32, 50, gen)
    # stablelm-1.6b decode: one layer's KV pool (128 pages of 16 x 32 x 64)
    # gathered for 8 rows x 8 pages; attention of 8 rows over Smax 128
    main["page_gather"] = check_gather(torch, "stablelm-decode", 128, 16 * 32 * 64, 64,
                                       "bfloat16", 200, gen)
    check_gather(torch, "ragged-f32", 300, 1000, 500, "float32", 200, gen)
    ragged = [128, 1, 77, 64, 96, 17, 128, 113]
    main["decode_attention"] = check_decode(torch, "stablelm-decode", 8, 128, 32, 32, 64,
                                            "bfloat16", ragged, 200, gen)
    check_decode(torch, "stablelm-decode", 8, 128, 32, 32, 64, "float32", ragged, 200, gen)
    check_decode(torch, "long-cache", 8, 4096, 32, 32, 64, "bfloat16",
                 [4096, 1, 3000, 2048, 4095, 512, 1234, 3999], 20, gen)
    check_decode(torch, "gqa-len0", 4, 1000, 32, 8, 128, "bfloat16", [1000, 0, 513, 64],
                 50, gen)
    # lengths on both sides of the kernel's chunk boundaries
    T = kdecode.CHUNK
    check_decode(torch, "split-edges", 8, 3 * T, 32, 32, 64, "bfloat16",
                 [0, 1, T - 1, T, T + 1, 2 * T - 1, 2 * T, 2 * T + 1], 50, gen)
    # falcon-mamba-7b: serve (8 x 128 tokens, di 8192, n 16, f32 coefficients)
    # and decode (S = 1 with the state from the pool)
    main["mamba_scan"] = check_mamba(torch, "falcon-serve", 8, 128, 8192, 16, "float32",
                                     True, 20, gen)
    check_mamba(torch, "falcon-serve", 8, 128, 8192, 16, "bfloat16", True, 20, gen)
    check_mamba(torch, "ragged", 3, 13, 1000, 16, "float32", False, 50, gen)
    check_mamba(torch, "falcon-decode", 8, 1, 8192, 16, "float32", False, 50, gen)
    check_mamba(torch, "n8", 8, 128, 8192, 8, "float32", False, 20, gen)
    check_mamba_chain(torch, 8, 16, 8192, 16, "float32", gen)
    for dtype in ("float32", "bfloat16"):
        check_rg_lru_chain(torch, 8, 16, 4096, dtype, gen)
    # recurrentgemma-9b: the RG-LRU at 8 x 128 tokens, d_rnn 4096 ("scan")
    main["rg_lru_scan"] = check_rg_lru(torch, "rgemma-serve", 8, 128, 4096, "float32", 50, gen)
    check_rg_lru(torch, "rgemma-serve", 8, 128, 4096, "bfloat16", 50, gen)
    # the scan's tail tiles: S past a box of steps, and S under one box
    check_rg_lru(torch, "s129", 8, 129, 4096, "float32", 50, gen)
    check_rg_lru(torch, "s13-d4096", 8, 13, 4096, "float32", 50, gen)
    check_rg_lru(torch, "ragged", 3, 13, 1000, "float32", 50, gen)
    # rows of 4004 bytes, not a multiple of 16: the "plain" route
    check_rg_lru(torch, "d1001", 3, 13, 1001, "float32", 50, gen)
    # recurrentgemma-9b decode: one token per row with h carried from the
    # pool, once per recurrent layer (26) per trunk pass
    check_rg_lru(torch, "rgemma-decode", 8, 1, 4096, "float32", 50, gen, floor_ms)
    # recurrentgemma-9b local attention: 16 query heads on one kv head of
    # 256, window 2048 (wider than the sequence), then a window that bites
    check_flash(torch, "rgemma-trunk", 8, 128, 16, 1, 256, "bfloat16", 2048, 50, gen)
    check_flash(torch, "d256-window", 2, 512, 16, 1, 256, "bfloat16", 128, 20, gen)
    # olmo-1b / olmoe-1b-7b attention: 16 heads of 128, causal; their decode
    # at 8 rows.  The tiny LM configs' head dim 16: the mixed zoo's serve
    # micro-batch (4 x 8 tokens, 2 heads, float32), a window that bites,
    # and decode
    check_flash(torch, "olmoe-trunk", 8, 128, 16, 16, 128, "bfloat16", None, 50, gen)
    for dtype in ("float32", "bfloat16"):
        check_flash(torch, "d16-tiny", 4, 8, 2, 2, 16, dtype, None, 50, gen)
        check_flash(torch, "d16-window", 2, 256, 4, 1, 16, dtype, 8, 50, gen)
        check_decode(torch, "d16-tiny", 4, 16, 2, 2, 16, dtype, [16, 1, 9, 0], 200, gen)
    check_decode(torch, "olmoe-decode", 8, 128, 16, 16, 128, "bfloat16", ragged, 200, gen)
    # the arch_families phase's head layouts (2 prompts of 128 tokens, 8
    # decode steps): qwen3-14b's 40 query heads on 8 kv heads (a group of
    # 5), qwen2-72b's 64 on 8 and its cache of 16 stored heads (kv_repl 2,
    # a group of 4), internvl2-2b's 16 on 8 over 256 patches + 64 text
    # tokens (+ 3 decoded: a partial key tile) and its cache of 16 on 16
    check_flash(torch, "qwen3-trunk", 2, 128, 40, 8, 128, "bfloat16", None, 50, gen)
    check_flash(torch, "qwen2-trunk", 2, 128, 64, 8, 128, "bfloat16", None, 50, gen)
    check_flash(torch, "internvl2-ragged", 2, 256 + 64 + 3, 16, 8, 128, "bfloat16", None, 50,
                gen)
    check_decode(torch, "qwen3-decode-g5", 2, 136, 40, 8, 128, "bfloat16", [129, 136], 200,
                 gen)
    check_decode(torch, "qwen2-decode-kv_repl", 2, 136, 64, 16, 128, "bfloat16", [129, 136],
                 200, gen)
    check_decode(torch, "internvl2-decode-kv_repl", 2, 328, 16, 16, 128, "bfloat16",
                 [321, 328], 200, gen)
    return main


# ---------------------------------------------------------------------------
# phase 4: small_cnn merge-and-serve
# ---------------------------------------------------------------------------


def trunk_groups(adapter, cfg, store, mids) -> list:
    """The layer groups of the members' trunk records."""
    from repro_torch.core import enumerate_groups

    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m in mids for r in adapter.records(cfg, store.materialize(m), m)
            if r.path in trunk]
    return enumerate_groups(recs)


def merge_trunk(adapter, cfg, store, mids) -> int:
    return sum(len(store.merge_group(g)) for g in trunk_groups(adapter, cfg, store, mids))


def make_engine(adapter, cfg, store, mids, capacity_bytes, simulate_dma=False):
    from repro_torch.serving.costs import costs_for
    from repro_torch.serving.executor import MergeAwareEngine, ModelProgram
    from repro_torch.serving.workload import instances_from_store

    programs = [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in mids]
    return MergeAwareEngine(
        store, instances_from_store(store, "tiny-yolo", model_ids=list(mids)),
        programs, capacity_bytes=capacity_bytes,
        costs={"tiny-yolo": costs_for("tiny-yolo")}, buckets=BUCKETS,
        simulate_dma=simulate_dma)


def interleaved_requests(mids, make_payload):
    """REQS_PER_MEMBER requests per member; deadlines interleave the members
    round-robin, so every EDF micro-batch carries rows of every member."""
    from repro_torch.serving.executor import Request

    return [Request(m, make_payload(), 0.0, 10.0 + (j * len(mids) + i) * 1e-3)
            for j in range(REQS_PER_MEMBER) for i, m in enumerate(mids)]


def served_vs_direct(torch, adapter, cfg, store, eng, reqs, dtype, buckets=BUCKETS) -> float:
    """Max abs error of every served row against the member's direct
    forward on the same padded batch (micro-batches rebuilt in EDF order
    over the engine's ``buckets`` — a group drains in one visit, so they
    are the engine's own)."""
    from repro_torch.serving.workload import deadline_microbatches, pad_stack

    res = {id(c.request): c.result for c in eng.completions}
    worst = 0.0
    for mb in deadline_microbatches(reqs, buckets):
        batch, _ = pad_stack([r.payload for r in mb.requests], mb.bucket)
        direct = {m: adapter.forward(cfg, store.materialize(m), batch)
                  for m in {r.instance_id for r in mb.requests}}
        for j, r in enumerate(mb.requests):
            got, want = res[id(r)].float(), direct[r.instance_id][j].float()
            torch.testing.assert_close(got, want, **TOL[dtype])
            worst = max(worst, (got - want).abs().max().item())
        del direct
    return worst


def tensor_core_routes_only(routes: dict) -> None:
    """Every bank_matmul and flash_attention launch of an LM phase (bf16
    throughout) took the tensor-core route."""
    assert routes["bank_matmul"]["simt"] == 0 and routes["flash_attention"]["simt"] == 0, routes


def scan_route_only(routes: dict, route: str) -> None:
    """Every mamba_scan and rg_lru_scan launch of a phase took ``route``:
    "scan" in a serve (whole 128-token requests), "step" in a streaming
    decode (every decode step and every prefill chunk runs the trunk one
    token at a time); no rg_lru_scan launch took "plain" (every d_rnn has
    16-byte rows)."""
    other = {"scan": "step", "step": "scan"}[route]
    assert routes["mamba_scan"][other] == 0, routes
    assert all(n == 0 for r, n in routes["rg_lru_scan"].items() if r != route), routes


def small_cnn_phase(torch) -> None:
    from repro_torch.core import ParamStore
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_adapter

    adapter = get_adapter("small_cnn")
    cfg = adapter.default_config()
    mids = ("A", "B")
    store = ParamStore.from_models(
        {m: adapter.init(cfg, seed=i, device="cuda") for i, m in enumerate(mids)})
    shared = merge_trunk(adapter, cfg, store, mids)
    eng = make_engine(adapter, cfg, store, mids, 10 ** 9)
    gen = torch.Generator(device="cuda").manual_seed(2)
    reqs = interleaved_requests(mids, lambda: torch.randn((1, 32, 32, 3), generator=gen,
                                                          device="cuda"))
    for r in reqs:
        eng.submit(r)
    ops.reset_kernel_launches()
    stats = eng.serve(horizon_s=600.0, warmup=reqs[0].payload)
    launches, routes = ops.kernel_launches(), ops.route_launches()
    err = served_vs_direct(torch, adapter, cfg, store, eng, reqs, "float32")
    assert stats["completed"] == len(reqs), stats
    assert launches["bank_matmul"] > 0, launches
    # float32 heads (F = 4) stay on the CUDA-core route
    assert routes["bank_matmul"] == {"wgmma": 0, "simt": launches["bank_matmul"]}, routes
    emit("small_cnn_serve", shared_keys=shared, stats=stats, launches=launches,
         route_launches=routes, max_abs_err_vs_forward=err, tol=TOL["float32"])
    return launches, routes


# ---------------------------------------------------------------------------
# phase 6: stablelm-1.6b at full width
# ---------------------------------------------------------------------------


def lm_zoo(torch, adapter, cfg, mids=LM_MIDS, trunk_scale: float = 0.005) -> dict:
    """Variants of one base: trunks perturbed by ``trunk_scale`` (0.005, the
    ``lm_zoo`` pattern of benchmarks/lm_merging.py), heads by 1.0, drawn
    on the card (``bench.lm_merging.perturb``)."""
    from repro_torch.bench.lm_merging import is_head, perturb

    base = adapter.init(cfg, seed=0, device="cuda")
    zoo = {mids[0]: base}
    for i, mid in enumerate(mids[1:]):
        v = perturb(base, 2 * i + 1, trunk_scale, lambda p: not is_head(p))
        zoo[mid] = perturb(v, 2 * i + 2, 1.0, is_head)
        del v
    return zoo


def cut_depth(cfg, n_layers: int):
    """``cfg`` at ``n_layers`` with its widths whole; a griffin config takes
    whole (rec, rec, attn) periods."""
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    if hasattr(cfg, "pattern"):
        cut = dataclasses.replace(cut, pattern=("rec", "rec", "attn"))
    return cut


def start_phase(torch, name: str) -> float:
    """Free what the previous phase left, print the device memory still
    allocated, and return the phase's start time."""
    gc.collect()
    torch.cuda.empty_cache()
    emit("phase_start", name=name, memory_allocated_bytes=torch.cuda.memory_allocated())
    return time.perf_counter()


def lm_requests(torch, cfg, mids, seed: int = 100) -> tuple:
    """``interleaved_requests`` of 128 seeded tokens each, and the generator
    that drew them (the same seed gives the same requests)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return gen, interleaved_requests(mids, lambda: torch.randint(
        0, cfg.vocab_size, (1, 128), generator=gen, device="cuda"))


def lm_build(torch, prefix: str, adapter, cfg) -> tuple:
    """The unmerged store of three ``lm_zoo`` variants at full width (opens
    the ``<prefix>_merge`` phase).  Returns the store and what the
    ``_merge`` line reports of the build."""
    from repro_torch.core import ParamStore

    t_phase = start_phase(torch, f"{prefix}_merge")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    store = ParamStore.from_models(lm_zoo(torch, adapter, cfg))
    torch.cuda.synchronize()
    built = dict(init_s=time.perf_counter() - t0, resident_bytes_unmerged=store.resident_bytes(),
                 peak_memory_bytes_while_building=torch.cuda.max_memory_allocated(),
                 seconds=time.perf_counter() - t_phase)
    return store, built


def lm_merge_and_serve(torch, prefix: str, adapter, cfg, store, built: dict,
                       capacity_bytes: int, expect: tuple) -> tuple:
    """Every trunk group of ``lm_build``'s store merged, 8 requests of 128
    tokens per member served through ``MergeAwareEngine`` (lines
    ``<prefix>_merge`` / ``_serve`` / ``_profile``).  ``expect`` are the
    kernels that must launch; every bank and flash launch must take the
    tensor-core route.  An untied head fans out through the suffix bank (one
    dispatch per banked micro-batch); a tied head reads the shared embedding
    table and runs once per member of a micro-batch, with no bank.  Returns
    (kernel launches of the serve, their routes, engine)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.workload import deadline_microbatches

    t0 = time.perf_counter()
    shared = merge_trunk(adapter, cfg, store, LM_MIDS)
    merged = store.resident_bytes()
    torch.cuda.empty_cache()
    unmerged = built["resident_bytes_unmerged"]
    emit(f"{prefix}_merge", config=cfg.name, layers=cfg.n_layers,
         published_layers=built["published_layers"], d_model=cfg.d_model,
         vocab=cfg.padded_vocab, dtype=cfg.dtype, tied=cfg.tie_embeddings,
         init_s=built["init_s"], shared_keys=shared, resident_bytes_unmerged=unmerged,
         resident_bytes_merged=merged, saved_fraction=1 - merged / unmerged,
         peak_memory_bytes_while_building=built["peak_memory_bytes_while_building"],
         device_allocated_bytes=torch.cuda.memory_allocated(),
         seconds=built["seconds"] + time.perf_counter() - t0)

    t_phase = start_phase(torch, f"{prefix}_serve")
    eng = make_engine(adapter, cfg, store, LM_MIDS, capacity_bytes)
    gen, reqs = lm_requests(torch, cfg, LM_MIDS)
    for r in reqs:
        eng.submit(r)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    stats = eng.serve(horizon_s=600.0, warmup=reqs[0].payload)
    serve_s = time.perf_counter() - t0
    launches, routes = ops.kernel_launches(), ops.route_launches()
    peak = torch.cuda.max_memory_allocated()
    mbs = deadline_microbatches(reqs, BUCKETS)
    members = [len({r.instance_id for r in mb.requests}) for mb in mbs]
    banked = sum(1 for m in members if m > 1)
    assert stats["completed"] == len(reqs), stats
    assert all(launches[k] > 0 for k in expect), launches
    tensor_core_routes_only(routes)
    scan_route_only(routes, "scan")
    if "rg_lru_scan" in expect:
        assert routes["rg_lru_scan"]["scan"] == launches["rg_lru_scan"] > 0, routes
    if cfg.tie_embeddings:
        assert launches["bank_matmul"] == 0, launches
        assert stats["suffix_dispatches"] == stats["suffix_runs"] == sum(members), stats
    else:
        assert stats["suffix_dispatches"] == banked, (stats, banked)
    err = served_vs_direct(torch, adapter, cfg, store, eng, reqs, "bfloat16")
    emit(f"{prefix}_serve", stats=stats, launches=launches, route_launches=routes,
         banked_microbatches=banked,
         member_suffixes=sum(members), serve_wall_s_with_warmup=serve_s,
         wall_s_per_microbatch=stats["elapsed_s"] / max(stats["microbatches"], 1),
         peak_memory_bytes=peak, max_abs_err_vs_forward=err, tol=TOL["bfloat16"],
         seconds=time.perf_counter() - t_phase)
    t_phase = start_phase(torch, f"{prefix}_profile")
    profile_microbatch(torch, eng, cfg, gen, stats["elapsed_s"] / stats["microbatches"],
                       f"{prefix}_profile")
    emit("phase_end", name=f"{prefix}_profile", seconds=time.perf_counter() - t_phase)
    return launches, routes, eng


def device_time_of(rows: list, prefix: str) -> dict:
    """ms and launches of the profiled kernels whose names hold ``prefix``
    (``rows``: (name, ms, count) of device events)."""
    hit = [(ms, k) for n, ms, k in rows if prefix in n]
    return dict(ms=sum(ms for ms, _ in hit), launches=sum(k for _, k in hit))


def profile_microbatch(torch, eng, cfg, gen, served_wall_s: float, name: str) -> None:
    """One more banked micro-batch (8 interleaved requests) under
    ``torch.profiler``: device time by kernel, and the device's idle share
    of the wall time, both under the profiler and against the unprofiled
    wall time per micro-batch of the serve above."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.executor import Request

    for j in range(8):
        eng.submit(Request(LM_MIDS[j % len(LM_MIDS)], torch.randint(
            0, cfg.vocab_size, (1, 128), generator=gen, device="cuda"), 0.0, 10.0 + j * 1e-3))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = eng.serve(horizon_s=600.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side (kernel) events only: CPU ops also carry the device time
    # of the kernels they launch, which would count it twice
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in rows)
    top = sorted(rows, key=lambda r: -r[1])[:8]
    emit(name, microbatches=stats["microbatches"], wall_ms_profiled=wall_ms,
         rg_lru_scan_device=device_time_of(rows, "rg_lru_"),
         device_busy_ms=busy_ms, device_idle_share_profiled=max(0.0, 1 - busy_ms / wall_ms),
         served_wall_ms_per_microbatch=served_wall_s * 1e3,
         device_idle_share=max(0.0, 1 - busy_ms / (served_wall_s * 1e3)),
         top_kernels=[dict(name=n[:90], ms=ms, share=ms / busy_ms, calls=k)
                      for n, ms, k in top])


# ---------------------------------------------------------------------------
# phase 7: stablelm-1.6b streaming decode
# ---------------------------------------------------------------------------


def decode_requests(cfg, n_per_member: int, seed: int, max_new: int) -> list:
    """``n_per_member`` requests per member, interleaved, with seeded
    prompts of PROMPT_LEN tokens."""
    import numpy as np

    from repro_torch.serving.decode import DecodeRequest

    rng = np.random.default_rng(seed)
    return [DecodeRequest(m, rng.integers(0, cfg.vocab_size, PROMPT_LEN).astype(np.int32),
                          max_new_tokens=max_new)
            for _ in range(n_per_member) for m in LM_MIDS]


def replay_check(torch, dec, tol: dict) -> dict:
    """One completed request per member, replayed teacher-forced through
    the unpaged decode (batch 1).  The streamed rows ran at the bucket's
    batch, where cuBLAS may sum in another order than at batch 1, so the
    two agree to bf16 rounding, not bitwise.  Each logits row is held to
    ``tol`` after dividing both by the replay row's largest magnitude (the
    heads' N(0, 1) perturbation puts the logits in the hundreds, so an
    unscaled absolute 2e-2 would hold them to finer than bf16's step at the
    row's scale).  Argmax mismatches are counted; one where the replay's
    top-2 margin exceeds ``atol + rtol * |top logit|`` is a real
    disagreement and fails the check.  As a control, the same requests are
    replayed unpaged in every row of a batch of ``max_slots``: that row
    differs from the batch-1 replay by the batch size alone."""
    from repro_torch.serving.decode import replay_unpaged

    firsts = {}
    for c in dec.completions:
        firsts.setdefault(c.request.instance_id, c)
    worst = worst_scaled = ctl_scaled = 0.0
    positions, mismatch_margins, confident, ctl_mismatches = 0, [], 0, 0
    for c in firsts.values():
        control = replay_unpaged(dec, c, batch=dec.max_slots)
        for i, row in enumerate(replay_unpaged(dec, c)):
            want, got = torch.from_numpy(row), torch.from_numpy(c.logits[i])
            scale = want.abs().max().item()
            diff = (got - want).abs().max().item()
            worst, worst_scaled = max(worst, diff), max(worst_scaled, diff / scale)
            torch.testing.assert_close(got / scale, want / scale, **tol)
            ctl = torch.from_numpy(control[i])
            ctl_scaled = max(ctl_scaled, (ctl - want).abs().max().item() / scale)
            ctl_mismatches += int(ctl.argmax()) != int(want.argmax())
            top1, top2 = torch.topk(want, 2).values.tolist()
            positions += 1
            if c.tokens[i] != int(want.argmax()):
                mismatch_margins.append(top1 - top2)
                confident += top1 - top2 > tol["atol"] + tol["rtol"] * abs(top1)
    assert confident == 0, (mismatch_margins, confident)
    return dict(requests=len(firsts), positions=positions, max_abs_err=worst,
                max_abs_err_over_row_max=worst_scaled, tol=tol,
                argmax_mismatches=len(mismatch_margins),
                mismatch_margins=mismatch_margins, confident_argmax_mismatches=confident,
                batch_control=dict(batch=dec.max_slots, max_abs_err_over_row_max=ctl_scaled,
                                   argmax_mismatches=ctl_mismatches))


def decode_phase(torch, prefix: str, eng, cfg, expect: tuple, knobs: dict) -> tuple:
    """Streaming decode of a merged group with the decoder ``knobs`` (lines
    ``<prefix>_decode`` and ``<prefix>_decode_profile``); ``expect`` are the
    kernels that must launch; every bank launch must take the tensor-core
    route.  An untied group steps with one trunk and one bank dispatch; a
    tied one with one trunk dispatch and one head per member served (every
    wave of 8 slots over the interleaved requests holds all three members).
    A KV pool is read through two gathers per decode attention; a griffin
    trunk pass launches rg_lru_scan once per recurrent layer, each at S = 1
    (a trunk pass is one token per row).  Returns the kernel launches of
    the streaming run, their routes and the decoder's stats."""
    from repro_torch.kernels import ops

    t_phase = start_phase(torch, f"{prefix}_decode")
    reqs = decode_requests(cfg, REQS_PER_MEMBER, 200, NEW_TOKENS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    stats = eng.serve_decode(reqs, horizon_s=900.0, record_logits=True, **knobs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, routes = ops.kernel_launches(), ops.route_launches()
    peak = torch.cuda.max_memory_allocated()
    dec = eng.last_decoder
    pool = next(iter(dec._pools.values()))
    assert stats["completed"] == len(reqs), stats
    assert stats["lost_in_flight"] == 0 and stats["unadmitted"] == 0, stats
    assert stats["pool_identity_ok"], stats
    assert stats["trunk_dispatches"] == stats["group_steps"] > 0, stats
    assert stats["singleton_dispatches"] == 0, stats
    if cfg.tie_embeddings:
        assert stats["bank_dispatches"] == 0, stats
        assert stats["head_dispatches"] == len(LM_MIDS) * stats["group_steps"], stats
    else:
        assert stats["bank_dispatches"] == stats["group_steps"], stats
        assert stats["head_dispatches"] == 0, stats
    assert all(launches[name] > 0 for name in expect), launches
    tensor_core_routes_only(routes)
    scan_route_only(routes, "step")
    if "rg_lru_scan" in expect:
        assert routes["rg_lru_scan"]["step"] == launches["rg_lru_scan"] > 0, routes
    passes = dict(dec.trunk_passes)
    checks = {}
    if "page_gather" in expect:
        assert launches["page_gather"] == 2 * launches["decode_attention"], launches
    if "rg_lru_scan" in expect:
        n_rec = cfg.pattern.count("rec") * cfg.n_repeats
        assert launches["rg_lru_scan"] == n_rec * (passes["warmup"] + passes["run"]), \
            (launches, passes)
        checks["rg_lru_scan"] = dict(recurrent_layers=n_rec, launches_in_run=n_rec * passes["run"],
                                     launches_in_warmup=n_rec * passes["warmup"],
                                     all_at_s1=True)
    replay = replay_check(torch, dec, TOL["bfloat16"])
    leaves = [t for kv in (pool.k, pool.v)
              for t in (kv.values() if isinstance(kv, dict) else (kv,))]
    emit(f"{prefix}_decode", requests=len(reqs), prompt_tokens=PROMPT_LEN,
         new_tokens=NEW_TOKENS, knobs=dict(knobs), stats=stats,
         launches=launches, route_launches=routes, trunk_passes=passes,
         launch_checks=checks, tokens_per_s=stats["tokens_per_s"],
         wall_s_per_step=stats["elapsed_s"] / stats["steps"],
         serve_decode_wall_s_with_warmup=wall_s, pool_bytes=nbytes(*leaves),
         pool_high_water_pages=stats["pool_high_water_pages"], peak_memory_bytes=peak,
         replay=replay, seconds=time.perf_counter() - t_phase)
    del dec, pool, leaves
    t_phase = start_phase(torch, f"{prefix}_decode_profile")
    profile_decode_steps(torch, eng, cfg, knobs, f"{prefix}_decode_profile")
    emit("phase_end", name=f"{prefix}_decode_profile", seconds=time.perf_counter() - t_phase)
    return launches, routes, stats


def profile_decode_steps(torch, eng, cfg, knobs: dict, name: str, timed: int = 5) -> None:
    """With all 8 slots past their prompts (every slot emits a token each
    step): ``timed`` pure decode steps on the host clock, then one more
    under ``torch.profiler`` (device time by kernel, device idle share)."""
    from torch.profiler import ProfilerActivity, profile

    first = PROMPT_LEN // (knobs["page_size"] + 1) + 2  # first step past every prompt
    marks, prof = {}, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def on_step(dec, step):
        if step in (first, first + timed, first + timed + 1):
            torch.cuda.synchronize()
            marks[step] = (time.perf_counter(), len(dec.slots),
                           sum(len(s.out_tokens) > 0 for s in dec.slots.values()))
        if step == first + timed:
            prof.start()
            marks["profiled_from"] = time.perf_counter()  # after the profiler's start-up
        elif step == first + timed + 1:
            prof.stop()

    reqs = decode_requests(cfg, 3, 300, first + timed + 4)[:knobs["max_slots"]]
    dec_stats = eng.serve_decode(reqs, horizon_s=900.0, on_step=on_step, **knobs)
    (t_a, live_a, emit_a), (t_b, _, _), (t_c, live_c, emit_c) = (
        marks[first], marks[first + timed], marks[first + timed + 1])
    assert live_a == emit_a == live_c == emit_c == knobs["max_slots"], marks
    step_ms = (t_b - t_a) / timed * 1e3
    wall_ms = (t_c - marks["profiled_from"]) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in device]
    busy_ms = sum(ms for _, ms, _ in rows)
    top = sorted(rows, key=lambda r: -r[1])[:10]
    emit(name, slots=knobs["max_slots"], timed_steps=timed,
         rg_lru_scan_device=device_time_of(rows, "rg_lru_"),
         wall_ms_per_decode_step=step_ms,
         tokens_per_s_decode_steps=knobs["max_slots"] / step_ms * 1e3,
         wall_ms_profiled=wall_ms, device_busy_ms=busy_ms,
         device_kernels_per_step=sum(e.count for e in device),
         device_idle_share_profiled=max(0.0, 1 - busy_ms / wall_ms),
         device_idle_share=max(0.0, 1 - busy_ms / step_ms), completed=dec_stats["completed"],
         top_kernels=[dict(name=n[:90], ms=ms, share=ms / busy_ms, calls=k)
                      for n, ms, k in top])


# ---------------------------------------------------------------------------
# phase 5 and phase 6's stablelm lanes: GEMEL against time/space sharing —
# the paper's simulator on the host, and the time-shared EdgeExecutor beside
# the merge-aware engine at one swap capacity on a full-width stablelm zoo
# ---------------------------------------------------------------------------


SIM_SETTINGS = ("min", "50%", "75%", "max")


def simulated(name: str, setting: str, workloads: dict) -> dict:
    """``examples/merge_and_serve.py``'s ``simulated()`` for one workload at
    one memory setting: time/space sharing (``none``) and every identical
    layer merged (``optimal``), each with the profiler's batch sizes, 20 s
    of frames at 30 fps, a 100 ms SLA.  These are the paper's Table 1/2
    cost model, not times of this card."""
    from repro_torch.serving.profiler import profile_workload
    from repro_torch.serving.scheduler import Scheduler
    from repro_torch.serving.simulator import simulate
    from repro_torch.serving.workload import build_instances, memory_settings, workload_costs

    cap = memory_settings(name, workloads)[setting]
    costs = workload_costs(name, workloads)
    out = {}
    for merged in ("none", "optimal"):
        insts = build_instances(name, merged=merged, workloads=workloads)
        sched = Scheduler(insts, cap, costs, merged=(merged != "none"))
        order = [i.instance_id for i in sched.order]
        cost_by_inst = {i.instance_id: costs[i.model_id] for i in sched.order}
        swap = sched.cycle_swap_bytes({i: 1 for i in order})
        prof = profile_workload(order, cost_by_inst, swap, sla_ms=100.0)
        res = simulate(Scheduler(insts, cap, costs, merged=(merged != "none")),
                       prof.batch_sizes, horizon_ms=20_000)
        out[merged] = dict(instances=len(insts), overall_accuracy=res.overall_accuracy,
                           processed_fraction=res.processed_fraction,
                           swap_ms_total=res.swap_ms_total, cycles=res.cycles,
                           batch_sizes=sorted(set(prof.batch_sizes.values())))
    return out


def paper_sim_phase() -> None:
    """The paper's comparison at workload scale (``paper_sim``): every one of
    the 15 Appendix-A workloads at memory setting ``min``, time/space
    sharing against merging, and MP2 (the example's default) at all four
    settings.  Gate, per workload: merging swaps no more and is no less
    accurate (tests/test_serving.py's property).  Runs on the host only:
    it shows the simulator needs nothing but the port."""
    from repro_torch.configs.vision_workloads import all_workloads

    t0 = time.perf_counter()
    workloads = all_workloads()
    rows = []
    for name in workloads:
        r = simulated(name, "min", workloads)
        none, opt = r["none"], r["optimal"]
        assert opt["swap_ms_total"] <= none["swap_ms_total"], (name, r)
        assert opt["overall_accuracy"] >= none["overall_accuracy"] - 1e-9, (name, r)
        rows.append(dict(workload=name, none=none, optimal=opt,
                         accuracy_gain=opt["overall_accuracy"] - none["overall_accuracy"],
                         relative_gain=opt["overall_accuracy"] / none["overall_accuracy"] - 1))
    mp2 = {s: simulated("MP2", s, workloads) for s in SIM_SETTINGS}
    emit("paper_sim", cost_model="the paper's Tables 1-2 (edge GPU), not this card",
         setting="min", horizon_ms=20_000, fps=30, sla_ms=100.0, workloads=rows,
         mp2_by_setting=mp2, seconds=time.perf_counter() - t0)


def timeshare_capacity(adapter, cfg, store) -> tuple:
    """``benchmarks/serve_throughput.py``'s swap regime at full width: the
    merged group's resident bytes (the unmerged store's less the trunk
    groups' savings, known before the merge), plus the activation of the
    largest bucket and 0.05e9 of headroom.  The merged group fits; two
    unmerged members never do.  Returns (merged bytes, capacity)."""
    from repro_torch.serving.costs import costs_for

    merged = store.resident_bytes() - sum(g.savings for g in
                                          trunk_groups(adapter, cfg, store, LM_MIDS))
    act = int(costs_for("tiny-yolo").activation_gb(max(BUCKETS)) * 1e9)
    return merged, merged + act + int(0.05e9)


def edge_executor(adapter, cfg, store, capacity):
    """The time-shared baseline with the JAX package's defaults: the modelled
    DMA sleeps each swap's bytes at 16 GB/s."""
    from repro_torch.serving.costs import costs_for
    from repro_torch.serving.executor import EdgeExecutor
    from repro_torch.serving.workload import instances_from_store

    return EdgeExecutor(store, instances_from_store(store, "tiny-yolo", model_ids=list(LM_MIDS)),
                        {m: adapter.bound_forward(cfg) for m in LM_MIDS},
                        capacity_bytes=capacity, costs={"tiny-yolo": costs_for("tiny-yolo")})


def lane_numbers(stats: dict, completions: list, scheduler, wall_s: float) -> dict:
    """What both serve lanes report: the executor's stats, requests a second
    over the served span, the scheduler's loads, loaded bytes and
    evictions, and the wall time with the warm-up."""
    last = max((c.finished_s for c in completions), default=0.0)
    return dict(stats=stats, requests_per_s=len(completions) / max(last, 1e-9),
                served_span_s=last, scheduler=dict(scheduler.stats),
                wall_s_with_warmup=wall_s)


def timeshare_serve(torch, adapter, cfg, store, capacity) -> tuple:
    """The time-shared lane (``stablelm_timeshare``): ``EdgeExecutor`` over
    the unmerged store, batch 1, the 24 requests of ``lm_merge_and_serve``'s
    serve, drained after a warm-up.  Gates: every request accounted for,
    each row within bf16 tolerance of its member's direct forward on the
    same batch of one, flash_attention launched and the bank not."""
    from repro_torch.kernels import ops
    from repro_torch.serving.costs import PCIE_GBPS

    t_phase = start_phase(torch, "stablelm_timeshare")
    ex = edge_executor(adapter, cfg, store, capacity)
    _, reqs = lm_requests(torch, cfg, LM_MIDS)
    for r in reqs:
        ex.submit(r)
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    stats = ex.serve(horizon_s=600.0, warmup=reqs[0].payload, drain=True)
    wall_s = time.perf_counter() - t0
    launches, routes = ops.kernel_launches(), ops.route_launches()
    assert stats["completed"] + stats["skipped"] == len(reqs), stats
    assert launches["flash_attention"] > 0 and launches["bank_matmul"] == 0, launches
    tensor_core_routes_only(routes)
    worst = 0.0
    for c in ex.completions:  # each ran as a batch of one
        got = c.result.float()
        want = adapter.forward(cfg, store.materialize(c.request.instance_id),
                               c.request.payload)[0].float()
        torch.testing.assert_close(got, want, **TOL["bfloat16"])
        worst = max(worst, (got - want).abs().max().item())
    lane = lane_numbers(stats, ex.completions, ex.scheduler, wall_s)
    emit("stablelm_timeshare", lane="EdgeExecutor on the unmerged store", requests=len(reqs),
         batch=1, capacity_bytes=capacity, member_bytes=store.model_bytes(LM_MIDS[0]),
         dma_gbps=PCIE_GBPS, simulated_dma_s=lane["scheduler"]["loaded_bytes"] / 1e9
         / PCIE_GBPS, **lane, launches=launches, route_launches=routes,
         max_abs_err_vs_forward=worst, tol=TOL["bfloat16"],
         seconds=time.perf_counter() - t_phase)
    return lane, launches, routes


def timeshare_decode(torch, adapter, cfg, store, capacity) -> tuple:
    """The per-request decode lane (``stablelm_timeshare_decode``):
    ``EdgeExecutor.serve_decode`` on the unmerged store over the first two
    requests per member of the streaming decode's, one at a time on a
    contiguous cache of ``max_len`` 128.  Gates: every request completes
    with one step per generated token; decode_attention launches, the
    gather and the bank do not; each first token is the argmax of its
    member's direct forward at the prompt's last position, unless that
    row's top-2 margin lies within the bf16 tolerance."""
    from repro_torch.kernels import ops
    from repro_torch.serving.executor import ModelProgram

    t_phase = start_phase(torch, "stablelm_timeshare_decode")
    ex = edge_executor(adapter, cfg, store, capacity)
    reqs = decode_requests(cfg, REQS_PER_MEMBER, 200, NEW_TOKENS)[:2 * len(LM_MIDS)]
    programs = [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in LM_MIDS]
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    stats = ex.serve_decode(reqs, programs, max_len=DECODE_KW["max_len"], horizon_s=900.0)
    wall_s = time.perf_counter() - t0
    launches, routes = ops.kernel_launches(), ops.route_launches()
    assert stats["completed"] == len(reqs), stats
    assert stats["steps"] == stats["tokens_decoded"] == len(reqs) * NEW_TOKENS, stats
    assert launches["decode_attention"] > 0, launches
    assert launches["page_gather"] == 0 and launches["bank_matmul"] == 0, launches
    tol = TOL["bfloat16"]
    first_token_mismatch_margins = []
    for c in ex.decode_completions:
        prompt = torch.as_tensor(c.request.prompt.astype("int64"), device="cuda")[None]
        row = adapter.forward(cfg, store.materialize(c.request.instance_id), prompt)[0, -1]
        top1, top2 = torch.topk(row.float(), 2).values.tolist()
        if c.tokens[0] != int(row.argmax()):
            assert top1 - top2 <= tol["atol"] + tol["rtol"] * abs(top1), (c.tokens[0], top1, top2)
            first_token_mismatch_margins.append(top1 - top2)
    emit("stablelm_timeshare_decode", lane="EdgeExecutor.serve_decode on the unmerged store",
         requests=len(reqs), prompt_tokens=PROMPT_LEN, new_tokens=NEW_TOKENS,
         max_len=DECODE_KW["max_len"], stats=stats, tokens_per_s=stats["tokens_per_s"],
         scheduler=dict(ex.scheduler.stats), wall_s_with_warmup=wall_s, launches=launches,
         route_launches=routes, first_token_mismatch_margins=first_token_mismatch_margins,
         seconds=time.perf_counter() - t_phase)
    return stats, launches, routes


def timeshare_engine(torch, adapter, cfg, store, capacity, timeshare_lane: dict) -> tuple:
    """The engine lane (``stablelm_timeshare_engine``): a second
    ``MergeAwareEngine`` on the merged store at the time-shared lane's
    capacity, with the modelled DMA on, serving fresh copies of the same 24
    requests.  Gates: every request accounted for, rows against direct
    forwards, the bank on its tensor-core route, and strictly fewer loaded
    bytes than the time-shared lane."""
    from repro_torch.kernels import ops

    t_phase = start_phase(torch, "stablelm_timeshare_engine")
    eng = make_engine(adapter, cfg, store, LM_MIDS, capacity, simulate_dma=True)
    _, reqs = lm_requests(torch, cfg, LM_MIDS)
    for r in reqs:
        eng.submit(r)
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    stats = eng.serve(horizon_s=600.0, warmup=reqs[0].payload)
    wall_s = time.perf_counter() - t0
    launches, routes = ops.kernel_launches(), ops.route_launches()
    assert stats["completed"] + stats["skipped"] == len(reqs), stats
    assert launches["bank_matmul"] > 0 and launches["flash_attention"] > 0, launches
    tensor_core_routes_only(routes)
    err = served_vs_direct(torch, adapter, cfg, store, eng, reqs, "bfloat16")
    lane = lane_numbers(stats, eng.completions, eng.scheduler, wall_s)
    ts_bytes = timeshare_lane["scheduler"]["loaded_bytes"]
    assert lane["scheduler"]["loaded_bytes"] < ts_bytes, (lane["scheduler"], ts_bytes)
    emit("stablelm_timeshare_engine", lane="MergeAwareEngine on the merged store",
         requests=len(reqs), capacity_bytes=capacity, resident_bytes=store.resident_bytes(),
         simulated_dma_stall_s=stats["dma_stall_s"], **lane, launches=launches,
         route_launches=routes, max_abs_err_vs_forward=err, tol=TOL["bfloat16"],
         loaded_bytes_over_timeshare=lane["scheduler"]["loaded_bytes"] / ts_bytes,
         requests_per_s_over_timeshare=lane["requests_per_s"]
         / timeshare_lane["requests_per_s"],
         sla_fraction_timeshare=timeshare_lane["stats"]["sla_fraction"],
         sla_fraction_engine=stats["sla_fraction"], seconds=time.perf_counter() - t_phase)
    return launches, routes


# ---------------------------------------------------------------------------
# phase 8: GEMEL's planning step on a full-width stablelm-1.6b zoo
# ---------------------------------------------------------------------------


def plan_zoo(torch, adapter, cfg) -> dict:
    """``lm_zoo``'s three variants plus lm-C, a foreign member initialised
    from its own seed (the zoo of benchmarks/lm_merging.py)."""
    zoo = lm_zoo(torch, adapter, cfg)
    zoo["lm-C"] = adapter.init(cfg, seed=42, device="cuda")
    return {m: zoo[m] for m in PLAN_MIDS}


def digest(torch, t) -> str:
    """blake2b of a tensor's bytes as stored (bf16 through its int16 view)."""
    import hashlib

    host = t.detach().cpu().contiguous()
    if host.dtype == torch.bfloat16:
        host = host.view(torch.int16)
    return hashlib.blake2b(host.numpy().tobytes(), digest_size=16).hexdigest()


def plain_cka_prefilter(groups: list, acts: dict, theta: float) -> tuple:
    """The CKA prefilter's plain version, written apart from
    ``RepresentationSimilarityScorer``: linear CKA through double-centred
    Grams H·XXᵀ·H (the scorer centres the features instead), each column
    cut to its largest coherent cluster (grown greedily from its most
    similar pair while the least similarity to the cluster stays >=
    ``theta``), a model that loses an appearance leaving the group's later
    columns.  Returns (kept groups as sets of (model_id, path), the
    appearances left sharing a column, groups pruned, members pruned)."""
    import numpy as np

    grams: dict = {}

    def gram(r):
        ck = (r.model_id, r.path.rsplit("/", 1)[0])
        if ck not in grams:
            a = acts[ck[0]][ck[1]]
            x = np.asarray(a, np.float64).reshape(a.shape[0], -1)
            h = np.eye(x.shape[0]) - 1.0 / x.shape[0]
            grams[ck] = h @ (x @ x.T) @ h
        return grams[ck]

    def cka(a, b):
        ka, kb = gram(a), gram(b)
        return float(np.sum(ka * kb) / np.sqrt(np.sum(ka * ka) * np.sum(kb * kb)))

    def cluster(col):
        n = len(col)
        sims = {(i, j): cka(col[i], col[j]) for i in range(n) for j in range(n) if i < j}
        sims.update({(j, i): v for (i, j), v in list(sims.items())})
        pair = max((p for p in sims if p[0] < p[1]), key=lambda p: sims[p])
        if sims[pair] < theta:
            return []
        members = set(pair)
        while len(members) < n:
            gain = {c: min(sims[c, m] for m in members) for c in range(n) if c not in members}
            c = max(sorted(gain), key=gain.get)
            if gain[c] < theta:
                break
            members.add(c)
        return [col[i] for i in sorted(members)]

    kept, shared, pruned_groups, pruned_members = [], set(), 0, 0
    for g in groups:
        keep, pairs, broken = [], set(), set()
        for col in g.columns():
            col = [r for r in col if r.model_id not in broken]
            if len(col) < 2:
                keep += col
                continue
            kcol = cluster(col)
            left = {r.model_id for r in col} - {r.model_id for r in kcol}
            broken |= left if len(kcol) >= 2 else {r.model_id for r in col}
            if len(kcol) >= 2:
                keep += kcol
                pairs |= {(r.model_id, r.path) for r in kcol}
        if pairs:
            kept.append(frozenset((r.model_id, r.path) for r in keep))
            shared |= pairs
            pruned_members += len(g.records) - len(keep)
        else:
            pruned_groups += 1
            pruned_members += len(g.records)
    return kept, shared, pruned_groups, pruned_members


def tap_cka(acts: dict, trunk, mids) -> tuple:
    """Each member pair's lowest linear CKA over the trunk taps, and the
    threshold midway between the foreign lm-C's most similar pair and the
    variants' least similar one (it separates lm-C from the variants at
    some tap, so a prefilter at it must prune)."""
    from repro_torch.core.policy import default_layer_key, linear_cka

    taps = sorted({default_layer_key(p) for p in trunk})
    min_cka = {f"{a}~{b}": min(linear_cka(acts[a][k], acts[b][k]) for k in taps)
               for a, b in itertools.combinations(mids, 2)}
    foreign = max(v for k, v in min_cka.items() if "lm-C" in k)
    variants = min(v for k, v in min_cka.items() if "lm-C" not in k)
    return min_cka, (foreign + variants) / 2


def stablelm_plan_phase(torch, cfg, capacity_bytes: int) -> tuple:
    """The JAX package's ``merge_and_serve`` (benchmarks/lm_merging.py) at
    full width and ``cfg``'s depth (``PLAN_LAYERS`` from ``main``): on the
    cloud side, the CKA-prefiltered ``StagedPlanner``
    with the coherence surrogate over the trunk records of four members
    (lm-A/B/D and the foreign lm-C), calibrated on one batch of 32
    sequences of 8 tokens; ``MergePlan.to_json()`` with the shared weights.
    The cloud store is freed (its shared buffers' digests kept) before the
    edge side builds a fresh unmerged store, queues 8 requests of 128
    tokens per member on a live ``MergeAwareEngine``, hot-swaps the plan in
    with ``apply_plan(MergePlan.from_json(payload))`` and serves.  Returns
    (kernel launches of the phase, their routes)."""
    from repro_torch.core import MergePlan, ParamStore, RepresentationSimilarityScorer
    from repro_torch.core import StagedPlanner, enumerate_groups
    from repro_torch.core.policy import CoherenceSurrogateTrainer, calibration_activations
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_adapter
    from repro_torch.utils.tree import flatten_paths, leaf_bytes

    adapter = get_adapter("dense")
    t_phase = start_phase(torch, "stablelm_plan")
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    zoo = plan_zoo(torch, adapter, cfg)
    cloud = ParamStore.from_models(zoo)
    unmerged = cloud.resident_bytes()
    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m in PLAN_MIDS for r in adapter.records(cfg, zoo[m], m) if r.path in trunk]
    torch.cuda.synchronize()
    zoo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = adapter.calibration_batch(cfg, torch.Generator(device="cuda").manual_seed(7), 32)
    acts = calibration_activations({m: (adapter, cfg, zoo[m]) for m in PLAN_MIDS}, batch)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    del zoo
    # the surrogate reads no loss or data: accuracy_target 0.0, as the
    # reference's plan_variants registers them
    regs = [adapter.registered(cfg, m, 10 + i, accuracy_target=0.0, device="cuda")
            for i, m in enumerate(PLAN_MIDS)]
    scorer = RepresentationSimilarityScorer(acts, PLAN_MIN_SIMILARITY)
    trainer = CoherenceSurrogateTrainer(acts, PLAN_MIN_SIMILARITY)
    t0 = time.perf_counter()
    res = StagedPlanner(cloud, regs, recs, trainer, scorer=scorer).run()
    plan_s = time.perf_counter() - t0  # the weights' encoding included
    t0 = time.perf_counter()
    payload = res.plan.to_json()
    dump_s = time.perf_counter() - t0
    cross = [pg for pg in res.plan.groups if any(len(c.members) >= 2 for c in pg.columns)]
    min_cka, separating = tap_cka(acts, trunk, PLAN_MIDS)
    # the prefilter against its plain version: at the planner's threshold,
    # and at one that must prune (midway between lm-C's and the variants'
    # lowest tap CKA, above some tap's lowest pair), where every kept group
    # and count must agree; at the planner's threshold the plan shares
    # exactly what the plain prefilter keeps
    cands = enumerate_groups(recs)
    prefilter_check = {}
    for theta in (PLAN_MIN_SIMILARITY, separating):
        want = plain_cka_prefilter(cands, acts, theta)
        probe = RepresentationSimilarityScorer(acts, theta)
        got_kept, got_pruned = probe.prefilter(cands)
        got = ([frozenset((r.model_id, r.path) for r in g.records) for g in got_kept],
               len(got_pruned), probe.pruned_members)
        assert got == (want[0], *want[2:]), (theta, got[1:], want[2:])
        prefilter_check[f"{theta:.6f}"] = dict(kept_groups=len(want[0]), pruned_groups=want[2],
                                               pruned_members=want[3])
    assert want[3] >= 1, prefilter_check  # the second threshold did prune
    base = plain_cka_prefilter(cands, acts, PLAN_MIN_SIMILARITY)
    assert (res.pruned, scorer.pruned_members) == base[2:], (res.pruned, base[2:])
    plan_members = {(r.model_id, r.path) for pg in res.plan.groups for c in pg.columns
                    for r in c.members}
    assert plan_members == base[1], "the plan shares other appearances than the plain keep"
    shared_keys = sorted(cloud.shared_keys())
    digests = {k: digest(torch, cloud.buffers[k]) for k in shared_keys}
    planned = dict(plan_bytes=len(payload), committed_groups=res.committed,
                   cross_variant_groups=len(cross), retrain_attempts=res.attempted,
                   surrogate_calls=trainer.calls, pruned_prefilter=res.pruned,
                   pruned_members=scorer.pruned_members, cloud_merged_bytes=res.final_bytes,
                   shared_keys=len(shared_keys), min_tap_cka=min_cka,
                   prefilter_vs_plain=prefilter_check, zoo_s=zoo_s,
                   calibration_s=calib_s, planner_s=plan_s, to_json_s=dump_s)
    del res, cloud, acts, scorer, trainer, recs, cands, probe
    emit("stablelm_plan_cloud", **planned)
    assert planned["cross_variant_groups"] >= 1, planned

    gc.collect()
    torch.cuda.empty_cache()
    edge = ParamStore.from_models(plan_zoo(torch, adapter, cfg))
    assert edge.resident_bytes() == unmerged
    # what merge_trunk finds for lm-A/B/D (one trunk, three heads), plus
    # lm-C unmerged: the planner must find at least as much
    trunk_bytes = sum(leaf_bytes(v) for p, v in flatten_paths(adapter.eval_params(cfg)).items()
                      if p in trunk)
    hand_bound = (trunk_bytes + sum(edge.model_bytes(m) - trunk_bytes for m in LM_MIDS)
                  + edge.model_bytes("lm-C"))
    eng = make_engine(adapter, cfg, edge, PLAN_MIDS, capacity_bytes)
    _, reqs = lm_requests(torch, cfg, PLAN_MIDS)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    plan = MergePlan.from_json(payload)
    load_s = time.perf_counter() - t0
    del payload
    epoch0 = edge.epoch
    t0 = time.perf_counter()
    swap = eng.apply_plan(plan)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    del plan
    merged = edge.resident_bytes()
    assert swap["epoch_bumps"] == 1 and edge.epoch == epoch0 + 1, swap
    assert swap["pending_requests"] == len(reqs), swap
    assert sorted(edge.shared_keys()) == shared_keys
    differ = [k for k, d in digests.items() if digest(torch, edge.buffers[k]) != d]
    assert not differ, f"shared buffers differ from the cloud's: {differ}"
    assert merged <= hand_bound, (merged, hand_bound)
    groups = eng.prefix_groups()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = eng.serve(horizon_s=600.0, warmup=reqs[0].payload)
    serve_s = time.perf_counter() - t0
    launches, routes = ops.kernel_launches(), ops.route_launches()
    shared_mbs = stats["microbatches"] - stats["forward_runs"]
    assert stats["completed"] == len(reqs), stats
    assert stats["suffix_dispatches"] == shared_mbs > 0, stats
    assert launches["flash_attention"] > 0 and launches["bank_matmul"] > 0, launches
    tensor_core_routes_only(routes)
    err = max(served_vs_direct(torch, adapter, cfg, edge, eng,
                               [r for r in reqs if r.instance_id in g], "bfloat16")
              for g in groups)
    emit("stablelm_plan", **planned, n_layers=cfg.n_layers, resident_bytes_unmerged=unmerged,
         resident_bytes_merged=merged, hand_merge_bound_bytes=hand_bound,
         saved_fraction=1 - merged / unmerged, prefix_groups=groups,
         swap={k: v for k, v in swap.items() if k != "shared_keys"},
         from_json_s=load_s, apply_plan_s=apply_s, shared_buffers_bitwise=len(digests),
         stats=stats, shared_microbatches=shared_mbs, launches=launches, route_launches=routes,
         serve_wall_s_with_warmup=serve_s, peak_memory_bytes=torch.cuda.max_memory_allocated(),
         max_abs_err_vs_forward=err, tol=TOL["bfloat16"], seconds=time.perf_counter() - t_phase)
    return launches, routes


# ---------------------------------------------------------------------------
# phase 9: GEMEL's drift loop on a full-width stablelm-1.6b zoo
# ---------------------------------------------------------------------------

DRIFT_MIDS = tuple(f"lm-{c}" for c in "ABCDEFG")
DRIFT_PERIODS, DRIFT_AT = 8, 3
# trunk perturbations whose merged members' pre-drift agreement the phase
# reports (lm_zoo's 0.005 first), and the drift zoo's (see
# stablelm_drift_phase)
RECIPE_TRUNK_SCALES = (0.005, 0.0005, 0.0002, 0.0001)
DRIFT_TRUNK_SCALE = 0.0002


def lm_probe(torch, cfg, period: int):
    """The sampled inputs of one drift check: 16 prompts of 32 tokens
    (``LMStream`` with seed 1000 + period)."""
    from repro_torch.data.synthetic import LMStream

    return LMStream(cfg.vocab_size, 16, 32, seed=1000 + period, device="cuda").batch_at(0)["tokens"]


def merged_agreement(torch, adapter, cfg, trunk_scale: float) -> dict:
    """lm_zoo's variants at ``trunk_scale``, each merged onto the base's
    trunk as the planner merges them: the fraction of period 0's probe
    positions where the merged member's argmax equals its original's, by
    member.  One variant is resident at a time."""
    from repro_torch.bench.lm_merging import is_head, perturb
    from repro_torch.utils.tree import flatten_paths, unflatten_paths

    base = adapter.init(cfg, seed=0, device="cuda")
    base_flat = flatten_paths(base)
    tokens = lm_probe(torch, cfg, 0)
    out = {}
    for i, mid in enumerate(DRIFT_MIDS[1:]):
        v = perturb(base, 2 * i + 1, trunk_scale, lambda p: not is_head(p))
        original = perturb(v, 2 * i + 2, 1.0, is_head)
        del v
        merged = unflatten_paths({p: leaf if is_head(p) else base_flat[p]
                                  for p, leaf in flatten_paths(original).items()})
        want = adapter.forward(cfg, original, tokens).argmax(-1)
        out[mid] = (adapter.forward(cfg, merged, tokens).argmax(-1) == want).float().mean().item()
        del original, merged
    return out


def drift_scenario(torch, adapter, cfg, zoo: dict):
    """The JAX bench's drift scenario over a full-width zoo: lm-B (the
    second member) drifts to ``adapter.init(seed=999)``, 2 requests of 128
    seeded tokens per member per period, checks on ``lm_probe``,
    calibration as ``stablelm_plan``'s (32 sequences of 8 tokens)."""
    from repro_torch.bench.drift_adapt import DriftScenario

    def payload(period, i, j):
        gen = torch.Generator(device="cuda").manual_seed(5000 + 97 * period + 7 * i + j)
        return torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device="cuda")

    return DriftScenario(
        adapter, cfg, zoo, drifted_original=adapter.init(cfg, seed=999, device="cuda"),
        calibration=adapter.calibration_batch(
            cfg, torch.Generator(device="cuda").manual_seed(7), 32),
        payload=payload, probe=lambda period: lm_probe(torch, cfg, period))


def stablelm_drift_phase(torch, cfg) -> tuple:
    """The JAX package's drift benchmark (benchmarks/drift_adapt.py) over
    seven full-width stablelm-1.6b members at ``cfg``'s depth
    (``DRIFT_LAYERS`` from ``main``): the CKA-prefiltered plan with
    the coherence surrogate (``min_similarity`` 0.5), shipped through JSON
    and hot-swapped into a live engine; a ``ManualClock`` timeline of 8
    periods of 10 s with ``LifecycleController`` (checks: per-position
    argmax agreement with each member's current original, target 0.5), lm-B
    drifting at the start of period 3; a static timeline on the same
    decoded plan; one more trace served after the swap and replayed
    (``verify_bitwise``: the same padded micro-batches through the same
    dispatches, bitwise; banked rows against each member's own suffix,
    2e-2) and held to the direct forwards (2e-2); a cold
    re-plan for the warm-start comparison.  Gates: those of scripts/ci.sh
    for drift but the simulator's (``drift_adapt.gates``).

    At all 24 layers lm_zoo's trunk perturbation (0.005, 23% of a dense
    weight's init scale 1/sqrt(2048)) leaves a merged member's argmax on
    its original's at only 2-5% of positions (``recipe_agreement``), so
    under a 0.5 target every variant would breach at the first check,
    before any drift.  The drift zoo's trunks are perturbed by 0.0002,
    whose lowest variant agreed at 0.846 there (0.0005: 0.676; PERF.md §6)
    and agrees more at fewer layers: every trunk differs, so each merge is
    lossy, yet each merged member stays well above the target and the one
    breach is the drift's.  Each member's pre-drift agreement is
    printed (``pre_drift_agreement``).  Returns (kernel launches of the
    phase, their routes, loop info)."""
    from repro_torch.bench import drift_adapt as D
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_adapter
    from repro_torch.utils.tree import flatten_paths, leaf_bytes

    adapter = get_adapter("dense")
    t_phase = start_phase(torch, "stablelm_drift")
    t0 = time.perf_counter()
    recipe = {f"{scale:g}": merged_agreement(torch, adapter, cfg, scale)
              for scale in RECIPE_TRUNK_SCALES}
    recipe_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    scn = drift_scenario(torch, adapter, cfg, lm_zoo(torch, adapter, cfg, DRIFT_MIDS,
                                                     DRIFT_TRUNK_SCALE))
    torch.cuda.synchronize()
    zoo_s = time.perf_counter() - t0
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    rows, derived, loop, static = D.evaluate(scn, DRIFT_PERIODS, DRIFT_AT, sim=False)
    torch.cuda.synchronize()
    evaluate_s = time.perf_counter() - t0
    launches, routes = ops.kernel_launches(), ops.route_launches()
    tensor_core_routes_only(routes)
    assert launches["flash_attention"] > 0 and launches["bank_matmul"] > 0, launches
    edge, eng = loop["edge"], loop["engine"]
    extra = loop["post_swap_requests"]
    err = max(served_vs_direct(torch, adapter, cfg, edge, eng,
                               [r for r in extra if r.instance_id in g], "bfloat16",
                               buckets=D.BUCKETS)
              for g in eng.prefix_groups())
    trunk = adapter.split(cfg).prefix_paths
    trunk_bytes = sum(leaf_bytes(v) for p, v in flatten_paths(adapter.eval_params(cfg)).items()
                      if p in trunk)
    head_bytes = edge.model_bytes("lm-A") - trunk_bytes
    gates = D.gates(derived)
    ctl = loop["controller"]
    emit("stablelm_drift", config=cfg.name, members=len(DRIFT_MIDS), periods=DRIFT_PERIODS,
         drift_period=DRIFT_AT, recipe_agreement=recipe, recipe_s=recipe_s,
         drift_trunk_scale=DRIFT_TRUNK_SCALE,
         pre_drift_agreement={m: [r["agreement"][m] for r in loop["rows"][:DRIFT_AT]]
                              for m in DRIFT_MIDS},
         rows=[{k: r[k] for k in ("period", "t_s", "state", "resident_bytes", "agreement")}
               for r in loop["rows"]],
         static_rows=[{k: r[k] for k in ("period", "agreement")} for r in static["rows"]],
         events=[dict(time=e.time, state=e.state, **{k: v for k, v in e.detail.items()
                                                    if k != "shared_keys"})
                 for e in ctl.events],
         derived=derived, gates=gates, resident_bytes_unmerged=loop["unmerged_bytes"],
         expected_merged_bytes=trunk_bytes + len(DRIFT_MIDS) * head_bytes,
         expected_reverted_bytes=2 * trunk_bytes + len(DRIFT_MIDS) * head_bytes,
         plan0_groups=len(loop["plan0"].groups),
         replan_groups=len(ctl.deployed_plan.groups), seconds_loop=loop["seconds"],
         seconds_static=static["seconds"], launches=launches, route_launches=routes,
         max_abs_err_vs_forward=err, tol=TOL["bfloat16"], zoo_s=zoo_s, evaluate_s=evaluate_s,
         seconds=time.perf_counter() - t_phase)
    assert all(gates.values()), {k: v for k, v in gates.items() if not v}
    return launches, routes, dict(loop, scenario=scn)


def stablelm_swap_failure_phase(torch, loop: dict) -> tuple:
    """On ``stablelm_drift``'s engine after its recovery, with one period's
    requests queued: a one-shot swap failure armed after one column
    (``FaultInjector.arm_swap_failure``) and the deployed plan applied —
    ``PlanApplyError``, one epoch bump, bindings bit-identical, the queue
    kept — then a clean re-apply (one bump) and the serve.  Returns (kernel
    launches of the serve, their routes)."""
    from repro_torch.bench import drift_adapt as D
    from repro_torch.bench.overload import swap_failure
    from repro_torch.kernels import ops
    from repro_torch.serving.faults import FaultInjector

    t_phase = start_phase(torch, "stablelm_swap_failure")
    eng, edge, scn = loop["engine"], loop["edge"], loop["scenario"]
    plan = loop["controller"].deployed_plan
    reqs = D.period_requests(scn, DRIFT_PERIODS + 1, 0.0)
    for r in reqs:
        eng.submit(r)
    injector = FaultInjector()
    t0 = time.perf_counter()
    failed = swap_failure(eng, injector, plan, eng.queues)
    rollback_s = time.perf_counter() - t0
    epoch0 = edge.epoch
    t0 = time.perf_counter()
    out = eng.apply_plan(plan)
    torch.cuda.synchronize()
    reapply_s = time.perf_counter() - t0
    ops.reset_kernel_launches()
    since = len(eng.completions)
    stats = eng.serve(horizon_s=600.0)
    launches, routes = ops.kernel_launches(), ops.route_launches()
    tensor_core_routes_only(routes)
    served = eng.completions[since:]
    emit("stablelm_swap_failure", **failed, fault_events=injector.events,
         rollback_s=rollback_s, reapply_epoch_bumps=out["epoch_bumps"],
         reapply_pending_requests=out["pending_requests"], reapply_s=reapply_s,
         stats=stats, launches=launches, route_launches=routes,
         seconds=time.perf_counter() - t_phase)
    assert failed["swap_failure_raised"] and failed["swap_failure_epoch_bumps"] == 1, failed
    assert failed["swap_failure_bindings_restored"] and failed["swap_failure_pending_kept"], failed
    assert out["epoch_bumps"] == 1 and edge.epoch == epoch0 + 1, out
    assert out["pending_requests"] == len(reqs), out
    assert stats["completed"] == len(served) == len(reqs) and stats["skipped"] == 0, stats
    return launches, routes


def small_cnn_lifecycle_phases(torch) -> tuple:
    """The ported ``drift_adapt`` and ``overload`` benches at their own
    small-CNN scale on the card (inputs drawn from numpy), each with its
    scripts/ci.sh gates.  Returns (kernel launches of both, their routes)."""
    from repro_torch.bench import drift_adapt as D
    from repro_torch.bench import overload as O
    from repro_torch.kernels import ops

    launches, routes = collections.Counter(), collections.defaultdict(collections.Counter)

    def take():
        launches.update(ops.kernel_launches())
        for name, r in ops.route_launches().items():
            routes[name].update(r)

    t_phase = start_phase(torch, "drift_adapt")
    ops.reset_kernel_launches()
    _, derived, _, _ = D.evaluate(D.numpy_scenario(device="cuda"))
    take()
    gates = D.gates(derived)
    emit("drift_adapt", derived=derived, gates=gates, launches=ops.kernel_launches(),
         seconds=time.perf_counter() - t_phase)
    assert all(gates.values()), {k: v for k, v in gates.items() if not v}

    t_phase = start_phase(torch, "overload")
    ops.reset_kernel_launches()
    rows, derived = O.evaluate(O.build_stack(device="cuda"))
    take()
    gates = O.gates(derived)
    emit("overload", derived=derived, gates=gates,
         lanes={r["lane"]: {k: r[k] for k in ("offered", "completed", "gate_completed",
                                              "shed_oldest", "shed_newest", "lost",
                                              "max_depth", "effective_accuracy")}
                for r in rows},
         launches=ops.kernel_launches(), seconds=time.perf_counter() - t_phase)
    assert all(gates.values()), {k: v for k, v in gates.items() if not v}
    return dict(launches), {k: dict(v) for k, v in routes.items()}


def host_bench_phases(torch) -> tuple:
    """The ported ``serve_throughput`` (240 requests, with the nobank lane)
    and ``plan_search`` benches at their own small-CNN defaults on the card
    (inputs drawn from numpy), each with the gates scripts/ci.sh holds it
    to; serve_throughput's timed ``speedup_rps`` and ``bank_speedup_rps``
    are printed.  Returns (kernel launches of both, their routes)."""
    from repro_torch.bench import plan_search as PSB
    from repro_torch.bench import serve_throughput as STB
    from repro_torch.kernels import ops

    launches, routes = collections.Counter(), collections.defaultdict(collections.Counter)

    def take():
        launches.update(ops.kernel_launches())
        for name, r in ops.route_launches().items():
            routes[name].update(r)

    t_phase = start_phase(torch, "serve_throughput")
    ops.reset_kernel_launches()
    rows, derived = STB.evaluate(STB.numpy_inputs(device="cuda"), n_requests=240)
    take()
    gates = STB.gates(derived)
    emit("serve_throughput", rows=rows, derived=derived, gates=gates,
         timed=dict(speedup_rps=derived["speedup_rps"], reference_target=">= 2.0",
                    bank_speedup_rps=derived["bank_speedup_rps"], asserted=False),
         launches=ops.kernel_launches(), route_launches=ops.route_launches(),
         seconds=time.perf_counter() - t_phase)
    assert all(gates.values()), gates

    t_phase = start_phase(torch, "plan_search")
    ops.reset_kernel_launches()
    rows, derived, _ = PSB.evaluate(PSB.numpy_inputs(device="cuda"))
    take()
    gates = PSB.gates(derived)
    emit("plan_search", rows=rows, derived=derived, gates=gates, launches=ops.kernel_launches(),
         seconds=time.perf_counter() - t_phase)
    assert all(gates.values()), gates
    return dict(launches), {k: dict(v) for k, v in routes.items()}


# ---------------------------------------------------------------------------
# the paper's evaluation benches: host arithmetic over its descriptor zoo
# and workloads, fig7's joint retraining on the card, and fig14's plan-wire
# lane on a full-width stablelm-1.6b zoo
# ---------------------------------------------------------------------------

# the one row of fig10 over the 15 workloads where GEMEL reads below
# time/space sharing: at MP4's 75% setting the JAX package's model gives
# GEMEL 0.07771 against 0.07893, and the port the same
# (tests/test_torch_paper_benches.py); every other row holds the paper's
# ordering
FIG10_ROWS_BELOW_TIMESHARE = {("MP4", "75%")}


def paper_benches_phase() -> None:
    """Every ported host bench of the paper's evaluation (Tables 1-3, Figs
    3-5, 9-13, fig14's surrogate sweep, the ordering ablation) over all 15
    workloads (``all_workloads()``: the nine printed in Appendix A and the
    six ``construct_missing`` draws), each bench's derived numbers beside
    the paper's own string it carries.  These are the paper's cost model of
    its edge GPU, not this card's times.  Gates on every fig10 row: GEMEL
    swaps no more than time/space sharing, and is no less accurate except
    on ``FIG10_ROWS_BELOW_TIMESHARE``."""
    import contextlib
    import io

    from repro_torch.bench import (
        ablation_ordering, fig3_nexus, fig4_commonality, fig5_potential, fig9_powerlaw,
        fig10_e2e, fig11_savings, fig12_baselines, fig13_incremental, fig14_bandwidth,
        table1_memory, table2_times, table3_sweeps,
    )
    from repro_torch.configs.vision_workloads import all_workloads

    t_phase = time.perf_counter()
    workloads = all_workloads()
    runs = {
        "table1_memory": table1_memory.run, "table2_times": table2_times.run,
        "fig3_nexus": fig3_nexus.run, "fig4_commonality": fig4_commonality.run,
        "fig5_potential": fig5_potential.run, "fig9_powerlaw": fig9_powerlaw.run,
        "fig10_e2e": fig10_e2e.run, "fig11_savings": fig11_savings.run,
        "fig12_baselines": fig12_baselines.run, "fig13_incremental": fig13_incremental.run,
        "fig14_bandwidth": fig14_bandwidth.run_surrogate, "table3_sweeps": table3_sweeps.run,
        "ablation_ordering": ablation_ordering.run,
    }
    sweeps = {"fig3_nexus", "fig5_potential", "fig10_e2e", "fig11_savings", "fig12_baselines",
              "fig13_incremental", "fig14_bandwidth", "table3_sweeps", "ablation_ordering"}
    derived, seconds, outs = {}, {}, {}
    for name, run in runs.items():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # each bench's CSV table
            outs[name] = run(workloads) if name in sweeps else run()
        seconds[name] = time.perf_counter() - t0
        derived[name] = outs[name]["derived"]
    rows10 = outs["fig10_e2e"]["rows"]
    below = {(r["workload"], r["memory"]) for r in rows10 if r["gemel_acc"] < r["nexus_acc"]}
    more_swap = [(r["workload"], r["memory"]) for r in rows10
                 if r["gemel_swap_ms"] > r["nexus_swap_ms"]]
    fig11 = {r["workload"]: r["saved_pct"] for r in outs["fig11_savings"]["rows"]}
    emit("paper_benches", cost_model="the paper's Tables 1-2 (edge GPU), not this card",
         workloads=len(workloads), derived=derived, fig11_saved_pct=fig11,
         fig10_rows=len(rows10), fig10_rows_below_timeshare=sorted(below),
         fig10_rows_swapping_more=more_swap,
         table3=[{k: r[k] for k in ("workload", "variant", "win")}
                 for r in outs["table3_sweeps"]["rows"]],
         bench_seconds=seconds, seconds=time.perf_counter() - t_phase)
    assert not more_swap, more_swap
    assert below == FIG10_ROWS_BELOW_TIMESHARE, sorted(below)


def fig7_phase(torch) -> tuple:
    """``bench.fig7_sharing_accuracy`` on the card (``fig7_sharing_accuracy``):
    its own config and numpy ``VisionStream``s, two small CNNs pretrained
    280 AdamW steps each, then for 0, 2, 4, 6, 8 and every layer shared
    start->end, 8 epochs of joint retraining.  cuDNN runs its deterministic
    algorithms, so a rerun on the same card makes the same decisions; they
    are the port's own (its streams draw from numpy).  Gate: with every
    layer shared the least relative accuracy is no higher than with none.
    Returns (kernel launches, their routes)."""
    from repro_torch.bench import fig7_sharing_accuracy as F7B
    from repro_torch.kernels import ops

    t_phase = start_phase(torch, "fig7_sharing_accuracy")
    ops.reset_kernel_launches()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        t0 = time.perf_counter()
        inp = F7B.numpy_inputs("cuda")
        torch.cuda.synchronize()
        pretrain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = F7B.sharing_curve(inp)
        torch.cuda.synchronize()
        curve_s = time.perf_counter() - t0
    launches, routes = ops.kernel_launches(), ops.route_launches()
    emit("fig7_sharing_accuracy", decisions="port's own", rows=rows, pretrain_s=pretrain_s,
         curve_s=curve_s, launches=launches, seconds=time.perf_counter() - t_phase)
    assert rows[-1]["min_rel_acc"] <= rows[0]["min_rel_acc"], rows
    return launches, routes


def stablelm_plan_wire_phase(torch, cfg) -> tuple:
    """fig14's plan-wire lane (``bench.fig14_bandwidth.plan_wire``) on the
    full-width stablelm-1.6b zoo of ``stablelm_lm_serve``
    (``lm_merging.numpy_scenario``: lm-A/B/D/E and the foreign lm-C).  The
    lane perturbs the shared buffers lm-C does not bind, so the plan must
    leave lm-C some shared columns and not all of them.  The prefilter's
    keep at the bench's threshold (0.7) and at ``tap_cka``'s separating one
    are counted first; the lane's zoo is planned (the CKA prefilter, the
    coherence surrogate) at 0.7 when lm-C binds some but not all of the
    kept columns there, else at the separating threshold.  Printed: each
    lane's JSON and payload bytes and entry kinds, the wire ratios (the
    delta_q8 one beside the reference's 0.35 gate, not held: bf16 is not
    quantized, in either package), the seconds of every export, ``to_json``,
    ``from_json`` and ``apply_plan``.  The cloud's "retraining" keeps the
    reference's float32 sums (``fig14_bandwidth.retrained``), so every
    changed buffer ships as a float32 ``full`` entry and the edge computes
    with it: a float32 embedding table makes the whole residual stream
    float32, and flash then takes its float32 route.  Gates: the changed
    buffers float32 on the cloud, lm-C's logits bitwise across the
    delta_q8 apply, the quantized members within the drift monitor's
    threshold, both entry kinds present, flash launched, and every bank and
    flash launch on the tensor-core route unless the embedding table
    changed (then flash's float32 route taken).  Returns (kernel
    launches, their routes)."""
    from repro_torch.bench import fig14_bandwidth as F14B
    from repro_torch.bench import lm_merging as LMB
    from repro_torch.core import ParamStore, RepresentationSimilarityScorer, StagedPlanner
    from repro_torch.core import enumerate_groups
    from repro_torch.core.policy import CoherenceSurrogateTrainer, calibration_activations
    from repro_torch.kernels import ops

    t_phase = start_phase(torch, "stablelm_plan_wire")
    t0 = time.perf_counter()
    scn = LMB.numpy_scenario(cfg, "cuda")
    adapter = scn.adapter
    torch.cuda.synchronize()
    zoo_s = time.perf_counter() - t0
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m, p in scn.zoo.items() for r in adapter.records(cfg, p, m) if r.path in trunk]
    with torch.no_grad():
        acts = calibration_activations({m: (adapter, cfg, p) for m, p in scn.zoo.items()},
                                       scn.calibration)
    min_cka, separating = tap_cka(acts, trunk, scn.mids)
    cands = enumerate_groups(recs)
    kept_columns = {}
    for theta in (LMB.MIN_SIMILARITY, separating):
        kept, _ = RepresentationSimilarityScorer(acts, theta).prefilter(cands)
        cols = [col for g in kept for col in g.columns() if len(col) >= 2]
        kept_columns[f"{theta:.6f}"] = dict(
            shared=len(cols), bound_by_lm_c=sum(any(r.model_id == "lm-C" for r in col)
                                                for col in cols))
    at_bench = kept_columns[f"{LMB.MIN_SIMILARITY:.6f}"]
    theta = (LMB.MIN_SIMILARITY if 0 < at_bench["bound_by_lm_c"] < at_bench["shared"]
             else separating)
    calib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cloud = ParamStore.from_models(dict(scn.zoo))
    regs = [adapter.registered(cfg, m, i + 10, accuracy_target=0.0, device="cuda")
            for i, m in enumerate(scn.mids)]
    with torch.no_grad():
        res = StagedPlanner(cloud, regs, recs, CoherenceSurrogateTrainer(acts, theta),
                            scorer=RepresentationSimilarityScorer(acts, theta)).run()
    plan_s = time.perf_counter() - t0
    del acts, regs, cands
    t0 = time.perf_counter()
    rows, derived, seconds = F14B.plan_wire(scn, F14B.numpy_batch(cfg, "cuda"), (res, cloud))
    torch.cuda.synchronize()
    lane_s = time.perf_counter() - t0
    launches, routes = ops.kernel_launches(), ops.route_launches()
    gates = {k: v for k, v in F14B.gates(derived).items() if k != "wire_ratio_delta_q8 <= 0.35"}
    c_keys = set(cloud.bindings[F14B.UNTOUCHED].values())
    changed = [k for k in cloud.shared_keys() if k not in c_keys]
    assert len(changed) == derived["changed_keys"], (len(changed), derived["changed_keys"])
    assert all(cloud.buffers[k].dtype == torch.float32 for k in changed)
    changed_embedding = any(k in changed for k in
                            {cloud.bindings[m]["embed/table"] for m in scn.mids})
    emit("stablelm_plan_wire", config=cfg.name, members=list(scn.mids), min_tap_cka=min_cka,
         kept_columns_by_threshold=kept_columns, planned_at=theta,
         committed_groups=res.committed, rows=rows, derived=derived, gates=gates,
         changed_embedding=changed_embedding,
         timed=dict(wire_ratio_delta_q8=derived["wire_ratio_delta_q8"],
                    reference_gate="<= 0.35", asserted=False),
         lane_seconds=seconds, zoo_s=zoo_s, calibration_s=calib_s, planner_s=plan_s,
         lane_s=lane_s, launches=launches, route_launches=routes,
         seconds=time.perf_counter() - t_phase)
    assert all(gates.values()), gates
    assert launches["flash_attention"] > 0, launches
    if changed_embedding:  # the float32 table makes the stream float32
        assert routes["flash_attention"]["simt"] > 0, routes
    else:
        tensor_core_routes_only(routes)
    return launches, routes


# ---------------------------------------------------------------------------
# the LM benches at their defaults (the dense adapter's tiny config, head
# dim 16) and GEMEL across model families: the mixed zoo
# ---------------------------------------------------------------------------

LM_BENCH_DEFAULTS = ("lm_merging", "decode_serve", "fig14_bandwidth")
SIX_KERNELS = ("mamba_scan", "rg_lru_scan", "flash_attention", "decode_attention",
               "page_gather", "bank_matmul")
# the full-width mixed zoo's depth: each family's published widths whole,
# layers cut to keep the script inside its time limit (recurrentgemma at
# one whole (rec, rec, attn) period).  The phase's time is the plan's
# transport (JSON and base64 of every shared buffer, 7.1 GB at 4/2/4/3
# layers: 94.5 s of wall, the script 821 s), and the three embedding
# tables are 2.8 GB of it whatever the depth
MIXED_ZOO_LAYERS = {"dense": 2, "moe": 1, "ssm": 2, "hybrid": 3}
MIXED_ZOO_FULL = dict(seq=128, prompt_len=16, max_new=16,
                      decode_kw=dict(page_size=16, num_pages=32, max_slots=4, max_len=2048,
                                     buckets=(1, 2, 4)))


def lm_bench_defaults_phase(torch) -> tuple:
    """``python -m repro_torch.bench.<name>`` for lm_merging, decode_serve
    and fig14_bandwidth at their defaults (device ``cuda``): each runs its
    own gates and raises on a missed one.  Returns (kernel launches,
    their routes)."""
    import importlib

    from repro_torch.kernels import ops

    t_phase = start_phase(torch, "lm_bench_defaults")
    ops.reset_kernel_launches()
    seconds = {}
    for name in LM_BENCH_DEFAULTS:
        t0 = time.perf_counter()
        importlib.import_module(f"repro_torch.bench.{name}").main([])
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    launches, routes = ops.kernel_launches(), ops.route_launches()
    emit("lm_bench_defaults", benches=list(LM_BENCH_DEFAULTS), bench_seconds=seconds,
         launches=launches, route_launches=routes, seconds=time.perf_counter() - t_phase)
    assert launches["flash_attention"] > 0 and launches["decode_attention"] > 0, launches
    return launches, routes


def mixed_zoo_run(torch, name: str, scn, n_per_model: int, facts: dict) -> tuple:
    """``bench.mixed_zoo.run_zoo`` on ``scn`` with the kernel counters set
    to 0 just before and read just after; line ``name``.  Gates: the
    bench's own (four families served, a cross-member and a cross-family
    group, memory saved, served rows bitwise their replay, banked rows
    within 2e-2 of the row maximum of each member's own suffix, the decode
    replay within the dtype's tolerance) and every one of the six kernels
    launched.  Returns (kernel launches, their routes)."""
    from repro_torch.bench import mixed_zoo as MZB
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    rows, derived, info = MZB.run_zoo(scn, n_per_model)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, routes = ops.kernel_launches(), ops.route_launches()
    gates = MZB.gates(derived, info, scn.device)
    replay = info["decode_replay"]
    emit(name, **facts, rows=rows, derived=derived, gates=gates,
         resident_bytes=dict(unmerged=info["base_resident_bytes"],
                             merged=info["merged_resident_bytes"]),
         pruned_cross_family=info["pruned_cross_family"],
         pruned_prefilter=info["pruned_prefilter"], retrain_attempts=info["retrain_attempts"],
         shared_keys=info["shared_keys"],
         cross_family_signatures=info["cross_family_signatures"],
         serve_stats=info["serve_stats"], decode_stats=info["decode_stats"],
         bank_gap=info["bank_gap"], bank_gap_over_row_max=info["bank_gap_over_row_max"],
         decode_replay=replay, stage_seconds=info["seconds"], run_s=run_s,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), launches=launches,
         route_launches=routes)
    assert all(gates.values()), gates
    assert all(launches[k] > 0 for k in SIX_KERNELS), launches
    return launches, routes


def mixed_zoo_phase(torch) -> tuple:
    """``bench.mixed_zoo`` at its defaults on the card: the adapters' tiny
    configs (head dim 16, float32), 8 requests of 8 tokens a member, one
    decode request a member of 4 + 8 tokens."""
    from repro_torch.bench import mixed_zoo as MZB

    t_phase = start_phase(torch, "mixed_zoo")
    scn = MZB.numpy_scenario(device="cuda")
    out = mixed_zoo_run(torch, "mixed_zoo", scn, 8, dict(configs="the adapters' defaults"))
    emit("phase_end", name="mixed_zoo", seconds=time.perf_counter() - t_phase)
    return out


def mixed_zoo_full_phase(torch) -> tuple:
    """The mixed zoo at the published widths of olmo-1b (dense, tied,
    non-parametric LayerNorm), olmoe-1b-7b (moe: 64 experts, top-8),
    falcon-mamba-7b (ssm) and recurrentgemma-9b (hybrid, tied), depth cut
    (``MIXED_ZOO_LAYERS``), bf16: the bench's recipe (trunk + 0.005 N(0, 1)
    on B, heads + 1.0), one embedding table per shape (olmo and olmoe share
    the OLMo tokenizer's, falcon-mamba's and recurrentgemma's are shared
    within each pair), 8 requests of 128 tokens a member on buckets (1, 2,
    4), one decode request a member of 16 + 16 tokens (pages of 16, one
    slot per family, graphs on).  The tied heads (olmo, recurrentgemma)
    read the shared table, so the olmo pair's suffix is shared too and its
    group serves per-member heads; the untied pairs take the bank."""
    from repro_torch.bench import mixed_zoo as MZB
    from repro_torch.configs import falcon_mamba_7b, olmo_1b, olmoe_1b_7b, recurrentgemma_9b

    t_phase = start_phase(torch, "mixed_zoo_full")
    full = {"dense": olmo_1b.full_config(), "moe": olmoe_1b_7b.full_config(),
            "ssm": falcon_mamba_7b.full_config(), "hybrid": recurrentgemma_9b.full_config()}
    configs = {fam: cut_depth(cfg, MIXED_ZOO_LAYERS[fam]) for fam, cfg in full.items()}
    t0 = time.perf_counter()
    scn = MZB.numpy_scenario(configs, "cuda", **MIXED_ZOO_FULL)
    torch.cuda.synchronize()
    zoo_s = time.perf_counter() - t0
    tables: dict = {}
    for m, (_, cfg, params) in scn.members.items():
        t = params["embed"]["table"]
        tables.setdefault(id(t), dict(shape=list(t.shape), configs=set(), members=[]))
        tables[id(t)]["configs"].add(cfg.name)
        tables[id(t)]["members"].append(m)
    facts = dict(
        configs={fam: dict(name=cfg.name, d_model=cfg.d_model, vocab=cfg.vocab_size,
                           tied=cfg.tie_embeddings, dtype=cfg.dtype,
                           layers=cfg.n_layers, published_layers=full[fam].n_layers)
                 for fam, cfg in configs.items()},
        depth_cut={fam: f"{configs[fam].n_layers} of {full[fam].n_layers} layers"
                   for fam in configs},
        embedding_tables=[dict(t, configs=sorted(t["configs"])) for t in tables.values()],
        tied_suffix_note="olmo-1b and recurrentgemma-9b are tied: their heads read the "
                         "shared table, so each pair's suffix is shared and served per member",
        requests_per_member=8, buckets=MZB.BUCKETS, knobs=MIXED_ZOO_FULL,
        zoo_s=zoo_s)
    out = mixed_zoo_run(torch, "mixed_zoo_full", scn, 8, facts)
    emit("phase_end", name="mixed_zoo_full", seconds=time.perf_counter() - t_phase)
    return out


# ---------------------------------------------------------------------------
# the LM bench ports at full width: S2 (benchmarks/lm_merging.py's
# merge-and-serve with the suffix bank) and D1 (benchmarks/decode_serve.py's
# streaming decode against the per-request lane)
# ---------------------------------------------------------------------------


def stablelm_lm_serve_phase(torch, cfg) -> tuple:
    """``bench.lm_merging.merge_and_serve`` on full-width stablelm-1.6b
    (``stablelm_lm_serve``) on the bench's own scenario
    (``numpy_scenario``: the JAX bench's five members, the zoo drawn on the
    card, the tokens from numpy), the
    CKA-prefiltered plan with the coherence surrogate (``min_similarity``
    0.7) shipped as JSON, then the unmerged, merged per-member and
    merged-bank lanes on stores over the one zoo, each built and dropped in
    turn, at a capacity that holds the unmerged zoo (nothing swaps; the
    modelled DMA of first loads is on, as in the JAX bench).  Gates:
    scripts/ci.sh's structural S2 gates, a cross-variant group, bytes
    saved, one epoch bump, every served row bitwise its replay of the
    engine's own dispatch (``verify_bitwise``) and every banked row within
    2e-2 of the member's own suffix.  Printed: each member's argmax
    agreement with its original over its own requests' positions, and
    ``bank_speedup_rps`` beside the JAX gate of 1.5.  Returns (kernel
    launches of the phase, their routes, the scenario, the shipped plan)."""
    from repro_torch.bench import lm_merging as LMB
    from repro_torch.kernels import ops

    t_phase = start_phase(torch, "stablelm_lm_serve")
    t0 = time.perf_counter()
    scn = LMB.numpy_scenario(cfg, "cuda")
    adapter = scn.adapter
    torch.cuda.synchronize()
    zoo_s = time.perf_counter() - t0
    ops.reset_kernel_launches()
    shipped = LMB.ship_plan(scn)
    lanes, agreement = {}, {}

    def on_lane(name, eng, stats):
        lanes[name] = dict(requests_per_s=stats["requests_per_s"], elapsed_s=stats["elapsed_s"],
                           microbatches=stats["microbatches"],
                           suffix_dispatches=stats["suffix_dispatches"],
                           dma_stall_s=stats["dma_stall_s"], dma_hidden_s=stats["dma_hidden_s"],
                           resident_bytes=eng.store.resident_bytes())
        if name != "merged-plan-bank":
            return
        with torch.no_grad():
            for i, m in enumerate(scn.mids):
                tokens = torch.cat([scn.payload(i, j) for j in range(LMB.REQS_PER_MODEL)])
                want = adapter.forward(cfg, scn.zoo[m], tokens).argmax(-1)
                got = adapter.forward(cfg, eng.store.materialize(m), tokens).argmax(-1)
                agreement[m] = (got == want).float().mean().item()

    t0 = time.perf_counter()
    rows, derived = LMB.merge_and_serve(scn, shipped=shipped, on_lane=on_lane)
    torch.cuda.synchronize()
    lanes_s = time.perf_counter() - t0
    launches, routes = ops.kernel_launches(), ops.route_launches()
    tensor_core_routes_only(routes)
    assert launches["bank_matmul"] > 0 and launches["flash_attention"] > 0, launches
    gates = dict(LMB.gates(derived))
    gates["epoch_bumps == 1"] = derived["epoch_bumps"] == 1
    gates["bank_gap <= 2e-2"] = derived["bank_gap"] <= TOL["bfloat16"]["atol"]
    res = shipped["result"]
    emit("stablelm_lm_serve", config=cfg.name, members=list(scn.mids), rows=rows,
         derived=derived, gates=gates,
         timed=dict(bank_speedup_rps=derived["bank_speedup_rps"], reference_gate=">= 1.5",
                    throughput_ratio=derived["throughput_ratio"], asserted=False),
         argmax_agreement_with_original=agreement, lanes=lanes, plan_groups=len(res.plan.groups),
         seconds_cloud=shipped["seconds"], zoo_s=zoo_s, lanes_s=lanes_s, launches=launches,
         route_launches=routes, seconds=time.perf_counter() - t_phase)
    assert all(gates.values()), {k: v for k, v in gates.items() if not v}
    return launches, routes, scn, shipped["plan"]


def profile_lane(torch, rerun, range_name: str) -> tuple:
    """``rerun()`` — a decode lane served once more on the same executor or
    engine — under ``torch.profiler``, its kernel launches taken off the
    counts.  Returns (the device's busy ms inside the lane's profiler range
    ``range_name``, which spans its timed loop and leaves the warm-up and
    the captures before it out; the rerun's stats)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.graphs import uncounted

    torch.cuda.synchronize()
    with uncounted(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stats = rerun()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    (lane,) = [e for e in events if e.name == range_name and e.device_type != cuda]
    lo, hi = lane.time_range.start, lane.time_range.end
    # the range's own mirror on the device timeline is an annotation, not work
    busy_us = sum(e.time_range.elapsed_us() for e in events
                  if e.device_type == cuda and e.name != range_name
                  and lo <= e.time_range.start <= hi)
    return busy_us / 1e3, stats


def stablelm_decode_serve_phase(torch, scn, plan) -> tuple:
    """``bench.decode_serve.run_lanes`` on ``stablelm_lm_serve``'s zoo and
    plan at the JAX bench's sizes (``stablelm_decode_serve``): 16 requests
    per member of 4 prompt and 12 new tokens; pages of 8, 128 pages, 32
    slots, buckets 1-32; the per-request lane (``EdgeExecutor``, capacity
    for the whole unmerged zoo), the merged paged lane, its logits-recording
    pass replayed through the unpaged decode, and the mid-decode hot swap
    after step 4, each on its own store over the zoo, in turn.  Both decode
    lanes replay CUDA graphs.  Gates: every structural D1 gate of
    scripts/ci.sh, the replay within 2e-2 of each row's maximum with no
    confident argmax flip (``decode_serve.replay_check``) in place of
    bitwise, graph replays in both lanes.  Printed: ``decode_speedup``
    beside the gate of 2, and for each decode lane its wall per step, the
    modelled DMA seconds in its wall time, and the device's busy time a
    step and idle share: the lane is served once more on the same executor
    or engine under ``torch.profiler`` (``profile_lane``; its models are
    resident by then, so it sleeps no DMA) — the merged lane whole, the
    per-request lane on a window of one request per member (60 of its 960
    steps, all of one shape: the trace of all 960 takes minutes to read)
    — and the busy time a step of that rerun's timed loop is held against
    the rerun's own wall (``_profiled``, which the profiler slows) and
    against the unprofiled lane's wall, with and without the lane's
    modelled DMA.  Returns (kernel launches of the phase, their routes)."""
    from repro_torch.bench import decode_serve as DSB
    from repro_torch.kernels import ops
    from repro_torch.serving.costs import PCIE_GBPS
    from repro_torch.serving.executor import ModelProgram

    t_phase = start_phase(torch, "stablelm_decode_serve")
    ops.reset_kernel_launches()
    lanes = {}
    last = [collections.Counter()]
    reqs = DSB.decode_requests(scn, DSB.REQS_PER_MODEL, DSB.PROMPT_LEN, DSB.MAX_NEW)
    window = DSB.decode_requests(scn, 1, DSB.PROMPT_LEN, DSB.MAX_NEW)
    programs = [ModelProgram.from_adapter(scn.adapter, m, cfg=scn.cfg) for m in scn.mids]
    reruns = {
        "per-request-baseline": (
            lambda ex: ex.serve_decode(window, programs, max_len=DSB.MAX_LEN),
            "EdgeExecutor.serve_decode.lane"),
        "merged-paged-continuous": (
            lambda eng: eng.serve_decode(
                reqs, page_size=DSB.PAGE_SIZE, num_pages=DSB.NUM_PAGES,
                max_slots=DSB.MAX_SLOTS, max_len=DSB.MAX_LEN, buckets=DSB.BUCKETS),
            "StreamingDecoder.run.steps")}

    def on_lane(name, lane, stats):
        now = collections.Counter(ops.kernel_launches())
        info = dict(steps=stats["steps"], tokens_decoded=stats["tokens_decoded"],
                    elapsed_s=stats["elapsed_s"], launches=dict(now - last[0]))
        last[0] = now
        graphs = lane.decode_graphs if name == "per-request-baseline" else lane.last_decoder.graphs
        info.update(graph_captures=graphs.captures, graph_replays=graphs.replays)
        if name in reruns:
            dma_s = (lane.scheduler.stats["loaded_bytes"] / 1e9 / PCIE_GBPS
                     if name == "per-request-baseline" else lane.dma.stall_s)
            serve, range_name = reruns[name]
            busy_ms, again = profile_lane(torch, lambda: serve(lane), range_name)
            want = len(window) * DSB.MAX_NEW if name == "per-request-baseline" else stats["steps"]
            assert again["steps"] == want, (again, stats)
            step_ms = busy_ms / again["steps"]
            wall_ms = stats["elapsed_s"] * 1e3
            info.update(wall_ms_per_step=wall_ms / stats["steps"], modelled_dma_s=dma_s,
                        profiled_steps=again["steps"], device_busy_ms_profiled=busy_ms,
                        device_ms_per_step=step_ms,
                        wall_ms_per_step_profiled=again["elapsed_s"] * 1e3 / again["steps"],
                        device_idle_share_profiled=1 - busy_ms / (again["elapsed_s"] * 1e3),
                        device_idle_share=1 - step_ms * stats["steps"] / wall_ms,
                        device_idle_share_without_dma=1 - step_ms * stats["steps"] / (
                            wall_ms - dma_s * 1e3))
        lanes[name] = info

    t0 = time.perf_counter()
    rows, derived = DSB.run_lanes(scn, DSB.REQS_PER_MODEL, DSB.MAX_NEW, plan=plan,
                                  on_lane=on_lane)
    torch.cuda.synchronize()
    lanes_s = time.perf_counter() - t0
    launches, routes = ops.kernel_launches(), ops.route_launches()
    tensor_core_routes_only(routes)
    assert all(launches[k] > 0 for k in ("page_gather", "decode_attention", "bank_matmul")), \
        launches
    base, merged = lanes["per-request-baseline"], lanes["merged-paged-continuous"]
    gates = DSB.gates(derived, smoke=True)  # the structural ones; the timed one is printed
    gates["per-request lane graph replays > 0"] = base["graph_replays"] > 0
    gates["merged lane graph replays > 0"] = merged["graph_replays"] > 0
    tokens = base["tokens_decoded"]
    emit("stablelm_decode_serve", config=scn.cfg.name, members=list(scn.mids), rows=rows,
         derived=derived, gates=gates,
         decode_speedup=derived["decode_speedup"], reference_gate=">= 2.0", asserted=False,
         decode_speedup_without_modelled_dma=(
             tokens / (merged["elapsed_s"] - merged["modelled_dma_s"]))
         / (tokens / (base["elapsed_s"] - base["modelled_dma_s"])),
         lanes=lanes, lanes_s=lanes_s, launches=launches, route_launches=routes,
         seconds=time.perf_counter() - t_phase)
    assert all(gates.values()), {k: v for k, v in gates.items() if not v}
    return launches, routes


SHARD_MIDS = ("lm-A", "lm-B", "lm-D", "lm-E")


def stablelm_sharded_phase(torch, cfg) -> tuple:
    """``bench.shard_serve.run`` on full-width stablelm-1.6b at
    ``FAMILY_LAYERS`` (``stablelm_sharded``): the bench's scenario
    (``numpy_scenario``, the zoo drawn on the card) cut to the merged group
    (A, B, D, E) (``SHARD_MIDS``: at full width lm-C's random trunk merges
    too, as in ``stablelm_lm_serve``, and a bank of five does not divide
    over four shards, so it would replicate), planned and shipped by
    ``lm_merging.ship_plan``, on a (2, 4) mesh of the card, the bank's four
    members one to a shard.  Lanes: the unsharded
    and the sharded decode of 8 requests (2 a member, 7 prompt + 5 new tokens,
    chunked prefill on, logits recorded; graphs replayed), compared bit for
    bit; the per-shard epoch accounting of ``apply_plan`` and
    ``update_buffers``; the over-budget admission (a per-shard budget below
    the group's resident bytes and at or above the largest shard's slice).
    Gates: every gate of ``shard_serve`` (scripts/ci.sh's S3 gates, bitwise
    in place of its ref/interpret pair), ``bank_matmul``, ``page_gather``
    and ``decode_attention`` launched, the tensor-core routes only, and the
    sharded lane launching ``bank_matmul`` ``n_shards`` times for each
    launch of the unsharded lane, which makes the same bank dispatches.
    Returns (kernel launches of the phase, their routes)."""
    from repro_torch.bench import lm_merging as LMB
    from repro_torch.bench import shard_serve as SSB
    from repro_torch.kernels import ops

    t_phase = start_phase(torch, "stablelm_sharded")
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    scn = LMB.numpy_scenario(cfg, "cuda")
    scn = dataclasses.replace(scn, zoo={m: scn.zoo[m] for m in SHARD_MIDS})
    shipped = LMB.ship_plan(scn)
    torch.cuda.synchronize()
    cloud_s = time.perf_counter() - t0
    lanes = {}
    last = [collections.Counter(), collections.Counter()]
    t_lane = [time.perf_counter()]

    def on_lane(name, eng, stats):
        torch.cuda.synchronize()
        now = collections.Counter(ops.kernel_launches())
        bank_routes = collections.Counter(ops.route_launches()["bank_matmul"])
        lanes[name] = dict(
            steps=stats["steps"], completed=stats["completed"],
            bank_dispatches=stats["bank_dispatches"],
            prefill_chunk_dispatches=stats["prefill_chunk_dispatches"],
            launches=dict(now - last[0]), bank_matmul_by_route=dict(bank_routes - last[1]),
            graph_replays=eng.last_decoder.graphs.replays,
            store_shards=eng.store.n_shards, seconds=time.perf_counter() - t_lane[0])
        last[0], last[1] = now, bank_routes
        t_lane[0] = time.perf_counter()

    t_lane[0] = time.perf_counter()
    out = SSB.run(scn, plan=shipped["plan"], on_lane=on_lane)
    torch.cuda.synchronize()
    d = out["derived"]
    launches, routes = ops.kernel_launches(), ops.route_launches()
    tensor_core_routes_only(routes)
    n = d["n_shards"]
    plain, sharded = lanes["unsharded"], lanes["sharded"]
    gates = dict(SSB.gates(d))
    for k in ("bank_matmul", "page_gather", "decode_attention"):
        gates[f"{k} launches > 0"] = launches[k] > 0
    gates["same bank dispatches in both lanes"] = \
        sharded["bank_dispatches"] == plain["bank_dispatches"] > 0
    gates["sharded bank launches == n_shards x unsharded"] = \
        sharded["launches"]["bank_matmul"] == n * plain["launches"]["bank_matmul"] > 0
    gates["graph replays in both lanes"] = plain["graph_replays"] > 0 < sharded["graph_replays"]
    emit("stablelm_sharded", config=scn.cfg.name, layers=scn.cfg.n_layers,
         members=list(scn.mids), mesh=d["mesh"], n_shards=n, rows=out["rows"], derived=d,
         plan_groups=len(shipped["plan"].groups), plan_bytes=shipped["plan_bytes"],
         seconds_cloud=shipped["seconds"], cloud_s=cloud_s,
         gates=gates, bitwise=d["bitwise"], max_logit_diff=d["max_logit_diff"],
         epochs=dict(apply_plan_epoch_bumps=d["apply_plan_epoch_bumps"],
                     apply_plan_touched_shards=d["apply_plan_touched_shards"],
                     update_buffers_bumped_shards=d["update_buffers_bumped_shards"]),
         over_budget=dict(capacity_bytes=d["over_budget_capacity_bytes"],
                          activation_bytes=d["over_budget_activation_bytes"],
                          group_resident_bytes=d["group_resident_bytes"],
                          max_shard_resident_bytes=d["max_shard_resident_bytes"],
                          completed=d["over_budget_completed"]),
         lanes=lanes, launches=launches, route_launches=routes,
         seconds=time.perf_counter() - t_phase)
    assert all(gates.values()), {k: v for k, v in gates.items() if not v}
    return launches, routes


# ---------------------------------------------------------------------------
# phase 10: joint retraining on the card
# ---------------------------------------------------------------------------


class LoggedMergeTrainer:
    """``MergeTrainer`` with two records per attempt: the joint loss of the
    involved members on their first training batches right after the merge
    and after the retraining, and, on the attempt's first step, how far
    each shared buffer's joint gradient lies from the mean of the members'
    separate gradients (the joint loss is their mean), relative to the
    largest of the latter."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.attempts = []

    def train(self, store, models):
        import torch

        from repro_torch.core.merging import joint_grads, joint_loss

        bindings = {m.model_id: dict(store.bindings[m.model_id]) for m in models}
        loss_fns = {m.model_id: m.loss_fn for m in models}
        batches = {m.model_id: m.train_batches(0)[0] for m in models}
        keys = sorted({k for b in bindings.values() for k in b.values()})
        buffers = {k: store.buffers[k] for k in keys}
        _, grads = joint_grads(bindings, loss_fns, buffers, batches)
        per = [joint_grads({m: bindings[m]}, loss_fns, buffers, batches)[1] for m in bindings]
        shared = [k for k in keys if sum(k in b.values() for b in bindings.values()) > 1]
        rel = 0.0
        for k in shared:
            mean = sum(g[k] for g in per) / len(per)
            rel = max(rel, ((grads[k] - mean).abs().max() / mean.abs().max()).item())
        with torch.no_grad():
            before = joint_loss(bindings, loss_fns, buffers, batches).item()
        result = self.trainer.train(store, models)
        with torch.no_grad():
            after = joint_loss(bindings, loss_fns, {k: store.buffers[k] for k in keys},
                               batches).item()
        self.attempts.append(dict(models=sorted(bindings), shared_keys=len(shared),
                                  grad_rel_err=rel, loss_before=before, loss_after=after,
                                  success=result.success, epochs=result.epochs_used,
                                  failed=sorted(result.failed_models)))
        return result


def small_cnn_retrain_phase(torch) -> None:
    """``examples/quickstart.py`` on the card: two small CNNs pretrained on
    two ``VisionStream`` feeds (280 AdamW steps each), then
    ``IncrementalMerger`` with real joint retraining (``MergeTrainer``,
    AdamW, up to 20 epochs an attempt, targets 0.9 of each member's
    pretrained accuracy).  cuDNN runs its deterministic algorithms here:
    the planner's decisions follow the trained accuracies, so a rerun on
    the same card makes the same ones."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        _small_cnn_retrain(torch)


def _small_cnn_retrain(torch) -> None:
    from repro_torch.bench.fig7_sharing_accuracy import pretrain
    from repro_torch.core import IncrementalMerger, MergeTrainer, ParamStore, RegisteredModel
    from repro_torch.core import records_from_params
    from repro_torch.core.validation import meets_targets, validate
    from repro_torch.data.synthetic import VisionStream
    from repro_torch.models import vision as VI
    from repro_torch.train.optimizer import AdamW
    from repro_torch.utils.ids import stable_seed

    cfg = VI.SmallCNNConfig(task="classification", n_classes=4, depth=1, width=8, n_stages=2)
    streams = {"cam-A": VisionStream(4, 32, seed=7, device="cuda"),
               "cam-B": VisionStream(4, 32, seed=8, device="cuda")}
    params, orig_acc = {}, {}
    t0 = time.perf_counter()
    for mid, stream in streams.items():
        p0 = VI.init_small_cnn(cfg, seed=stable_seed(mid), device="cuda")
        params[mid] = pretrain(cfg, p0, stream)
        with torch.no_grad():
            orig_acc[mid] = float(VI.small_cnn_accuracy(cfg, params[mid], stream.batch_at(0)))
    pretrain_s = time.perf_counter() - t0
    store = ParamStore.from_models(params)
    before = store.resident_bytes()
    regs = [RegisteredModel(mid, lambda p, b: VI.small_cnn_loss(cfg, p, b),
                            lambda p, b: VI.small_cnn_accuracy(cfg, p, b),
                            lambda e, s=streams[mid]: s.epoch(e, n_batches=4),
                            streams[mid].batch_at(0), accuracy_target=0.9,
                            original_accuracy=orig_acc[mid])
            for mid in params]
    recs = sum((records_from_params(params[m], m) for m in params), [])
    trainer = LoggedMergeTrainer(MergeTrainer(max_epochs=20, optimizer=AdamW(lr=2e-3)))
    t0 = time.perf_counter()
    result = IncrementalMerger(store, regs, recs, trainer, min_group_bytes=4096).run()
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    accs = validate(store, regs)
    attempts = trainer.attempts
    committed = [a for a in attempts if a["success"]]
    assert result.committed >= 1, attempts
    assert all(a["grad_rel_err"] <= 1e-5 for a in attempts), attempts
    # the merge raises the members' joint loss and retraining brings it
    # down: over the committed attempts together it falls
    assert sum(a["loss_after"] for a in committed) < sum(a["loss_before"] for a in committed), \
        committed
    # VisionStream's pools come from numpy's default_rng, not the JAX
    # package's jax.random: these decisions are the port's own, held by the
    # gates above and not against the JAX package
    emit("small_cnn_retrain", decisions="port's own", pretrain_s=pretrain_s,
         original_accuracy=orig_acc,
         committed=result.committed, attempted=result.attempted, discarded=result.discarded,
         resident_bytes_unmerged=before, resident_bytes_merged=store.resident_bytes(),
         saved_fraction=result.fraction_saved, merge_s=merge_s, attempts=attempts,
         events=[dict(group=e.group_signature[0], saved_bytes=e.saved_bytes,
                      accuracies=e.accuracies) for e in result.events],
         validated_accuracy=accs, targets_met=meets_targets(accs, regs),
         max_grad_rel_err=max(a["grad_rel_err"] for a in attempts))


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 9e: the family call surface of all ten architectures at full width
# ---------------------------------------------------------------------------

# layers run of each architecture, widths whole (None: all of them);
# falcon-mamba's and recurrentgemma's are phase 6's FAMILY_LAYERS
ARCH_LAYERS = {
    "stablelm-1.6b": None, "olmo-1b": None, "internvl2-2b": None,
    "seamless-m4t-medium": None, "qwen3-14b": 4, "qwen2-72b": 2,
    "deepseek-moe-16b": 3,  # the dense first layer and two moe layers
    "olmoe-1b-7b": 2, "falcon-mamba-7b": FAMILY_LAYERS["falcon_mamba"],
    "recurrentgemma-9b": FAMILY_LAYERS["recurrentgemma"],
}
ARCH_BATCH, ARCH_PROMPT, ARCH_NEW = 2, 128, 8
VLM_TEXT = 64  # internvl2-2b: its 256 patch embeddings, then 64 text tokens
ENCDEC_SRC, ENCDEC_TGT = 128, 64  # seamless-m4t-medium: source frames, target tokens
# the decode-against-forward check's moe capacity factor: at 1.25 the same
# token routes differently in a forward than in a prefill plus decode
# (capacity competition, the moe family's semantics); the JAX package's own
# check (tests/test_models.py) raises it to 8.0 for that reason
ARCH_MOE_CAPACITY = 8.0
# the check's bounds on the largest |difference| over the forward row's
# largest magnitude, set from chip_arch_numerics.py's readings on an H100
# (PERF.md): in float32 (the port's logic) they read at most 7.6e-6; in
# bf16 up to 2.02% at 24 random layers, about as far as the bf16 forward
# alone is from the float32 one, and up to 1.3% in the moe archs where
# their routing agrees with the forward's
ARCH_F32_TOL = 1e-4
ARCH_BF16_TOL = 3e-2
# kernels each family's forward, prefill and decode must launch
ARCH_EXPECT = {"dense": ("flash_attention", "decode_attention"),
               "moe": ("flash_attention", "decode_attention"),
               "vlm": ("flash_attention", "decode_attention"),
               "ssm": ("mamba_scan",), "hybrid": ("rg_lru_scan", "flash_attention"),
               "encdec": ()}
RECORDS_ONLY_VARIANTS = ("A", "B", "C")
# the stub frontends' patch and frame embeddings at the scale of the
# models' own token embeddings (the table's 0.02 N(0, 1)), the space a
# projector maps them into.  At N(0, 1) internvl2-2b's bf16
# decode-against-forward check reads 3.0-3.2% of the row maximum, with its
# bf16 forward alone 3.1-3.6% off the float32 forward of the same weights
# and the float32 check at 6.8e-6 (chip_arch_numerics.py): bf16 rounding
# through 24 random layers, not the port
FRONTEND_SCALE = 0.02


def arch_config(arch: str):
    """``arch``'s full config at ``ARCH_LAYERS`` depth (bf16, widths whole),
    moe at ``ARCH_MOE_CAPACITY``, and the depth cut as text."""
    from repro_torch.configs.registry import load_arch

    mod = load_arch(arch)
    full = mod.full_config()
    n = ARCH_LAYERS[arch]
    cfg = full if n is None else cut_depth(full, n)
    if mod.FAMILY == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=ARCH_MOE_CAPACITY)
    if mod.FAMILY == "encdec":
        cut = f"{cfg.n_enc_layers} + {cfg.n_dec_layers} of {full.n_enc_layers} + " \
              f"{full.n_dec_layers} layers (whole)"
    else:
        cut = f"{cfg.n_layers} of {full.n_layers} layers" + (" (whole)" if n is None else "")
    return mod.FAMILY, cfg, cut


def arch_inputs(torch, family: str, cfg, seed: int) -> tuple:
    """(tokens, extra) drawn with numpy and moved to the card: the prompt
    (B, 128) of the token LMs, internvl2's 64 text tokens and (B, 256, d)
    patch embeddings, seamless's 64 target tokens and (B, 128, d) frames,
    the embeddings ``FRONTEND_SCALE`` N(0, 1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_tok = {"vlm": VLM_TEXT, "encdec": ENCDEC_TGT}.get(family, ARCH_PROMPT)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (ARCH_BATCH, n_tok))).cuda()
    extra = None
    if family in ("vlm", "encdec"):
        n = cfg.n_patches if family == "vlm" else ENCDEC_SRC
        extra = torch.from_numpy(FRONTEND_SCALE * rng.standard_normal(
            (ARCH_BATCH, n, cfg.d_model), dtype=np.float32)).cuda()
    return toks, extra


def family_call(fam, family: str, name: str, cfg, params, toks, extra, *rest):
    """``fam.<name>`` on the family's inputs: vlm takes (tokens, patches),
    encdec (frames, tokens), the others tokens; moe's forward (logits,
    aux) gives its logits."""
    fn = getattr(fam, name)
    if family == "vlm":
        out = fn(cfg, params, toks, extra, *rest)
    elif family == "encdec":
        out = fn(cfg, params, extra, toks, *rest)
    else:
        out = fn(cfg, params, toks, *rest)
    return out[0] if name == "forward" and family == "moe" else out


def timed(torch, fn):
    """(result, ms) of one call, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


class RouteRecorder:
    """Inside ``with``, records every moe routing decision: each
    ``moe.route`` call appends the experts each of its tokens was
    dispatched to, (tokens, E) bool, tokens in (row, position) order."""

    def __init__(self):
        self.calls: list = []

    def __enter__(self):
        from repro_torch.models import moe

        self._route = route = moe.route

        def recording(cfg, router_w, x):
            out = route(cfg, router_w, x)
            self.calls.append((out[0].sum(-1) > 0).reshape(-1, cfg.n_experts))
            return out

        moe.route = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self._route

    def per_layer(self, batch: int, n_layers: int):
        """The decisions as (n_layers, batch, positions, E): the calls in
        layer order, call after call (a prefill, then each decode step),
        each call's tokens concatenated along the positions."""
        import torch

        layers = [self.calls[i::n_layers] for i in range(n_layers)]
        return torch.stack([torch.cat([c.reshape(batch, -1, c.shape[-1]) for c in cs], 1)
                            for cs in layers])


def moe_layers(family: str, cfg) -> int:
    return cfg.n_layers - cfg.first_dense_layers if family == "moe" else 0


def greedy_decode(torch, fam, family: str, cfg, params, toks, extra, max_len: int) -> dict:
    """Prefill of the prompt ``toks``, then ``ARCH_NEW`` greedy decode
    steps, each call timed: rows (the prefill's last logits, then each
    step's, float32), toks (prompt and generated tokens), prefill_ms,
    step_ms, length (the cache's), and for a moe family routes (its
    decisions at every position, ``RouteRecorder.per_layer``)."""
    rec = RouteRecorder()
    with rec:
        (logits, cache), prefill_ms = timed(torch, lambda: family_call(
            fam, family, "prefill", cfg, params, toks, extra, max_len))
        rows = [logits[:, -1].float()]
        step_ms = []
        for _ in range(ARCH_NEW):
            nxt = rows[-1][:, :cfg.vocab_size].argmax(-1, keepdim=True).to(toks.dtype)
            toks = torch.cat([toks, nxt], dim=1)
            (logits, cache), ms = timed(torch, lambda: fam.decode_step(cfg, params, cache, nxt))
            rows.append(logits[:, -1].float())
            step_ms.append(ms)
    out = dict(rows=rows, toks=toks, prefill_ms=prefill_ms, step_ms=step_ms,
               length=int(cache["length"]))
    if moe_layers(family, cfg):
        out["routes"] = rec.per_layer(toks.shape[0], moe_layers(family, cfg))
    return out


def against_forward(torch, fam, family: str, cfg, params, toks, extra, rows: list,
                    routes=None) -> dict:
    """Each of ``rows`` (the prefill's last logits, then each decode
    step's) against the forward over the prompt and the tokens so far
    (``toks`` holds them all) at its last position, both divided by the
    forward row's largest magnitude.  Returns, per (row of ``rows``, batch
    row), ``err`` (the largest |difference| over the row maximum) and
    ``agree`` (argmax agreement); given the decode's moe ``routes``, also
    ``flipped_here`` (a routing decision at the checked position differs
    from the forward's, at any layer), ``flipped_before`` (one at an
    earlier position does) and ``flipped_decisions`` (the (layer, row,
    position) decisions that differ, over the last forward, which covers
    every position)."""
    err, agree, here, before, flipped = [], [], [], [], 0
    for i, got in enumerate(rows):
        n = toks.shape[1] - ARCH_NEW + i
        rec = RouteRecorder()
        with rec:
            want = family_call(fam, family, "forward", cfg, params, toks[:, :n], extra)
        want = want[:, -1].float()
        scale = want.abs().amax(-1, keepdim=True)
        err.append(((got - want).abs() / scale).amax(-1))
        agree.append(got[:, :cfg.vocab_size].argmax(-1) == want[:, :cfg.vocab_size].argmax(-1))
        if routes is not None:
            fwd = rec.per_layer(toks.shape[0], routes.shape[0])
            diff = (fwd[:, :, :n] != routes[:, :, :n]).any(-1).any(0)  # (B, n)
            here.append(diff[:, -1])
            before.append(diff[:, :-1].any(-1))
            flipped = int(diff.sum())
    out = dict(err=torch.stack(err).cpu(), agree=torch.stack(agree).cpu())
    if routes is not None:
        out.update(flipped_here=torch.stack(here).cpu(), flipped_before=torch.stack(before).cpu(),
                   flipped_decisions=flipped, decisions=routes.shape[0] * routes.shape[1]
                   * routes.shape[2])
    return out


def upcast(cfg, params) -> tuple:
    """(cfg, params) in float32: the same weights, upcast."""
    from repro_torch.utils.tree import flatten_paths, unflatten_paths

    return (dataclasses.replace(cfg, dtype="float32"),
            unflatten_paths({k: v.float() for k, v in flatten_paths(params).items()}))


def float32_check(torch, fam, family: str, cfg, params, toks, extra, max_len: int) -> dict:
    """The decode-against-forward check on the same weights upcast to
    float32, fed ``toks``' tokens (teacher-forced: the prefill over the
    prompt, then one step a token): the port's prefill and decode logic
    free of bf16 rounding (``against_forward``'s result).  Its kernel
    launches (float32 routes) are a check's, not the main path's."""
    c32, p32 = upcast(cfg, params)
    n_prompt = toks.shape[1] - ARCH_NEW
    rec = RouteRecorder()
    with rec:
        logits, cache = family_call(fam, family, "prefill", c32, p32, toks[:, :n_prompt],
                                    extra, max_len)
        rows = [logits[:, -1].float()]
        for i in range(ARCH_NEW):
            logits, cache = fam.decode_step(c32, p32, cache,
                                            toks[:, n_prompt + i:n_prompt + i + 1])
            rows.append(logits[:, -1].float())
    n_moe = moe_layers(family, cfg)
    return against_forward(torch, fam, family, c32, p32, toks, extra, rows,
                           rec.per_layer(toks.shape[0], n_moe) if n_moe else None)


def arch_run(torch, arch: str, seed: int) -> dict:
    """One architecture through ``get_family(FAMILY)``: forward over the
    prompt, prefill (max_len = prompt + 8), 8 greedy decode steps (each
    timed), each step's logits and the prefill's held against the forward
    (``against_forward``) within ``ARCH_BF16_TOL``, and the same check in
    float32 within ``ARCH_F32_TOL`` (``float32_check``).  A moe
    architecture's bf16 check is held only where its routing agrees with
    the forward's at the checked position (``flipped_here``): rounding
    flips a top-k decision there, a discrete change as capacity
    competition is; its flips are printed.  Kernel launches are counted
    over the bf16 forward, prefill and steps.  The row is printed before
    its gates are checked."""
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_family
    from repro_torch.utils.tree import flatten_paths

    family, cfg, cut = arch_config(arch)
    fam = get_family(family)
    params = fam.init(cfg, seed, "cuda")
    weight_bytes = sum(nbytes(t) for t in flatten_paths(params).values())
    toks, extra = arch_inputs(torch, family, cfg, seed)
    offset = cfg.n_patches if family == "vlm" else 0  # positions before the text
    max_len = offset + toks.shape[1] + ARCH_NEW
    with torch.no_grad():
        # warm-ups: a first call pays for lazily loaded library kernels
        family_call(fam, family, "forward", cfg, params, toks, extra)
        family_call(fam, family, "prefill", cfg, params, toks, extra, max_len)
        ops.reset_kernel_launches()
        _, forward_ms = timed(torch, lambda: family_call(fam, family, "forward", cfg, params,
                                                         toks, extra))
        run = greedy_decode(torch, fam, family, cfg, params, toks, extra, max_len)
        launches, routes = ops.kernel_launches(), ops.route_launches()
        toks = run["toks"]
        chk = against_forward(torch, fam, family, cfg, params, toks, extra, run["rows"],
                              run.get("routes"))
        chk32 = float32_check(torch, fam, family, cfg, params, toks, extra, max_len)
    held = ~chk["flipped_here"] if family == "moe" else torch.ones_like(chk["agree"])
    worst_held = float(chk["err"][held].max()) if held.any() else None
    row = dict(arch=arch, family=family, depth_cut=cut, dtype=cfg.dtype, d_model=cfg.d_model,
               weight_bytes=weight_bytes, batch=ARCH_BATCH,
               tokens=dict(prompt=toks.shape[1] - ARCH_NEW, new=ARCH_NEW,
                           prefix=offset or (ENCDEC_SRC if family == "encdec" else 0)),
               max_len=max_len, forward_ms=forward_ms, prefill_ms=run["prefill_ms"],
               decode_step_ms=sum(run["step_ms"]) / ARCH_NEW, decode_step_ms_each=run["step_ms"],
               checked_positions=len(run["rows"]),
               max_abs_err_over_row_max=float(chk["err"].max()),
               held_positions=int(held.sum()), held_max_abs_err_over_row_max=worst_held,
               tol=ARCH_BF16_TOL, argmax_agreement=float(chk["agree"].float().mean()),
               float32_max_abs_err_over_row_max=float(chk32["err"].max()),
               float32_tol=ARCH_F32_TOL,
               launches={k: v for k, v in launches.items() if v},
               route_launches={k: {r: n for r, n in v.items() if n}
                               for k, v in routes.items() if any(v.values())})
    if family == "moe":
        row["capacity_factor"] = dict(run=ARCH_MOE_CAPACITY, published=1.25,
                                      why="decode-against-forward check, as tests/test_models.py")
        row["routing"] = dict(
            decisions=chk["decisions"], flipped_decisions=chk["flipped_decisions"],
            flipped_at_checked_position=int(chk["flipped_here"].sum()),
            flipped_before_checked_position=int(chk["flipped_before"].sum()),
            err_where_flipped=[round(float(e), 6) for e in chk["err"][chk["flipped_here"]]],
            float32_flipped_decisions=chk32["flipped_decisions"])
    if hasattr(cfg, "kv_repl"):
        row["kv_repl"] = cfg.kv_repl
    emit("arch_family", **row)
    assert run["length"] == max_len, (arch, run["length"], max_len)
    for name in ARCH_EXPECT[family]:
        assert launches[name] > 0, (arch, name, launches)
    assert worst_held is not None, (arch, "no checked position to hold")
    assert worst_held <= ARCH_BF16_TOL, (arch, worst_held)
    assert float(chk32["err"].max()) <= ARCH_F32_TOL, (arch, row["float32_max_abs_err_over_row_max"])
    return row


def records_only_merge(torch) -> dict:
    """Three internvl2-2b and three seamless-m4t-medium variants at full
    width (``lm_zoo``'s recipe: trunk + 0.005 N(0, 1), heads + 1.0), every
    trunk column of the six merged in one ``ParamStore`` through the
    adapters' ``records`` and ``enumerate_groups``.  Gate: for every member,
    ``adapter.accuracy`` on the store's tensors equals (bitwise) the
    accuracy on its merged tree built directly from the zoo (each shared
    column's donor tensor in place of the member's own)."""
    from repro_torch.bench.lm_merging import is_head
    from repro_torch.core import ParamStore, enumerate_groups
    from repro_torch.models.registry import get_adapter
    from repro_torch.utils.tree import flatten_paths, unflatten_paths

    members, zoo = {}, {}
    for arch in ("internvl2-2b", "seamless-m4t-medium"):
        family, cfg, _ = arch_config(arch)
        adapter = get_adapter(family)
        mids = tuple(f"{arch}@{v}" for v in RECORDS_ONLY_VARIANTS)
        for mid, params in lm_zoo(torch, adapter, cfg, mids=mids).items():
            members[mid] = (adapter, cfg)
            zoo[mid] = params
    store = ParamStore.from_models(zoo)
    unmerged = store.resident_bytes()
    recs = [r for m, (a, cfg) in members.items() for r in a.records(cfg, zoo[m], m)
            if not is_head(r.path)]
    groups = enumerate_groups(recs)
    flat = {m: flatten_paths(p) for m, p in zoo.items()}
    merged_trees = {m: dict(f) for m, f in flat.items()}
    shared = 0
    for g in groups:
        shared += len(store.merge_group(g))
        for col in g.columns():
            if len(col) >= 2:
                for r in col:
                    merged_trees[r.model_id][r.path] = flat[col[0].model_id][col[0].path]
    merged = store.resident_bytes()
    accuracy = {}
    for m, (adapter, cfg) in members.items():
        family = adapter.name
        toks, extra = arch_inputs(torch, family, cfg, seed=7)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        batch["patch_embeds" if family == "vlm" else "src_embeds"] = extra
        with torch.no_grad():
            a_store = float(adapter.accuracy(cfg, store.materialize(m), batch))
            a_tree = float(adapter.accuracy(cfg, unflatten_paths(merged_trees[m]), batch))
        assert a_store == a_tree, (m, a_store, a_tree)
        accuracy[m] = a_store
    cross = [g for g in groups if len({r.model_id.split("@")[0] for r in g.records}) > 1]
    return dict(members=list(members), groups=len(groups), shared_keys=shared,
                cross_arch_groups=len(cross), resident_bytes_unmerged=unmerged,
                resident_bytes_merged=merged, saved_bytes=unmerged - merged,
                accuracy_store_equals_merged_tree=True, accuracy=accuracy)


def arch_families_phase(torch) -> tuple:
    """Every architecture of ``configs.registry`` through the family call
    surface at full width (``arch_run``, depth ``ARCH_LAYERS``), each freed
    before the next; then the records-only families' merge
    (``records_only_merge``) and ``bench.lm_merging.pod_sizing``'s rows
    (host, meta tensors).  Returns (kernel launches, routes) summed over
    the ten runs."""
    from repro_torch.bench.lm_merging import pod_sizing
    from repro_torch.configs.registry import all_arch_ids

    t_phase = start_phase(torch, "arch_families")
    launches = collections.Counter()
    routes = collections.defaultdict(collections.Counter)
    runs = {}
    for i, arch in enumerate(all_arch_ids()):
        row = arch_run(torch, arch, seed=i)
        launches.update(row["launches"])
        for k, v in row["route_launches"].items():
            routes[k].update(v)
        runs[arch] = {k: row[k] for k in ("forward_ms", "prefill_ms", "decode_step_ms",
                                          "max_abs_err_over_row_max",
                                          "held_max_abs_err_over_row_max",
                                          "float32_max_abs_err_over_row_max",
                                          "argmax_agreement")}
        gc.collect()
        torch.cuda.empty_cache()
    for name in ("flash_attention", "decode_attention", "mamba_scan", "rg_lru_scan"):
        assert launches[name] > 0, (name, launches)
    t0 = time.perf_counter()
    merge = records_only_merge(torch)
    emit("arch_families_records_merge", **merge, seconds=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows = pod_sizing()
    emit("arch_families_pod_sizing", rows=rows, seconds=time.perf_counter() - t0)
    emit("phase_end", name="arch_families", archs=runs, launches=dict(launches),
         seconds=time.perf_counter() - t_phase)
    return dict(launches), {k: dict(v) for k, v in routes.items()}


# ---------------------------------------------------------------------------
# phase 11: the training tier (checkpoints, Trainer, the train launcher)
# ---------------------------------------------------------------------------


def restored_lanes(torch, adapter, cfg, eng, store) -> tuple:
    """The same 24 requests served, then 6 stream-decoded (chunked prefill,
    paged; 2 a member, 16 new tokens), through ``eng`` and through a fresh
    engine on ``store``.  Returns (rows and tokens and logits of both
    lanes, the fresh engine's kernel launches and routes)."""
    from repro_torch.kernels import ops

    lanes = []
    for name, engine in (("before", eng), ("restored", None)):
        if engine is None:
            engine = make_engine(adapter, cfg, store, LM_MIDS, int(16e9))
            ops.reset_kernel_launches()
        _, reqs = lm_requests(torch, cfg, LM_MIDS, seed=300)
        for r in reqs:
            engine.submit(r)
        stats = engine.serve(horizon_s=600.0, warmup=reqs[0].payload)
        assert stats["completed"] == len(reqs), stats
        res = {id(c.request): c.result for c in engine.completions}
        dreqs = decode_requests(cfg, 2, 301, 16)
        dstats = engine.serve_decode(dreqs, horizon_s=600.0, record_logits=True, **DECODE_KW)
        assert dstats["completed"] == len(dreqs) and dstats["pool_identity_ok"], dstats
        done = {id(c.request): c for c in engine.last_decoder.completions}
        lanes.append(dict(rows=[res[id(r)] for r in reqs],
                          tokens=[done[id(r)].tokens for r in dreqs],
                          logits=[done[id(r)].logits for r in dreqs]))
    return lanes, ops.kernel_launches(), ops.route_launches()


def stablelm_ckpt_phase(torch, adapter, cfg, store, eng) -> tuple:
    """Phase 6's merged full-width stablelm-1.6b group through the
    checkpoint manager (``stablelm_ckpt``): an unmerged copy of the same
    members (each member's trees, one buffer a key) and the merged store
    ``save_store``d into one directory with ``keep=1`` (the unmerged one
    GC'd), the merged one restored onto the card, a fresh engine built on
    it; the same requests served and stream-decoded through the engine
    before the save and the fresh one.  Gates: bindings and buffers
    bitwise, served rows, decode tokens and logits bitwise (max difference
    0.0), bank, flash, gather and decode-attention launched in the restored
    lanes, the merged file within 1% of ``resident_bytes()``.  The restore
    reads a file just written, so its read is warm in the page cache.
    Returns the restored lanes' (kernel launches, routes)."""
    import os
    import shutil
    import tempfile

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.core import ParamStore

    t_phase = start_phase(torch, "stablelm_ckpt")
    directory = tempfile.mkdtemp(prefix="stablelm_ckpt_")
    try:
        free = shutil.disk_usage(directory).free
        mgr = CheckpointManager(directory, keep=1)
        unmerged = ParamStore.from_models({m: store.materialize(m) for m in LM_MIDS})
        seconds = {}
        for step, name, s in ((1, "unmerged", unmerged), (2, "merged", store)):
            t0 = time.perf_counter()
            mgr.save_store(s, step=step)
            seconds[f"save_{name}_s"] = time.perf_counter() - t0
            seconds[f"{name}_file_bytes"] = os.path.getsize(mgr._path(step))
            seconds[f"{name}_resident_bytes"] = s.resident_bytes()
        del unmerged
        kept = mgr.all_steps()
        assert kept == [2] and mgr.latest_step() == 2, kept
        t0 = time.perf_counter()
        restored, extra = mgr.restore_store(device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        assert extra is None and restored.bindings == store.bindings
        assert restored.resident_bytes() == store.resident_bytes()
        assert restored.buffers.keys() == store.buffers.keys()
        assert all(torch.equal(restored.buffers[k], v) for k, v in store.buffers.items())
        merged_ratio = seconds["merged_file_bytes"] / seconds["merged_resident_bytes"]
        assert abs(merged_ratio - 1) < 0.01, seconds
        (before, after), launches, routes = restored_lanes(torch, adapter, cfg, eng, restored)
        worst = 0.0
        for key in ("rows", "tokens", "logits"):
            for a, b in zip(before[key], after[key]):
                if key == "rows":
                    worst = max(worst, (a.float() - b.float()).abs().max().item())
                    assert torch.equal(a, b), key
                elif key == "logits":
                    worst = max(worst, max(float(abs(x - y).max()) for x, y in zip(a, b)))
                    assert all((x == y).all() for x, y in zip(a, b)), key
                else:
                    assert list(a) == list(b), key
        for name in ("bank_matmul", "flash_attention", "page_gather", "decode_attention"):
            assert launches[name] > 0, launches
        tensor_core_routes_only(routes)
        emit("stablelm_ckpt", config=cfg.name, layers=cfg.n_layers, disk_free_bytes=free,
             **seconds, merged_file_over_resident=merged_ratio,
             merged_over_unmerged_file=seconds["merged_file_bytes"]
             / seconds["unmerged_file_bytes"],
             restore_s=restore_s, restore_read="warm (file just written)", keep=1,
             all_steps_after_gc=kept, served_rows=len(before["rows"]),
             decoded_requests=len(before["tokens"]), max_abs_diff_restored_vs_before=worst,
             launches=launches, route_launches=routes,
             seconds=time.perf_counter() - t_phase)
        del restored
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return launches, routes


# seamless_train: seamless-m4t-medium's widths whole, depth cut to 2 + 2 of
# its 12 + 12 layers; 4 sequences of 128 frames and 128 target tokens a
# step, two microbatches; 6 steps straight, or 3, a crash, and 3 resumed
SEAMLESS_LAYERS = 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, CRASH_AT = 4, 256, 6, 3


class StepLog:
    """A Trainer monitor that keeps every step's metrics."""

    def __init__(self):
        self.steps = []

    def tick(self, step: int, metrics: dict) -> None:
        self.steps.append(dict(step=step, loss=metrics["loss"], grad_norm=metrics["grad_norm"],
                               step_ms=metrics["step_time"] * 1e3))


def seamless_train_phase(torch) -> None:
    """``Trainer.fit`` at full seamless-m4t-medium width
    (``seamless_train``): AdamW under ``warmup_cosine``, 2 microbatches,
    int8 gradient compression with error feedback, the heartbeat and
    straggler monitors; batches from ``launch.train.batches`` (LMStream
    tokens, frame embeddings from a generator seeded by the step, on the
    card).  6 steps straight, then 3 with a checkpoint at step 3, a
    "crash", and a fresh Trainer resuming from it to step 6 on the batches
    from step 3 on.  Gates: the resumed params, moments, error feedback and
    history equal the straight run's bitwise; no kernel launched (the
    encdec loss calls none).  Then ``launch.train.main`` on ``cuda``:
    seamless-m4t-medium's smoke config with a checkpoint directory, 2
    microbatches and compression, which runs; stablelm-1.6b's, which must
    raise the kernels' no-backward error before its first step."""
    import itertools
    import os
    import shutil
    import tempfile

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs import seamless_m4t_medium
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import encdec
    from repro_torch.runtime.monitors import HeartbeatMonitor, StragglerMonitor
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils.tree import flatten_paths, leaf_bytes

    t_phase = start_phase(torch, "seamless_train")
    full = seamless_m4t_medium.full_config()
    cfg = dataclasses.replace(full, n_enc_layers=SEAMLESS_LAYERS, n_dec_layers=SEAMLESS_LAYERS)
    params = encdec.init(cfg, seed=0, device="cuda")

    @dataclasses.dataclass
    class Timed(CheckpointManager):
        """The manager with its last save's and restore's seconds."""

        timings: dict = dataclasses.field(default_factory=dict)

        def save(self, state, step):
            t0 = time.perf_counter()
            out = super().save(state, step)
            self.timings["save_s"] = time.perf_counter() - t0
            return out

        def restore(self, step, device=None, shardings=None):
            t0 = time.perf_counter()
            out = super().restore(step, device, shardings)
            torch.cuda.synchronize()
            self.timings["restore_s"] = time.perf_counter() - t0
            return out

    def fit(steps: int, start: int, mgr=None, ckpt_every: int = CRASH_AT):
        log = StepLog()
        data = itertools.islice(
            launch_train.batches(cfg, "encdec", TRAIN_BATCH, TRAIN_SEQ, torch.device("cuda")),
            start, None)
        tr = Trainer(lambda p, b: encdec.loss_fn(cfg, p, b),
                     AdamW(lr=warmup_cosine(3e-4, 2, TRAIN_STEPS)), microbatches=2,
                     compress_grads=True, ckpt_manager=mgr, ckpt_every=ckpt_every,
                     monitors=(HeartbeatMonitor(1), StragglerMonitor(), log))
        out = tr.fit(params, data, steps, log_every=1)
        torch.cuda.synchronize()
        return out, log.steps

    directory = tempfile.mkdtemp(prefix="seamless_train_")
    try:
        ops.reset_kernel_launches()
        torch.cuda.reset_peak_memory_stats()
        straight, straight_log = fit(TRAIN_STEPS, 0)
        peak = torch.cuda.max_memory_allocated()
        mgr = Timed(directory)
        fit(CRASH_AT, 0, mgr)  # the crash: nothing runs after step 3
        ckpt_bytes = os.path.getsize(mgr._path(CRASH_AT))
        # a fresh Trainer and manager; it restores, and saves no more
        resumer = Timed(directory)
        resumed, resumed_log = fit(TRAIN_STEPS, CRASH_AT, resumer, ckpt_every=TRAIN_STEPS + 1)
        assert resumer.all_steps() == [CRASH_AT], resumer.all_steps()
        assert [h["step"] for h in resumed["history"]] == list(range(CRASH_AT, TRAIN_STEPS))
        assert resumed["history"] == straight["history"][CRASH_AT:], \
            (resumed["history"], straight["history"])
        a, b = straight["state"], resumed["state"]
        assert a["step"] == b["step"] == TRAIN_STEPS and a["opt"].step == b["opt"].step
        mismatched = [f"{tree}/{k}" for tree, (ta, tb) in
                      {"params": (a["params"], b["params"]), "mu": (a["opt"].mu, b["opt"].mu),
                       "nu": (a["opt"].nu, b["opt"].nu), "err": (a["err"], b["err"])}.items()
                      for k, v in flatten_paths(ta).items()
                      if not torch.equal(v, flatten_paths(tb)[k])]
        assert not mismatched, mismatched[:8]
        assert not any(ops.kernel_launches().values()), ops.kernel_launches()
        state_bytes = sum(leaf_bytes(v) for tree in (a["params"], a["opt"].mu, a["opt"].nu,
                                                     a["err"])
                          for v in flatten_paths(tree).values())
        emit("seamless_train", config=cfg.name,
             layers=dict(encoder=cfg.n_enc_layers, decoder=cfg.n_dec_layers),
             published_layers=dict(encoder=full.n_enc_layers, decoder=full.n_dec_layers),
             d_model=cfg.d_model, vocab=cfg.vocab_size, dtype=cfg.dtype,
             batch=TRAIN_BATCH, frames=TRAIN_SEQ // 2, target_tokens=TRAIN_SEQ // 2,
             microbatches=2, compress_grads=True, steps=straight_log, resumed_steps=resumed_log,
             peak_memory_bytes_straight=peak, state_bytes=state_bytes, checkpoint_bytes=ckpt_bytes,
             save_s=mgr.timings["save_s"], restore_s=resumer.timings["restore_s"],
             restore_read="warm (file just written)", resume_bitwise=True,
             kernel_launches=dict(ops.kernel_launches()))
        del straight, resumed, a, b
        shutil.rmtree(directory)
        os.makedirs(directory)

        t0 = time.perf_counter()
        out = launch_train.main(["--arch", "seamless-m4t-medium", "--device", "cuda",
                                 "--steps", "6", "--ckpt-every", "3", "--microbatches", "2",
                                 "--compress-grads", "--ckpt-dir", directory])
        assert out["state"]["step"] == 6 and CheckpointManager(directory).all_steps() == [3, 6]
        launcher_s = time.perf_counter() - t0
        before = dict(ops.kernel_launches())
        try:
            launch_train.main(["--arch", "stablelm-1.6b", "--device", "cuda", "--steps", "2"])
        except RuntimeError as e:
            refusal = str(e)
        else:
            raise AssertionError("launch.train trained stablelm-1.6b through the kernels")
        assert "no backward" in refusal and ops.kernel_launches() == before, refusal
        emit("seamless_train_launcher", smoke_history=out["history"], launcher_s=launcher_s,
             stablelm_refused=refusal, seconds=time.perf_counter() - t_phase)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 12: the four serving examples, the dry run and its count on the card
# ---------------------------------------------------------------------------


def rows_vs_forward(torch, adapter, cfg, store, completions) -> float:
    """Largest |difference| of every served row from the member's direct
    forward on the request's own payload, held at float32's 1e-5."""
    worst = 0.0
    for c in completions:
        want = adapter.forward(cfg, store.materialize(c.request.instance_id),
                               c.request.payload)[0].float()
        got = c.result.float()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        worst = max(worst, (got - want).abs().max().item())
    return worst


def drift_on_changed_labels(torch, ex) -> dict:
    """``drift_and_revert.run`` where the drift is certain: A's frames
    labelled with A's own predictions (accuracy 1), B's with a class B's
    model never predicts for them (accuracy 0), the label function changed."""
    from repro_torch.data.synthetic import VisionStream
    from repro_torch.models import vision as VI

    pa = VI.init_small_cnn(ex.CFG, seed=0, device="cuda")
    pb = VI.init_small_cnn(ex.CFG, seed=1, device="cuda")
    frames = {m: VisionStream(4, 64, seed=s, device="cuda").batch_at(0)
              for m, s in (("A", 0), ("B", 999))}
    with torch.no_grad():
        pred_a = VI.small_cnn_forward(ex.CFG, pa, frames["A"]["images"]).argmax(-1)
        pred_b = VI.small_cnn_forward(ex.CFG, pb, frames["B"]["images"]).argmax(-1)
    frames["A"] = dict(frames["A"], labels=pred_a.to(frames["A"]["labels"].dtype))
    frames["B"] = dict(frames["B"], labels=((pred_b + 1) % ex.CFG.n_classes).to(
        frames["B"]["labels"].dtype))
    return ex.run(ex.CFG, pa, pb, frames)


def examples_phase(torch) -> tuple:
    """``repro_torch.examples``' four serving examples on the card at their
    own sizes, each through its ``main(["--device", "cuda"])``
    (``examples_<name>`` lines: what each prints, and its wall seconds).
    Gates: merge_and_serve's 40 engine requests served and every served row
    (both lanes) against the member's direct forward (float32, 1e-5);
    cloud_edge_plan's one epoch bump with 9 queued requests kept and
    served, rows the same; drift_and_revert's own draws reported, then the
    same run with the drift made certain (``drift_on_changed_labels``): B
    breached and reverted, A kept; ``bank_matmul`` launched (the engines'
    float32 heads, the ``simt`` route).  quickstart pretrains and retrains
    under deterministic cuDNN, as ``small_cnn_retrain``."""
    from repro_torch.examples import cloud_edge_plan, drift_and_revert, merge_and_serve, quickstart
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_adapter

    t_phase = start_phase(torch, "examples")
    ops.reset_kernel_launches()
    adapter = get_adapter("small_cnn")
    cfg = adapter.default_config()

    t0 = time.perf_counter()
    out = merge_and_serve.main(["--device", "cuda"])
    torch.cuda.synchronize()
    real = out["real"]
    err = max(rows_vs_forward(torch, adapter, cfg, real["store"], real["engine_completions"]),
              rows_vs_forward(torch, adapter, cfg, real["store"],
                              real["per_request_completions"]))
    assert real["engine"]["completed"] == 40, real["engine"]
    emit("examples_merge_and_serve", simulated=out["simulated"], per_request=real["per_request"],
         engine={k: v for k, v in real["engine"].items() if not isinstance(v, dict)},
         max_abs_err_vs_forward=err, seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    out = cloud_edge_plan.main(["--device", "cuda"])
    torch.cuda.synchronize()
    edge = out["edge"]
    err = rows_vs_forward(torch, cloud_edge_plan.ADAPTER, cloud_edge_plan.CFG, edge["store"],
                          edge["engine"].completions)
    assert (edge["epoch_bumps"], edge["pending_requests"]) == (1, 9), edge
    assert edge["stats"]["completed"] == 9, edge["stats"]
    emit("examples_cloud_edge_plan", cloud=out["cloud"],
         shared_keys=len(edge["shared_keys"]), epoch_bumps=edge["epoch_bumps"],
         pending_requests=edge["pending_requests"],
         resident_bytes=[edge["resident_bytes_before"], edge["resident_bytes_after"]],
         prefix_groups_after=edge["prefix_groups_after"], served=edge["stats"]["completed"],
         max_abs_err_vs_forward=err, seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    own = drift_and_revert.main(["--device", "cuda"])
    certain = drift_on_changed_labels(torch, drift_and_revert)
    assert certain["breached"] == certain["reverted"] == {"B"}, certain
    assert certain["shared_after"] < certain["shared_before"], certain
    emit("examples_drift_and_revert",
         own_draws={k: sorted(v) if isinstance(v, set) else v for k, v in own.items()},
         changed_labels={k: sorted(v) if isinstance(v, set) else v
                         for k, v in certain.items()},
         seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        out = quickstart.main(["--device", "cuda"])
    torch.cuda.synchronize()
    emit("examples_quickstart", **out, seconds=time.perf_counter() - t0)

    launches, routes = ops.kernel_launches(), ops.route_launches()
    assert launches["bank_matmul"] > 0, launches
    assert routes["bank_matmul"]["wgmma"] == 0, routes  # float32 heads: simt
    emit("phase_end", name="examples", launches=launches, route_launches=routes,
         seconds=time.perf_counter() - t_phase)
    return launches, routes


# the dry run's cells run on the card's host (meta tensors): every
# architecture's decode_32k on the single-pod mesh, stablelm-1.6b's
# train_4k and prefill_32k
DRYRUN_CELLS = [(a, "decode_32k", "single") for a in (
    "deepseek-moe-16b", "falcon-mamba-7b", "internvl2-2b", "olmo-1b", "olmoe-1b-7b",
    "qwen2-72b", "qwen3-14b", "recurrentgemma-9b", "seamless-m4t-medium", "stablelm-1.6b")] + [
    ("stablelm-1.6b", "train_4k", "single"), ("stablelm-1.6b", "prefill_32k", "single")]


def dryrun_phase(torch) -> None:
    """``launch.dryrun`` in this process over ``DRYRUN_CELLS`` (their JSON
    under ``artifacts/torch/dryrun``), then ``bench.roofline.run()`` over
    what the dry run holds there (``dryrun_cell`` lines: flops, bytes and
    peak per device, the dominant term and the cell's seconds).  Gate:
    every cell ok, each one's roofline row present."""
    from repro_torch.bench import roofline
    from repro_torch.launch import dryrun

    t_phase = start_phase(torch, "dryrun")
    cells = {}
    for arch, shape, mesh in DRYRUN_CELLS:
        res = dryrun.run_and_write(arch, shape, mesh, out=dryrun.DEFAULT_OUT)
        assert res["ok"], res["error"]
        cells[(arch, shape, mesh)] = res
    t0 = time.perf_counter()
    rows = {(r["arch"], r["shape"], r["mesh"]): r for r in roofline.run()["rows"]}
    roofline_s = time.perf_counter() - t0
    for key, res in cells.items():
        row = rows[key]
        emit("dryrun_cell", arch=key[0], shape=key[1], mesh=key[2], kind=res["kind"],
             flops_per_device=res["flops_per_device"],
             bytes_per_device=res["bytes_per_device"],
             peak_bytes_estimate=res["peak_bytes_estimate"], op_calls=res["op_calls"],
             dominant=row["dominant"], compute_s=row["compute_s"], memory_s=row["memory_s"],
             seconds=res["seconds"])
    emit("phase_end", name="dryrun", cells=len(cells), roofline_s=roofline_s,
         seconds=time.perf_counter() - t_phase)


# dryrun_card: stablelm-1.6b at full width on the card, the batch cut to
# fit one card (the cells' 32 and 128 rows would hold 206 GB and 824 GB
# of KV cache)
CARD_PREFILL = dict(seq_len=32768, batch=1)
CARD_DECODE = dict(seq_len=32768, batch=4)


def _tree_meta(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _tree_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_meta(v) for v in tree)
    return (tuple(tree.shape), str(tree.dtype)) if isinstance(tree, torch.Tensor) else tree


def _storage_bytes(*trees) -> int:
    import torch
    from torch.utils._pytree import tree_flatten

    seen = {}
    for t in tree_flatten(trees)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def profile_call(torch, fn, args, reset=None) -> dict:
    """One more call of ``fn`` under ``torch.profiler``: device busy ms,
    the device's idle share of the profiled wall, the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    if reset is not None:
        reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del out
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in rows)
    return dict(wall_ms_profiled=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
                top_kernels=[dict(name=n[:90], ms=ms, share=ms / busy_ms, calls=k)
                             for n, ms, k in sorted(rows, key=lambda r: -r[1])[:6]])


def card_count_check(torch, name, fn, meta_args, card_args, reset=None, reps: int = 3) -> dict:
    """``fn`` traced on ``meta_args`` (``launch.dryrun.trace``) and run on
    ``card_args``: argument bytes equal, output shapes and dtypes equal,
    the warm time (CUDA events, the mean of ``reps`` calls, ``reset()``
    before each) at least the roofline bound of the trace's flops and
    bytes; the trace's peak beside ``torch.cuda.max_memory_allocated``."""
    from repro_torch.bench import roofline
    from repro_torch.launch.dryrun import trace
    from repro_torch.kernels import ops

    tr = trace(fn, *meta_args)
    card_arg_bytes = _storage_bytes(card_args)
    assert tr.argument_bytes == card_arg_bytes, (name, tr.argument_bytes, card_arg_bytes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_kernel_launches()
    with torch.no_grad():
        if reset is not None:
            reset()
        out = fn(*card_args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        one_call = ops.kernel_launches()
        assert _tree_meta(out) == _tree_meta(tr.out), (name, _tree_meta(out), _tree_meta(tr.out))
        del out
        times = []
        for _ in range(reps):
            if reset is not None:
                reset()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*card_args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            del out
        profiled = profile_call(torch, fn, card_args, reset)
    ms = sum(times) / len(times)
    compute_ms = tr.flops / roofline.PEAK_FLOPS * 1e3
    memory_ms = tr.bytes / roofline.HBM_BW * 1e3
    bound_ms = max(compute_ms, memory_ms)
    row = dict(flops=tr.flops, bytes=tr.bytes, argument_bytes=tr.argument_bytes,
               argument_bytes_exact=True, op_calls=tr.op_calls,
               compute_ms=compute_ms, memory_ms=memory_ms, bound_ms=bound_ms,
               bound_by="operations" if compute_ms >= memory_ms else "bytes",
               ms=ms, ms_each=times, share_of_bound=bound_ms / ms,
               trace_peak_live_bytes=tr.peak_live_bytes, card_max_memory_allocated=peak,
               card_allocated_before=base, launches_one_call=one_call, profiled=profiled)
    emit(f"dryrun_card_{name}", **row)
    assert bound_ms <= ms, (name, bound_ms, ms)
    # every call's launches (1 + reps), as every other phase counts its runs
    return row, ops.kernel_launches(), ops.route_launches()


def dryrun_card_phase(torch) -> tuple:
    """The dry run's count held against the card (``dryrun_card``):
    full-width stablelm-1.6b (24 layers, d 2048, vocab 100352, bf16), one
    prefill of 1 x 32768 tokens and one decode step of 4 rows against a
    32768-slot cache filled to its last slot, each traced on meta tensors
    and run for real through the kernels (``card_count_check``).  Gates:
    argument bytes exact, outputs' shapes and dtypes equal, each warm time
    at least its bound (a share over 100% would mean the count is wrong),
    flash and decode_attention launched; the decode also at least the
    weights' read at the memory rate (``anchor_ms``)."""
    from repro_torch.bench import roofline
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.configs.base import ShapeSpec, cache_specs
    from repro_torch.launch.dryrun import cell_call
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_family
    from repro_torch.utils.tree import flatten_paths

    t_phase = start_phase(torch, "dryrun_card")
    cfg = stablelm_1_6b.full_config()
    fam = get_family("dense")
    meta_params = fam.init(cfg, 0, device="meta")
    params = fam.init(cfg, 0, device="cuda")
    weight_bytes = sum(nbytes(t) for t in flatten_paths(params).values())
    gen = torch.Generator(device="cuda").manual_seed(5)
    launches = collections.Counter()
    routes = collections.defaultdict(collections.Counter)
    rows = {}

    S, B = CARD_PREFILL["seq_len"], CARD_PREFILL["batch"]
    shape = ShapeSpec("prefill_32k", S, B, "prefill")
    fn, _ = cell_call(fam, "dense", cfg, shape)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda",
                         dtype=torch.int32)
    rows["prefill"], run, run_routes = card_count_check(
        torch, "prefill", fn, (meta_params, torch.empty((B, S), dtype=torch.int32,
                                                         device="meta")), (params, toks))
    launches.update(run)
    for k, v in run_routes.items():
        routes[k].update(v)
    del toks
    torch.cuda.empty_cache()

    S, B = CARD_DECODE["seq_len"], CARD_DECODE["batch"]
    shape = ShapeSpec("decode_32k", S, B, "decode")
    fn, _ = cell_call(fam, "dense", cfg, shape)
    cache = transformer.init_cache(cfg, B, S, device="cuda")
    for leaf in (cache["k"], cache["v"]):  # a filled cache: values of the model's scale
        for i in range(leaf.shape[0]):
            leaf[i].normal_(generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device="cuda",
                         dtype=torch.int32)
    meta_cache = cache_specs(cfg, "dense", shape)
    rows["decode"], run, run_routes = card_count_check(
        torch, "decode", fn,
        (meta_params, meta_cache, torch.empty((B, 1), dtype=torch.int32, device="meta")),
        (params, cache, toks), reset=lambda: cache["length"].fill_(S - 1), reps=5)
    launches.update(run)
    for k, v in run_routes.items():
        routes[k].update(v)
    anchor_ms = weight_bytes / roofline.HBM_BW * 1e3
    assert rows["decode"]["ms"] >= anchor_ms, (rows["decode"]["ms"], anchor_ms)
    assert launches["flash_attention"] > 0 and launches["decode_attention"] > 0, launches
    del cache, toks, params
    gc.collect()
    torch.cuda.empty_cache()
    emit("phase_end", name="dryrun_card", weight_bytes=weight_bytes, anchor_ms=anchor_ms,
         prefill=dict(batch=CARD_PREFILL["batch"], seq_len=CARD_PREFILL["seq_len"],
                      share=rows["prefill"]["share_of_bound"]),
         decode=dict(batch=CARD_DECODE["batch"], seq_len=CARD_DECODE["seq_len"],
                     share=rows["decode"]["share_of_bound"]),
         cut="batch 32 -> 1 (prefill), 128 -> 4 (decode); widths and 24 layers whole",
         launches=dict(launches), seconds=time.perf_counter() - t_phase)
    return dict(launches), {k: dict(v) for k, v in routes.items()}


def full_precision_matmuls(torch) -> None:
    """float32 matmuls without TF32, bf16 ones with float32 reductions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build, ops

    full_precision_matmuls(torch)

    global EXP_PER_S
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    EXP_PER_S, sms, sm_mhz = exp_rate(torch)
    emit("device", name=kind, count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=smi, sms=sms, sm_clock_max_mhz=sm_mhz,
         exponentials_per_s=EXP_PER_S)
    print(smi, flush=True)

    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    ptxas = [line.strip() for log in _build.build_info.get("ptxas", {}).values()
             for line in log.splitlines() if "registers" in line or "spill" in line]
    spilling = [line for line in ptxas if "spill" in line and " 0 bytes spill stores" not in line]
    # tensor-core instructions in each kernel function of the built library
    sass = _build.sass_mma_counts(_build.library_path())
    mma = {kernel_name(name): c for name, c in sass.items()}
    emit("build", seconds=build_s, cached=_build.build_info["cached"],
         source_seconds=_build.build_info.get("source_seconds"), ptxas=ptxas,
         spilling=spilling, tensor_core_instructions=mma)
    assert not spilling, spilling
    assert any("bank_wgmma_kernel" in n and c["HGMMA"] > 0 for n, c in mma.items()), mma
    assert sum("flash_mma_kernel" in n and c["HMMA"] > 0 for n, c in mma.items()) == 4, mma

    from repro_torch.configs import falcon_mamba_7b, recurrentgemma_9b, stablelm_1_6b
    from repro_torch.models.registry import get_adapter

    t0 = start_phase(torch, "kernel_checks")
    ops.reset_kernel_launches()
    main_rows = kernel_checks(torch)
    # launches by route of the checks themselves (their timing's included):
    # routes that no main-path shape takes, rg_lru_scan's "plain", show here
    check_routes = ops.route_launches()
    emit("phase_end", name="kernel_checks", seconds=time.perf_counter() - t0,
         route_launches=check_routes)
    launches = collections.Counter()  # summed over every serve, decode and plan run
    route_totals = collections.defaultdict(collections.Counter)  # the same, by route

    def add(run_launches: dict, run_routes: dict) -> None:
        launches.update(run_launches)
        for name, r in run_routes.items():
            route_totals[name].update(r)

    t0 = start_phase(torch, "small_cnn_serve")
    add(*small_cnn_phase(torch))
    emit("phase_end", name="small_cnn_serve", seconds=time.perf_counter() - t0)
    start_phase(torch, "paper_sim")
    paper_sim_phase()
    # (line prefix, family, config, engine capacity, kernels the serve must
    # launch, kernels the streaming decode must launch, decoder knobs)
    runs = [
        ("stablelm", "dense", stablelm_1_6b.full_config(), int(16e9),
         ("bank_matmul", "flash_attention"), ("page_gather", "decode_attention", "bank_matmul"),
         DECODE_KW),
        ("falcon_mamba", "ssm", falcon_mamba_7b.full_config(), int(32e9),
         ("mamba_scan", "bank_matmul"), ("mamba_scan", "bank_matmul"), DECODE_KW),
        ("recurrentgemma", "hybrid", recurrentgemma_9b.full_config(), int(32e9),
         ("rg_lru_scan", "flash_attention"), ("rg_lru_scan",), RGEMMA_DECODE_KW),
    ]
    for prefix, family, full, capacity, serve_expect, decode_expect, knobs in runs:
        cfg = cut_depth(full, FAMILY_LAYERS[prefix])
        adapter = get_adapter(family)
        store, built = lm_build(torch, prefix, adapter, cfg)
        built["published_layers"] = full.n_layers
        # GEMEL against time/space sharing, on stablelm: the time-shared
        # lanes on the unmerged store, the engine lane after the merge
        timeshare = prefix == "stablelm"
        if timeshare:
            merged_expected, swap_capacity = timeshare_capacity(adapter, cfg, store)
            ts_lane, *run = timeshare_serve(torch, adapter, cfg, store, swap_capacity)
            add(*run)
            ts_decode, *run = timeshare_decode(torch, adapter, cfg, store, swap_capacity)
            add(*run)
        serve_launches, routes, eng = lm_merge_and_serve(torch, prefix, adapter, cfg, store,
                                                         built, capacity, serve_expect)
        add(serve_launches, routes)
        if timeshare:  # the capacity was set from the merge's predicted bytes
            assert store.resident_bytes() == merged_expected, \
                (store.resident_bytes(), merged_expected)
            add(*timeshare_engine(torch, adapter, cfg, store, swap_capacity, ts_lane))
        decode_launches, routes, dstats = decode_phase(torch, prefix, eng, cfg, decode_expect,
                                                       knobs)
        add(decode_launches, routes)
        if timeshare:  # reported beside the JAX package's own gate (scripts/ci.sh), not held to it
            emit(f"{prefix}_timeshare_decode_speedup",
                 streaming_tokens_per_s=dstats["tokens_per_s"],
                 per_request_tokens_per_s=ts_decode["tokens_per_s"],
                 decode_speedup=dstats["tokens_per_s"] / ts_decode["tokens_per_s"],
                 reference_gate=">= 2.0", asserted=False)
            # the merged group through the checkpoint manager and back
            add(*stablelm_ckpt_phase(torch, adapter, cfg, store, eng))
        del eng, store  # the next family's start_phase frees this one's store
    add(*stablelm_plan_phase(torch, dataclasses.replace(stablelm_1_6b.full_config(),
                                                        n_layers=PLAN_LAYERS), int(16e9)))
    *run, lm_scn, lm_plan = stablelm_lm_serve_phase(torch, stablelm_1_6b.full_config())
    add(*run)
    add(*stablelm_decode_serve_phase(torch, lm_scn, lm_plan))
    del lm_scn, lm_plan, run
    add(*stablelm_sharded_phase(torch, cut_depth(stablelm_1_6b.full_config(),
                                                 FAMILY_LAYERS["stablelm"])))
    *run, drift_loop = stablelm_drift_phase(torch, dataclasses.replace(
        stablelm_1_6b.full_config(), n_layers=DRIFT_LAYERS))
    add(*run)
    add(*stablelm_swap_failure_phase(torch, drift_loop))
    del drift_loop, run
    add(*small_cnn_lifecycle_phases(torch))
    add(*host_bench_phases(torch))
    add(*lm_bench_defaults_phase(torch))
    t0 = start_phase(torch, "paper_benches")
    paper_benches_phase()
    emit("phase_end", name="paper_benches", seconds=time.perf_counter() - t0)
    add(*fig7_phase(torch))
    add(*stablelm_plan_wire_phase(torch, stablelm_1_6b.full_config()))
    add(*mixed_zoo_phase(torch))
    add(*mixed_zoo_full_phase(torch))
    add(*arch_families_phase(torch))
    seamless_train_phase(torch)
    t0 = start_phase(torch, "small_cnn_retrain")
    small_cnn_retrain_phase(torch)
    emit("phase_end", name="small_cnn_retrain", seconds=time.perf_counter() - t0)
    add(*examples_phase(torch))
    dryrun_phase(torch)
    add(*dryrun_card_phase(torch))
    assert all(launches[name] > 0 for name in main_rows), launches
    # rg_lru_scan: serves take "scan", decodes "step"; "plain" only in the checks
    rg_routes = route_totals["rg_lru_scan"]
    assert rg_routes["scan"] > 0 and rg_routes["step"] > 0, rg_routes
    assert check_routes["rg_lru_scan"]["plain"] > 0, check_routes

    kernels = []
    for name, row in main_rows.items():
        spec = ops.OP_TABLE[name]
        kernels.append(dict(name=name, route="cuda", source=spec.source, replaces=spec.replaces,
                            cuda_route=row.get("route", "cuda"),
                            launches_by_route=dict(route_totals.get(name, {})) or None,
                            check_launches_by_route=check_routes.get(name),
                            launches=launches[name], max_abs_err=row["max_abs_err"],
                            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
