#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and the script
exits non-zero):

1. device: name, count, torch version and the card's power limit;
2. build: compiles the hand-written CUDA kernels from ``kernels/csrc``;
3. kernels: each Hopper kernel against its plain PyTorch version on the
   card at the main path's shapes and a few edge shapes, with kernel, plain,
   library and bound times;
4. small_cnn merge-and-serve: two members, trunk merged, through
   ``MergeAwareEngine``; completions against direct forwards;
5. stablelm-1.6b at full width: three fine-tune variants (shared base,
   trunk perturbed by 0.005, head by 1.0), every trunk group merged, 8
   requests of 128 tokens per member served through ``MergeAwareEngine``
   with the suffix bank; kernel launch counts, residency, and every served
   row against the member's direct forward on the same padded batch; then
   one more micro-batch under ``torch.profiler`` (device time by kernel,
   device idle share).

Then the ``{"kernels": [...]}`` line and, last, the device line.  Needs one
card; imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; fp32 non-tensor
# the JAX package's own kernel-test tolerances (tests/test_kernels.py TOL):
# float32 results differ only in summation order, bf16 ones also in where
# the final rounding lands
TOL = {"float32": dict(rtol=2e-3, atol=2e-3), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
BUCKETS = (1, 2, 4, 8)
REQS_PER_MEMBER = 8
LM_MIDS = ("lm-A", "lm-B", "lm-D")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, dtype: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_bank(torch, case: str, N, M, K, F, dtype, broadcast, bias, reps, gen):
    from repro_torch.kernels import bank_matmul as kmod
    from repro_torch.kernels.ref import bank_matmul_ref

    dt = getattr(torch, dtype)
    x = torch.randn((M, K) if broadcast else (N, M, K), generator=gen, device="cuda").to(dt)
    w = torch.randn((N, K, F), generator=gen, device="cuda").to(dt)
    b = torch.randn((N, F), generator=gen, device="cuda").to(dt) if bias else None
    out = kmod.bank_matmul(x, w, b)
    torch.cuda.synchronize()
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
    ops = 2.0 * N * M * K * F + (N * M * F if bias else 0)
    bound_ms, bound_by = bound(nbytes(x, w, b, out), ops, dtype)
    row = dict(kernel="bank_matmul", case=case, shape=dict(N=N, M=M, K=K, F=F),
               dtype=dtype, broadcast=broadcast, bias=bias, max_abs_err=err,
               tol=TOL[dtype], ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    emit("kernel_check", **row)
    return row


def check_flash(torch, case: str, B, S, Hq, Hkv, D, dtype, window, reps, gen):
    import torch.nn.functional as Fn

    from repro_torch.kernels import flash_attention as kmod
    from repro_torch.kernels.ref import flash_attention_ref

    dt = getattr(torch, dtype)
    q = torch.randn((B, S, Hq, D), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dt)
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
    pairs = int(mask.sum().item())  # the (query, key) pairs this mask keeps
    ops = 4.0 * D * pairs * B * Hq  # QK^T and PV, 2 D operations each per pair
    bound_ms, bound_by = bound(nbytes(q, k, v, out), ops, dtype)
    row = dict(kernel="flash_attention", case=case, shape=dict(B=B, S=S, Hq=Hq, Hkv=Hkv, D=D),
               dtype=dtype, window=window, max_abs_err=err, tol=TOL[dtype], ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    emit("kernel_check", **row)
    return row


def kernel_checks(torch) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    main = {}
    # stablelm-1.6b head: 3 members, bucket 8 x 128 tokens, d 2048, vocab 100352
    main["bank_matmul"] = check_bank(torch, "stablelm-head", 3, 1024, 2048, 100352,
                                     "bfloat16", False, False, 5, gen)
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
    return main


# ---------------------------------------------------------------------------
# phase 4: small_cnn merge-and-serve
# ---------------------------------------------------------------------------


def merge_trunk(adapter, cfg, store, mids) -> int:
    from repro_torch.core import enumerate_groups

    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m in mids for r in adapter.records(cfg, store.materialize(m), m)
            if r.path in trunk]
    return sum(len(store.merge_group(g)) for g in enumerate_groups(recs))


def make_engine(adapter, cfg, store, mids, capacity_bytes):
    from repro_torch.serving.costs import costs_for
    from repro_torch.serving.executor import MergeAwareEngine, ModelProgram
    from repro_torch.serving.workload import instances_from_store

    programs = [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in mids]
    return MergeAwareEngine(
        store, instances_from_store(store, "tiny-yolo", model_ids=list(mids)),
        programs, capacity_bytes=capacity_bytes,
        costs={"tiny-yolo": costs_for("tiny-yolo")}, buckets=BUCKETS,
        simulate_dma=False)


def interleaved_requests(mids, make_payload):
    """REQS_PER_MEMBER requests per member; deadlines interleave the members
    round-robin, so every EDF micro-batch carries rows of every member."""
    from repro_torch.serving.executor import Request

    return [Request(m, make_payload(), 0.0, 10.0 + (j * len(mids) + i) * 1e-3)
            for j in range(REQS_PER_MEMBER) for i, m in enumerate(mids)]


def served_vs_direct(torch, adapter, cfg, store, eng, reqs, dtype) -> float:
    """Max abs error of every served row against the member's direct
    forward on the same padded batch (micro-batches rebuilt in EDF order —
    a group drains in one visit, so they are the engine's own)."""
    from repro_torch.serving.workload import deadline_microbatches, pad_stack

    res = {id(c.request): c.result for c in eng.completions}
    worst = 0.0
    for mb in deadline_microbatches(reqs, BUCKETS):
        batch, _ = pad_stack([r.payload for r in mb.requests], mb.bucket)
        direct = {m: adapter.forward(cfg, store.materialize(m), batch)
                  for m in {r.instance_id for r in mb.requests}}
        for j, r in enumerate(mb.requests):
            got, want = res[id(r)].float(), direct[r.instance_id][j].float()
            torch.testing.assert_close(got, want, **TOL[dtype])
            worst = max(worst, (got - want).abs().max().item())
        del direct
    return worst


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
    launches = ops.kernel_launches()
    err = served_vs_direct(torch, adapter, cfg, store, eng, reqs, "float32")
    assert stats["completed"] == len(reqs), stats
    assert launches["bank_matmul"] > 0, launches
    emit("small_cnn_serve", shared_keys=shared, stats=stats, launches=launches,
         max_abs_err_vs_forward=err, tol=TOL["float32"])


# ---------------------------------------------------------------------------
# phase 5: stablelm-1.6b at full width
# ---------------------------------------------------------------------------


def perturb(torch, params: dict, seed: int, scale: float, select) -> dict:
    """Gaussian-perturb the leaves whose path ``select`` accepts (others are
    passed through as the same tensors) — fine-tuning divergence without a
    training run, generated on the leaves' device."""
    from repro_torch.utils.tree import flatten_paths, unflatten_paths

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


def lm_zoo(torch, adapter, cfg) -> dict:
    """Three variants of one base: trunks perturbed by 0.005, heads by 1.0
    (the ``lm_zoo`` pattern of benchmarks/lm_merging.py)."""
    def is_head(p):
        return p.startswith(("final_norm/", "lm_head/"))

    base = adapter.init(cfg, seed=0, device="cuda")
    zoo = {LM_MIDS[0]: base}
    for i, mid in enumerate(LM_MIDS[1:]):
        v = perturb(torch, base, 2 * i + 1, 0.005, lambda p: not is_head(p))
        zoo[mid] = perturb(torch, v, 2 * i + 2, 1.0, is_head)
        del v
    return zoo


def stablelm_phase(torch) -> dict:
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.core import ParamStore
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_adapter
    from repro_torch.serving.workload import deadline_microbatches

    adapter = get_adapter("dense")
    cfg = stablelm_1_6b.full_config()
    t0 = time.perf_counter()
    store = ParamStore.from_models(lm_zoo(torch, adapter, cfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    unmerged = store.resident_bytes()
    shared = merge_trunk(adapter, cfg, store, LM_MIDS)
    merged = store.resident_bytes()
    torch.cuda.empty_cache()
    emit("stablelm_merge", config=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.padded_vocab, dtype=cfg.dtype, init_s=init_s, shared_keys=shared,
         resident_bytes_unmerged=unmerged, resident_bytes_merged=merged,
         saved_fraction=1 - merged / unmerged,
         device_allocated_bytes=torch.cuda.memory_allocated())

    eng = make_engine(adapter, cfg, store, LM_MIDS, int(16e9))
    gen = torch.Generator(device="cuda").manual_seed(100)
    reqs = interleaved_requests(LM_MIDS, lambda: torch.randint(
        0, cfg.vocab_size, (1, 128), generator=gen, device="cuda"))
    for r in reqs:
        eng.submit(r)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    stats = eng.serve(horizon_s=600.0, warmup=reqs[0].payload)
    serve_s = time.perf_counter() - t0
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    banked = sum(1 for mb in deadline_microbatches(reqs, BUCKETS)
                 if len({r.instance_id for r in mb.requests}) > 1)
    assert stats["completed"] == len(reqs), stats
    assert all(n > 0 for n in launches.values()), launches
    assert stats["suffix_dispatches"] == banked, (stats, banked)
    err = served_vs_direct(torch, adapter, cfg, store, eng, reqs, "bfloat16")
    emit("stablelm_serve", stats=stats, launches=launches,
         banked_microbatches=banked, suffix_dispatches_equal_banked=True,
         serve_wall_s_with_warmup=serve_s,
         wall_s_per_microbatch=stats["elapsed_s"] / max(stats["microbatches"], 1),
         peak_memory_bytes=peak, max_abs_err_vs_forward=err, tol=TOL["bfloat16"])
    profile_microbatch(torch, eng, cfg, gen, stats["elapsed_s"] / stats["microbatches"])
    return launches


def profile_microbatch(torch, eng, cfg, gen, served_wall_s: float) -> None:
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
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms in rows)
    top = sorted(rows, key=lambda r: -r[1])[:8]
    emit("stablelm_profile", microbatches=stats["microbatches"], wall_ms_profiled=wall_ms,
         device_busy_ms=busy_ms, device_idle_share_profiled=max(0.0, 1 - busy_ms / wall_ms),
         served_wall_ms_per_microbatch=served_wall_s * 1e3,
         device_idle_share=max(0.0, 1 - busy_ms / (served_wall_s * 1e3)),
         top_kernels=[dict(name=n[:90], ms=ms, share=ms / busy_ms) for n, ms in top])


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=smi)
    print(smi, flush=True)

    t0 = time.perf_counter()
    _build.load_library()
    ptxas = [line.strip() for log in _build.build_info.get("ptxas", {}).values()
             for line in log.splitlines() if "registers" in line or "spill" in line]
    emit("build", seconds=time.perf_counter() - t0, cached=_build.build_info["cached"],
         ptxas=ptxas)

    main_rows = kernel_checks(torch)
    small_cnn_phase(torch)
    launches = stablelm_phase(torch)

    kernels = []
    for name, row in main_rows.items():
        spec = ops.OP_TABLE[name]
        kernels.append(dict(name=name, route="cuda", source=spec.source, replaces=spec.replaces,
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
