#!/usr/bin/env python3
"""How the mamba_scan kernel's rounding reaches falcon-mamba-7b's decode
replay check, on one NVIDIA GPU.

    python3 chip_scan_numerics.py

``chip_smoke.py`` streams decode of a merged falcon-mamba-7b group at batch
8 and replays one request per member at batch 1 through the unpaged
decode; cuBLAS sums the trunk's GEMMs in another order at the two batch
sizes, and the replay check holds the streamed logits to the replay's at
2e-2 of the row maximum.  This script builds variants of
``kernels/csrc/mamba_scan.cu`` that differ only in the scan's rounding and,
for each, times the kernel at the falcon-mamba shapes and runs that decode
and replay (the check's statistics, nothing asserted):

* ``exact``: the kernel as shipped (expf; y summed in state order);
* ``ex2``: the decay as ``ex2.approx(dt * A * log2 e)``;
* ``tree``: y summed as four interleaved partial sums and a tree;
* ``ex2_tree``: both.

Each variant prints one JSON line; the last line is a summary.  Needs one
card and about 80 GB of its memory; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EXP_EXACT = "expf(__fmul_rn(dd, a[j]))"
EXP_APPROX = "ex2_approx(__fmul_rn(dd, a[j]))"
Y_EXACT = """            float acc = prev;
#pragma unroll
            for (int j = 0; j < SPL; ++j) acc = __fmaf_rn(h[j], cj[j], acc);
            yt = acc;"""
Y_TREE = """            float p4[4] = {prev, 0.f, 0.f, 0.f};
#pragma unroll
            for (int j = 0; j < SPL; ++j) p4[j % 4] = __fmaf_rn(h[j], cj[j], p4[j % 4]);
            yt = (p4[0] + p4[1]) + (p4[2] + p4[3]);"""
EX2_HELPER = """__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}
"""
VARIANTS = {"exact": (False, False), "ex2": (True, False), "tree": (False, True),
            "ex2_tree": (True, True)}


def variant_source(text: str, ex2: bool, tree: bool) -> str:
    assert text.count(EXP_EXACT) == 1 and text.count(Y_EXACT) == 1, \
        "mamba_scan.cu changed: update the patch anchors"
    if ex2:
        text = text.replace(EXP_EXACT, EXP_APPROX).replace("namespace {", EX2_HELPER
                                                           + "namespace {", 1)
    if tree:
        text = text.replace(Y_EXACT, Y_TREE)
    return text


def build_variants(lib) -> dict:
    """{name: ctypes function} of each variant's ``mamba_scan_launch``."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_ROOT / "scan_numerics"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "mamba_scan.cu").read_text()
    fns = {}
    for name, (ex2, tree) in VARIANTS.items():
        src, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        src.write_text(variant_source(text, ex2, tree))
        subprocess.run([_build.find_nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-shared", str(src), "-o", str(so)],
                       check=True, capture_output=True, text=True)
        fn = ctypes.CDLL(str(so)).mamba_scan_launch
        fn.argtypes, fn.restype = lib.mamba_scan_launch.argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def replay_stats(torch, dec, tol: dict) -> dict:
    """The replay check's numbers without its assertions: per completed
    request of each member, the streamed logits against the batch-1
    unpaged replay (scaled by the replay row's largest magnitude), and the
    batch-8 unpaged replay as the control."""
    from repro_torch.serving.decode import replay_unpaged

    firsts = {}
    for c in dec.completions:
        firsts.setdefault(c.request.instance_id, c)
    worst = ctl_worst = 0.0
    over = flips = confident = 0
    for c in firsts.values():
        control = replay_unpaged(dec, c, batch=dec.max_slots)
        for i, row in enumerate(replay_unpaged(dec, c)):
            want, got = torch.from_numpy(row), torch.from_numpy(c.logits[i])
            scale = want.abs().max().item()
            diff = (got - want).abs() / scale
            worst = max(worst, diff.max().item())
            over += int((diff > tol["atol"] + tol["rtol"] * want.abs() / scale).sum())
            ctl_worst = max(ctl_worst, (torch.from_numpy(control[i]) - want).abs().max().item()
                            / scale)
            top1, top2 = torch.topk(want, 2).values.tolist()
            if c.tokens[i] != int(want.argmax()):
                flips += 1
                confident += top1 - top2 > tol["atol"] + tol["rtol"] * abs(top1)
    return dict(max_abs_err_over_row_max=worst, logits_over_tol=over, argmax_mismatches=flips,
                confident_argmax_mismatches=confident,
                batch_control_max_abs_err_over_row_max=ctl_worst)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_scan_numerics: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs import falcon_mamba_7b
    from repro_torch.core import ParamStore
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba_scan as kmod
    from repro_torch.kernels.ref import mamba_scan_ref
    from repro_torch.models.registry import get_adapter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(cs.nvidia_smi_line(), flush=True)
    lib = _build.load_library()
    shipped = lib.mamba_scan_launch
    fns = build_variants(lib)

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = {"serve-f32": (8, 128, 8192, 16, "float32"),
              "serve-bf16": (8, 128, 8192, 16, "bfloat16"),
              "decode-step": (8, 1, 8192, 16, "float32")}
    args = {}
    for case, (B, S, di, n, dtype) in shapes.items():
        dt = getattr(torch, dtype)
        rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
        args[case] = (torch.nn.functional.softplus(rnd(B, S, di)).to(dt), rnd(B, S, di).to(dt),
                      rnd(B, S, n).to(dt), rnd(B, S, n).to(dt), -torch.exp(0.5 * rnd(di, n)),
                      rnd(B, di, n))
    kernel_rows, exact_out = {}, {}
    for name, fn in fns.items():
        lib.mamba_scan_launch = fn
        row = {}
        for case, a in args.items():
            y, h = kmod.mamba_scan(*a)
            yr, hr = mamba_scan_ref(*a)
            if name == "exact":
                exact_out[case] = (y, h)
            ey, eh = exact_out[case]
            row[case] = dict(ms=cs.cuda_ms(torch, lambda: kmod.mamba_scan(*a), 20),
                             max_abs_err=max((y - yr).abs().max().item(),
                                             (h - hr).abs().max().item()),
                             bitwise_exact=bool(torch.equal(y, ey) and torch.equal(h, eh)))
        kernel_rows[name] = row
    lib.mamba_scan_launch = shipped
    del args, exact_out

    cfg = falcon_mamba_7b.full_config()
    adapter = get_adapter("ssm")
    store = ParamStore.from_models(cs.lm_zoo(torch, adapter, cfg))
    cs.merge_trunk(adapter, cfg, store, cs.LM_MIDS)
    eng = cs.make_engine(adapter, cfg, store, cs.LM_MIDS, int(32e9))
    torch.cuda.empty_cache()
    summary = {}
    for name, fn in fns.items():
        lib.mamba_scan_launch = fn
        t0 = time.perf_counter()
        reqs = cs.decode_requests(cfg, cs.REQS_PER_MEMBER, 200, cs.NEW_TOKENS)
        stats = eng.serve_decode(reqs, horizon_s=900.0, record_logits=True, **cs.DECODE_KW)
        assert stats["completed"] == len(reqs), stats
        replay = replay_stats(torch, eng.last_decoder, cs.TOL["bfloat16"])
        summary[name] = dict(replay_passes=replay["logits_over_tol"] == 0
                             and replay["confident_argmax_mismatches"] == 0,
                             serve_f32_ms=kernel_rows[name]["serve-f32"]["ms"])
        print(json.dumps({"variant": name, "kernel": kernel_rows[name], "replay": replay,
                          "tol": cs.TOL["bfloat16"], "seconds": time.perf_counter() - t0}),
              flush=True)
    lib.mamba_scan_launch = shipped
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
