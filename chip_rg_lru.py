#!/usr/bin/env python3
"""The rg_lru_scan kernel against the single-design kernel it replaced, on
one NVIDIA GPU.

    python3 chip_rg_lru.py --parent PATH [--variants]

PATH is a copy of the earlier ``kernels/csrc/rg_lru.cu``: one thread per
(row, channel) and a register prefetch for every S, with the C interface
``rg_lru_launch(a, b, h0, y, h_last, B, S, d, dtype, stream)`` (take it
from the repository's history).  It is compiled in a temporary directory
outside the checkout.  The script then:

* ``sass``: counts, in ``cuobjdump -sass`` of both libraries, each rg_lru
  kernel's FFMA / FMUL / FADD and global loads, and checks that the
  ``step`` kernel issues every global load before its first FFMA;
* ``bits``: at every shape ``chip_smoke.py`` and ``tests/test_torch_gpu.py``
  check (and the tile edges of the ``scan`` route), y and h_last of this
  kernel bitwise against the earlier kernel's, the route taken against
  the one expected, and both against ``rg_lru_ref``;
* ``chain``: 16 chained S = 1 launches (``step``) bitwise one S = 16
  launch (``scan``), for float32 and bf16;
* ``graph``: a ``scan`` launch captured in a CUDA graph, replayed,
  bitwise the eager launch;
* ``time``: the earlier kernel and this one in turns (earlier, this, this,
  earlier) at the main-path shapes, CUDA events over graph replays, each
  beside its byte bound;
* ``model``: full-width recurrentgemma-9b at ``chip_smoke.FAMILY_LAYERS``
  layers (random weights from a seed): a forward over 8 x 128 tokens and
  16 decode steps with each kernel, logits bitwise equal, and the rg_lru
  kernels' device time under ``torch.profiler``;
* with ``--variants``: the ``scan`` route's box depth and ring depth and
  the ``step`` route's block size, each variant compiled from a patched
  copy of the source and timed at the serve and decode shapes.

Each part prints JSON lines; the last line is a summary.  Any bitwise
difference fails the script.  Needs one card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (case, B, S, d, dtype, route the wrapper must take)
CASES = [
    ("rgemma-serve", 8, 128, 4096, "float32", "scan"),
    ("rgemma-serve", 8, 128, 4096, "bfloat16", "scan"),
    ("s129", 8, 129, 4096, "float32", "scan"),
    ("s129", 8, 129, 4096, "bfloat16", "scan"),
    ("s13-d4096", 8, 13, 4096, "float32", "scan"),
    ("ragged", 3, 13, 1000, "float32", "scan"),
    ("ragged", 3, 13, 1000, "bfloat16", "scan"),
    ("d1001", 3, 13, 1001, "float32", "plain"),
    ("d1001", 3, 13, 1001, "bfloat16", "plain"),
    ("d1001-step", 8, 1, 1001, "float32", "plain"),
    ("rgemma-decode", 8, 1, 4096, "float32", "step"),
    ("rgemma-decode", 8, 1, 4096, "bfloat16", "step"),
    ("test-300", 2, 13, 300, "float32", "scan"),
    ("test-300", 2, 13, 300, "bfloat16", "plain"),
    ("test-64", 1, 200, 64, "float32", "scan"),
    ("test-64", 1, 200, 64, "bfloat16", "scan"),
    ("chain", 8, 16, 4096, "float32", "scan"),
    ("chain", 8, 16, 4096, "bfloat16", "scan"),
    ("edges", 2, 2, 32, "float32", "scan"),
    ("edges", 2, 17, 40, "float32", "scan"),
    ("edges", 2, 33, 72, "bfloat16", "scan"),
    ("edges", 2, 64, 8, "bfloat16", "scan"),
]
TIMED = [("rgemma-serve", 8, 128, 4096, "float32"), ("rgemma-serve", 8, 128, 4096, "bfloat16"),
         ("s129", 8, 129, 4096, "float32"), ("s13-d4096", 8, 13, 4096, "float32"),
         ("d1001", 3, 13, 1001, "float32"),
         ("rgemma-decode", 8, 1, 4096, "float32"), ("rgemma-decode", 8, 1, 4096, "bfloat16")]
# the patchable constants of csrc/rg_lru.cu and the values --variants tries
ANCHORS = {"ts_f32": "template <> struct Tile<float> { static constexpr int TS = {}; };",
           "stages": "constexpr int STAGES = {};",
           "step_threads": "constexpr int THREADS = {};  // 128 blocks"}
VARIANTS = [dict(ts_f32=16, stages=4, step_threads=64), dict(ts_f32=8, stages=8, step_threads=128),
            dict(ts_f32=32, stages=3, step_threads=256), dict(ts_f32=32, stages=4, step_threads=32),
            dict(ts_f32=16, stages=8, step_threads=64)]


def emit(part: str, **fields) -> None:
    print(json.dumps({"part": part, **fields}), flush=True)


def compile_so(src: Path, so: Path) -> None:
    from repro_torch.kernels import _build

    subprocess.run([_build.find_nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
                    "-fPIC", "-shared", str(src), "-o", str(so)],
                   check=True, capture_output=True, text=True)


def load_fn(so: Path, with_route: bool):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = ctypes.CDLL(str(so)).rg_lru_launch
    fn.argtypes = [vp] * 5 + [ci] * (5 if with_route else 4) + [vp]
    fn.restype = ci
    return fn


def sass_ops(so: Path) -> dict:
    """{rg_lru kernel: {"FFMA": n, "FMUL": n, "FADD": n, "LDG": n,
    "loads_before_first_ffma": bool}} from ``cuobjdump -sass``."""
    from repro_torch.kernels import _build

    text = subprocess.run([_build.find_tool("cuobjdump"), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    out, name, seq = {}, None, []

    def close():
        if name and "rg_lru" in name:
            ops = [w.split(".")[0] for w in seq]
            first = ops.index("FFMA") if "FFMA" in ops else len(ops)
            loads = [i for i, o in enumerate(ops) if o == "LDG"]
            out[name] = dict(**{k: ops.count(k) for k in ("FFMA", "FMUL", "FADD", "LDG", "LDS",
                                                           "STG", "UBLKCP", "UTMALDG")},
                             loads_before_first_ffma=bool(loads) and max(loads) < first)

    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            close()
            name, seq = line.split(":", 1)[1].strip(), []
        elif line.startswith("/*") and "*/" in line:
            words = [w for w in line.split("*/", 1)[-1].split() if not w.startswith("@")]
            if words and words[0][0].isupper():
                seq.append(words[0])
    close()
    return out


def inputs(torch, gen, B, S, d, dtype):
    dt = getattr(torch, dtype)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    return torch.sigmoid(rnd(B, S, d)).to(dt), rnd(B, S, d).to(dt), rnd(B, d)


def call(torch, fn, a, b, h0, route=None):
    """One launch of a ctypes ``rg_lru_launch`` (the earlier interface when
    ``route`` is None) into fresh outputs."""
    B, S, d = a.shape
    y = torch.empty((B, S, d), dtype=torch.float32, device="cuda")
    h = torch.empty((B, d), dtype=torch.float32, device="cuda")
    dtype = 0 if a.dtype == torch.float32 else 1
    stream = torch.cuda.current_stream().cuda_stream
    tail = (dtype, stream) if route is None else (dtype, route, stream)
    err = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, d,
             *tail)
    assert err == 0, f"rg_lru_launch returned cudaError_t {err}"
    return y, h


def rg_lru_device_ms(torch, fn) -> tuple:
    """(ms, launches) of kernels named rg_lru* in ``fn()`` under the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and "rg_lru" in e.key]
    return sum(e.self_device_time_total for e in rows) / 1e3, sum(e.count for e in rows)


def model_part(torch, cs, use_parent) -> dict:
    """recurrentgemma-9b at phase 6's depth: a forward over 8 x 128 tokens
    and 16 decode steps from a 16-token prefill, with the earlier kernel
    (``use_parent(True)``) and with this one, in turns."""
    from repro_torch.configs import recurrentgemma_9b
    from repro_torch.models import griffin

    cfg = cs.cut_depth(recurrentgemma_9b.full_config(), cs.FAMILY_LAYERS["recurrentgemma"])
    params = griffin.init(cfg, 0, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (8, 128), generator=gen, device="cuda")

    def run():
        logits = griffin.forward(cfg, params, toks)
        rows, (last, cache) = [], griffin.prefill(cfg, params, toks[:, :16], 16 + 16)
        for t in range(16):
            last, cache = griffin.decode_step(cfg, params, cache, toks[:, 16 + t:17 + t])
            rows.append(last)
        return logits, torch.cat(rows, dim=1)

    out, times = {}, {}
    with torch.no_grad():
        for who in ("earlier", "this", "this", "earlier"):
            use_parent(who == "earlier")
            run()  # warm-up
            got = run()
            out.setdefault(who, got)
            fwd = rg_lru_device_ms(torch, lambda: griffin.forward(cfg, params, toks))

            def steps():
                _, cache = griffin.prefill(cfg, params, toks[:, :16], 32)
                for t in range(16):
                    griffin.decode_step(cfg, params, cache, toks[:, 16 + t:17 + t])
            dec = rg_lru_device_ms(torch, steps)
            times.setdefault(who, []).append(dict(forward_ms=fwd[0], forward_launches=fwd[1],
                                                  prefill_and_16_steps_ms=dec[0],
                                                  prefill_and_16_steps_launches=dec[1]))
    use_parent(False)
    same = all(torch.equal(x, y) for x, y in zip(out["earlier"], out["this"]))
    return dict(config=cfg.name, layers=cfg.n_layers, d_rnn=cfg.d_rnn, logits_bitwise=same,
                rg_lru_device=times)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_rg_lru: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import rg_lru as kmod
    from repro_torch.kernels.ref import rg_lru_ref

    print(cs.nvidia_smi_line(), flush=True)
    cs.full_precision_matmuls(torch)
    lib = _build.load_library()
    summary = dict(bitwise=True)
    with tempfile.TemporaryDirectory() as tmp:
        parent_so = Path(tmp) / "parent.so"
        compile_so(args.parent.resolve(), parent_so)
        parent = load_fn(parent_so, with_route=False)
        sass = dict(earlier=sass_ops(parent_so), this=sass_ops(_build.library_path()))
        ptxas = [ln.strip() for ln in _build.build_info.get("ptxas", {}).get("rg_lru.cu", "")
                 .splitlines() if "registers" in ln or "spill" in ln or "Compiling" in ln]
        emit("sass", **sass, ptxas=ptxas)
        step_ok = [v["loads_before_first_ffma"] for k, v in sass["this"].items() if "step" in k]
        summary["step_loads_before_first_ffma"] = bool(step_ok) and all(step_ok)
        summary["earlier_fmul_fadd"] = sum(v["FMUL"] + v["FADD"] for v in sass["earlier"].values())

        gen = torch.Generator(device="cuda").manual_seed(0)
        for case, B, S, d, dtype, want in CASES:
            a, b, h0 = inputs(torch, gen, B, S, d, dtype)
            path = kmod.route(a, b, h0)
            y, h = kmod.rg_lru_scan(a, b, h0)
            py, ph = call(torch, parent, a, b, h0)
            yr, hr = rg_lru_ref(a, b, h0)
            torch.cuda.synchronize()
            same = torch.equal(y, py) and torch.equal(h, ph)
            err = max((y - yr).abs().max().item(), (h - hr).abs().max().item())
            emit("bits", case=case, shape=[B, S, d], dtype=dtype, route=path, bitwise=same,
                 max_abs_err_vs_plain=err)
            assert path == want, (case, path, want)
            assert same, (case, dtype)
            torch.testing.assert_close(y, yr, **cs.TOL["float32"])
        # a view starting mid-row (4 bytes past a 16-byte boundary) takes "plain"
        base = torch.randn(8 * 13 * 256 + 1, generator=gen, device="cuda")
        a = torch.sigmoid(base[1:]).view(8, 13, 256)
        b, h0 = base[1:].view(8, 13, 256), torch.randn(8, 256, generator=gen, device="cuda")
        y, h = kmod.rg_lru_scan(a, b, h0)
        py, ph = call(torch, parent, a, b, h0)
        torch.cuda.synchronize()
        same = torch.equal(y, py) and torch.equal(h, ph)
        emit("bits", case="mid-row-view", shape=[8, 13, 256], dtype="float32",
             route=kmod.route(a, b, h0), bitwise=same)
        assert kmod.route(a, b, h0) == "plain" and same

        for dtype in ("float32", "bfloat16"):  # chain: 16 steps against one scan
            a, b, h0 = inputs(torch, gen, 8, 16, 4096, dtype)
            ops.reset_kernel_launches()
            y, h = kmod.rg_lru_scan(a, b, h0)
            hc, ys = h0, []
            for t in range(16):
                yt, hc = kmod.rg_lru_scan(a[:, t:t + 1].contiguous(), b[:, t:t + 1].contiguous(),
                                          hc)
                ys.append(yt)
            torch.cuda.synchronize()
            same = torch.equal(torch.cat(ys, dim=1), y) and torch.equal(hc, h)
            emit("chain", dtype=dtype, routes=ops.route_launches()["rg_lru_scan"], bitwise=same)
            assert same and ops.route_launches()["rg_lru_scan"] == dict(scan=1, step=16, plain=0)

        a, b, h0 = inputs(torch, gen, 8, 128, 4096, "float32")  # graph of the scan route
        want = kmod.rg_lru_scan(a, b, h0)
        graph, outs = torch.cuda.CUDAGraph(), []
        with torch.cuda.graph(graph):
            for _ in range(3):
                outs.append(kmod.rg_lru_scan(a, b, h0))
        graph.replay()
        torch.cuda.synchronize()
        same = all(torch.equal(y, want[0]) and torch.equal(h, want[1]) for y, h in outs)
        emit("graph", route=kmod.route(a, b, h0), replays_bitwise_eager=same)
        assert same
        del graph, outs

        for case, B, S, d, dtype in TIMED:
            a, b, h0 = inputs(torch, gen, B, S, d, dtype)
            route = kmod.route(a, b, h0)
            ms = {"earlier": [], "this": []}
            for who in ("earlier", "this", "this", "earlier"):
                fn = ((lambda: call(torch, parent, a, b, h0)) if who == "earlier"
                      else (lambda: kmod.rg_lru_scan(a, b, h0)))
                ms[who].append(cs.cuda_ms(torch, fn, 200))
            cost = ops.rg_lru_scan_cost(a, b, h0)
            bound_ms, by = cs.bound(cost.bytes, cost.flops, "float32")
            emit("time", case=case, shape=[B, S, d], dtype=dtype, route=route, ms=ms,
                 bound_ms=bound_ms, bound_by=by,
                 share_of_bound=dict(earlier=bound_ms / min(ms["earlier"]),
                                     this=bound_ms / min(ms["this"])))
            summary[f"{case}-{dtype}"] = dict(earlier_ms=min(ms["earlier"]),
                                              this_ms=min(ms["this"]), bound_ms=bound_ms)

        real = lib.rg_lru_launch

        def use_parent(on: bool) -> None:
            lib.rg_lru_launch = ((lambda *x: parent(*x[:9], x[10])) if on else real)

        row = model_part(torch, cs, use_parent)
        emit("model", **row)
        summary["model_logits_bitwise"] = row["logits_bitwise"]
        assert row["logits_bitwise"]

        if args.variants:
            text = (_build.CSRC / "rg_lru.cu").read_text()
            base = VARIANTS[0]
            for k, anchor in ANCHORS.items():
                assert text.count(anchor.replace("{}", str(base[k]))) == 1, anchor
            for i, v in enumerate(VARIANTS):
                src = text
                for k, anchor in ANCHORS.items():
                    src = src.replace(anchor.replace("{}", str(base[k])),
                                      anchor.replace("{}", str(v[k])))
                cu, so = Path(tmp) / f"v{i}.cu", Path(tmp) / f"v{i}.so"
                cu.write_text(src)
                compile_so(cu, so)
                fn = load_fn(so, with_route=True)
                times = {}
                for case, B, S, d, dtype in TIMED:
                    if case not in ("rgemma-serve", "rgemma-decode"):
                        continue
                    a, b, h0 = inputs(torch, gen, B, S, d, dtype)
                    r = kmod.ROUTES.index(kmod.route(a, b, h0))
                    y, h = call(torch, fn, a, b, h0, r)
                    yw, hw = kmod.rg_lru_scan(a, b, h0)
                    torch.cuda.synchronize()
                    assert torch.equal(y, yw) and torch.equal(h, hw), (v, case)
                    times[f"{case}-{dtype}"] = cs.cuda_ms(
                        torch, lambda: call(torch, fn, a, b, h0, r), 200)
                emit("variant", **v, ms=times)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
