#!/usr/bin/env python3
"""Run one cell once with the readers of ``perfbench/spans.py`` wired into
the harness, and print the span metrics beside the harness's result.

    python3 perfbench/span_run.py --workload <cell> --seed <n> --seconds <s> [--mode traced|on]

``--mode traced`` (the default) is a ``--trace 1`` run with the program's
tracer on from the window's start; ``--mode on`` a ``--trace 0`` run with
the tracer on all window and no profiler, what the tracer costs when on.

The harness calls neither of the two calls of ``spans`` yet; this script
sets them in its place (:func:`install`): ``spans.on_window_start`` after
``Context.window_starts`` and ``spans.on_loop_end`` after the cell's loop.
The last line of standard output is one JSON object: ``result`` (the
harness's), and under ``spans`` each reader's number (None where it found
nothing to read), the slice's device-idle time by innermost span, and how
far each ``decoder.step`` / ``engine.microbatch`` span inside the slice lies
from its profiler range.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench import common  # noqa: E402

common.put_src_on_path()

from perfbench.run import since_process_start  # noqa: E402

# the process's start on T_START's clock, read before the heavy imports
T_PROCESS = T_START - since_process_start()

from perfbench import harness, spans  # noqa: E402

READERS = ("mb_span_ms", "step_span_ms", "prefill_device_share", "page_live_share",
           "head_row_share", "host_idle_share")


def install(mode: str = "traced", patch=setattr) -> list:
    """Set the two calls of ``spans`` into the harness (``patch(obj, name,
    value)``, ``setattr`` or a test's ``monkeypatch.setattr``).  ``traced``:
    in a traced run only; ``on``: in every run.  Returns the list that
    takes each run's context after its loop."""
    seen = []
    window_starts = harness.Context.window_starts

    def starts(ctx):
        window_starts(ctx)
        if mode == "on" or ctx.traced:
            spans.on_window_start(ctx)

    patch(harness.Context, "window_starts", starts)
    for loop in ("serve", "decode"):
        mod = importlib.import_module(f"perfbench.{loop}")

        def run(ctx, _run=mod.run):
            out = _run(ctx)
            if hasattr(ctx, "tracing"):
                spans.on_loop_end(ctx)
            seen.append(ctx)
            return out

        patch(mod, "run", run)
    return seen


def mirror_gaps(tr: spans.Tracing, name: str) -> list:
    """[(start gap, end gap)] in ns between each span ``name`` inside the
    slice and its profiler range (the k-th of one with the k-th of the
    other, in start order); [] where their counts differ."""
    if tr.lo is None:
        return []
    mine = sorted((r.start_ns, r.end_ns) for r in tr.records
                  if r.name == name and r.end_ns is not None and tr.lo <= r.start_ns
                  and r.end_ns <= tr.hi)
    theirs = sorted((a, b) for n, a, b in tr.mirrors if n == name and tr.lo <= a and b <= tr.hi)
    if len(mine) != len(theirs):
        return []
    return [(s - a, b - e) for (s, e), (a, b) in zip(mine, theirs)]


def readings(tr: spans.Tracing) -> dict:
    out = {name: getattr(spans, name)(tr) for name in READERS}
    out["host_idle_by_span_s"] = {n: v * 1e-9 for n, v in sorted(
        spans.host_idle_by_span(tr).items(), key=lambda kv: -kv[1])}
    for name in ("decoder.step", "engine.microbatch"):
        g = mirror_gaps(tr, name)
        if g:
            out[f"mirror_gap_us.{name}"] = {
                f"{end}_{q}": f([abs(x[i]) / 1e3 for x in g])
                for i, end in enumerate(("start", "end"))
                for q, f in (("median", statistics.median), ("max", max))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", choices=("traced", "on"), default="traced")
    a = ap.parse_args(argv)
    seen = install(a.mode)
    out = harness.run_cell(a.workload, a.seed, a.seconds, a.mode == "traced",
                           t_process=T_PROCESS)
    tr = getattr(seen[-1], "tracing", None) if seen else None
    rec = {"workload": a.workload, "seed": a.seed, "mode": a.mode, "result": out,
           "spans": None if tr is None else readings(tr)}
    print(json.dumps(rec, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
