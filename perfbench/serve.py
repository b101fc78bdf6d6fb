"""The open loop of a serve cell: requests are submitted to
``MergeAwareEngine.serve`` when they fall due, whether or not earlier ones
have finished, and each is timed from its due time to its completion.

It reports the 95th percentile latency of every request due in the
window (a cell below capacity) and the input tokens of the requests
completed inside the window over the window (a cell above it).

One thread: the loop submits what is due (at most ``CALL_BATCHES`` of the
largest micro-batches at a time, in due order), then calls ``serve`` to
drain the queues, and sleeps until the next due time when nothing waits.
Requests that fall due while ``serve`` runs are submitted late; how late is
the generator's lag, and the wait counts in their latency.  After the
window closes, the requests already due are submitted and drained.

The engine keeps each completion's logits on the device; the loop takes
completions off the engine after every call, keeping for the check only
the sampled requests' argmax tokens and their logits at those tokens and at
probe entries drawn from the seed.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from perfbench import costs, generator, trace
from perfbench.common import percentile, stable_seed

# at most this many of the largest micro-batches are handed to one serve
# call, in due order (the engine's own EDF cut): the engine keeps every
# completion's logits on the device until the call returns, so a larger
# hand-over holds a backlog's logits at once and the peak follows the backlog
CALL_BATCHES = 1


class CallClock:
    """The engine's clock: ``time.perf_counter``, remembering its first
    reading since :meth:`mark` (``serve`` reads its start first)."""

    def __init__(self):
        self.first = None

    def mark(self) -> None:
        self.first = None

    def __call__(self) -> float:
        t = time.perf_counter()
        if self.first is None:
            self.first = t
        return t


def rooflines(ctx) -> dict:
    """{op: (bound_s, time_s)}: the eager calls observed in the slice
    matched to their kernels in order (:func:`trace.eager_rooflines`)."""
    return trace.eager_rooflines(ctx.summary, ctx.slice.calls)


def run(ctx) -> dict:
    """Serve one window; returns the counters the metrics read.  In a
    traced run every op call is observed (recorded while the slice is
    open)."""
    from repro_torch.kernels import ops

    with (ops.observed(ctx.slice.observer) if ctx.slice.enabled
          else contextlib.nullcontext()):
        return _run(ctx)


def _run(ctx) -> dict:
    from repro_torch.serving.executor import Request

    cell, seed, seconds = ctx.cell, ctx.seed, ctx.seconds
    planned = generator.plan(ctx.mix, seed, len(ctx.members), seconds, cell["rate_per_s"])
    toks = generator.tokens(seed, planned, ctx.vocab)
    S = planned[0].prompt_len
    on_dev = torch.from_numpy(np.stack(toks)).to(ctx.device)
    payloads = [on_dev[i:i + 1] for i in range(len(planned))]
    rng = np.random.default_rng(stable_seed(seed, "sample"))
    n_sample = min(cell["sample"], len(planned))
    sampled = set(int(i) for i in rng.choice(len(planned), n_sample, replace=False))
    probes = torch.from_numpy(rng.integers(0, ctx.padded_vocab, (S, cell["probes"]))).to(
        ctx.device)
    flops = costs.sequence_flops(ctx.family, ctx.cfg, S)

    eng, clock = ctx.engine, ctx.clock
    eng.serve(horizon_s=0.0, warmup=payloads[0])  # every (group, bucket) path
    ctx.probes = probes.cpu().numpy()
    ctx.window_starts()

    done: dict = {}
    kept: dict = {}
    lags, calls = [], []
    stats = {"microbatches": 0, "bank_hits": 0, "serve_s": 0.0}
    t0 = time.perf_counter()

    def collect() -> None:
        for c in eng.completions:
            i = c.request.meta
            done[i] = clock.first + c.finished_s
            if i in sampled:
                out = c.result  # (S, V) float32
                top = out.argmax(-1)
                kept[i] = (top.cpu().numpy(),
                           out.gather(-1, top[:, None])[:, 0].cpu().numpy(),
                           out.gather(-1, probes).cpu().numpy())
        eng.completions.clear()

    def serve_once() -> None:
        clock.mark()
        a = time.perf_counter()
        with torch.profiler.record_function("MergeAwareEngine.serve"):
            st = eng.serve(horizon_s=float("inf"), drain=True)
        b = time.perf_counter()
        if ctx.slice.state == "before":  # the layer counters: unprofiled calls only
            stats["microbatches"] += st["microbatches"]
            stats["bank_hits"] += st["bank_hits"]
            stats["serve_s"] += b - a
        n = len(eng.completions)
        collect()
        if ctx.slice.open:
            calls.append((a, b, n * flops))

    cap = CALL_BATCHES * max(cell["buckets"])
    waiting: list = []  # due, not yet handed to the engine

    def submit(now: float) -> None:
        for j in waiting[:cap]:
            r = planned[j]
            if ctx.slice.state == "before":
                lags.append(now - r.due_s)
            eng.submit(Request(ctx.members[r.member], payloads[j], r.due_s, r.due_s + 1e6,
                               meta=j))
        del waiting[:cap]

    i = 0
    while True:
        now = time.perf_counter() - t0
        if now >= seconds:
            break
        ctx.slice.tick(now)
        while i < len(planned) and planned[i].due_s <= now:
            waiting.append(i)
            i += 1
        if waiting:
            submit(now)
            serve_once()
        else:
            nxt = planned[i].due_s if i < len(planned) else seconds
            time.sleep(max(0.0, min(nxt, seconds) - (time.perf_counter() - t0)))
    ctx.slice.close()
    window_s = time.perf_counter() - t0
    # the requests already due: handed over now and drained, their wait counted
    while i < len(planned) and planned[i].due_s < seconds:
        waiting.append(i)
        i += 1
    deadline = time.perf_counter() + 60.0
    while waiting and time.perf_counter() < deadline:
        submit(time.perf_counter() - t0)
        serve_once()
    ctx.window_ends()

    due = [r for r in planned if r.due_s < seconds]
    lat = [(done[r.index] - (t0 + r.due_s)) if r.index in done else float("inf") for r in due]
    failed = sum(1 for r in due if r.index not in done)
    ctx.useful_flops = sum(c[2] for c in calls)
    ctx.stats.update(stats, gen_lags=lags)  # counted before the profiler started
    ctx.attempted, ctx.failed = len(due), failed
    ctx.e2e["serve_p95_ms"] = percentile(lat, 95) * 1e3 if due else None
    end = t0 + window_s
    ctx.e2e["serve_tokens_per_s"] = sum(r.prompt_len for r in due
                                        if done.get(r.index, end + 1) <= end) / window_s
    ctx.latencies = [(r.due_s, x) for r, x in zip(due, lat)]
    ctx.samples = [(planned[i].member, toks[i], kept[i]) for i in sorted(kept)]
    return ctx.stats
