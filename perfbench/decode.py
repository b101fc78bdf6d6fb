"""The offline backlog of a decode cell: every request is queued before the
window, the ``StreamingDecoder`` is warmed up on them (every step and
prefill-chunk graph the backlog needs is captured), and the window runs its
continuous batching for ``seconds``.

After every step the loop reads the clock and each live request's tokens:
a token's inter-token latency is the time since the same request's
previous token; the first token of a request has none.  It also counts the
model flops of the step from each row's lengths before and after it: the
trunk for every token a row took in (prompt or decoded), the row's own
head for each token it emitted.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from perfbench import costs, generator
from perfbench.common import percentile, stable_seed


@contextlib.contextmanager
def captured_calls(ctx, dec):
    """In a traced run, record the kernel calls each CUDA graph's capture
    makes into ``ctx.graph_calls``, keyed by the graph's place in
    ``dec.graphs`` (a capture is counted once it ends, so a call made while
    ``captures == k`` is the k-th graph's)."""
    from repro_torch.kernels import ops

    ctx.graph_calls = {}

    def observer(name, body, args, kwargs):
        if torch.cuda.is_current_stream_capturing():
            ctx.graph_calls.setdefault(dec.graphs.captures, []).append(
                (name, tuple(costs.Spec.of(a) if isinstance(a, torch.Tensor) else a
                             for a in args)))
        return body(*args, **kwargs)

    graphed = ctx.slice.enabled and dec.graphs is not None
    with (ops.observed(observer) if graphed else contextlib.nullcontext()):
        yield


def rooflines(ctx) -> dict:
    """{op: (bound_s, time_s)} of the slice: each graph's captured calls
    above the L2, times its replays in the slice, over the op's device
    time there."""
    s, rep = ctx.summary, ctx.stats.get("replays", {})
    graphs = [g for _, g in ctx.decoder.graphs.items()] if ctx.decoder.graphs else []
    bound: dict = {}
    for k, calls in ctx.graph_calls.items():
        g = graphs[k]
        n = rep.get("stop", {}).get(id(g), 0) - rep.get("start", {}).get(id(g), 0)
        for op, args in calls:
            c = costs.COSTS[op](*args) if op in costs.COSTS else None
            if c is not None and costs.above_l2(c):
                bound[op] = bound.get(op, 0.0) + n * costs.bound_s(op, c)
    time_of = {op: sum(s.by_op.get(op, [])) for op in bound}
    return {op: (b, time_of[op]) for op, b in bound.items() if time_of[op] > 0}


def run(ctx) -> dict:
    from repro_torch.serving.decode import DecodeRequest, StreamingDecoder

    cell, seed, seconds = ctx.cell, ctx.seed, ctx.seconds
    planned = generator.plan(ctx.mix, seed, len(ctx.members), seconds)
    toks = generator.tokens(seed, planned, ctx.vocab)
    reqs = [DecodeRequest(ctx.members[r.member], toks[r.index], max_new_tokens=r.output_len,
                          meta=r.index) for r in planned]
    dec = StreamingDecoder(ctx.engine, **cell["decoder"])
    ctx.decoder = dec
    with captured_calls(ctx, dec):
        dec.run(reqs, horizon_s=0.0)  # queue everything; warm up and capture
    ctx.window_starts()

    last: dict = {}  # request index -> (length, tokens out, time of the last token)
    itl: list = []
    per_step: list = []  # (slice open, flops)
    family, cfg = ctx.family, ctx.cfg
    seen = [0]  # completions read so far
    base = dict(dec.stats), dict(dec.trunk_passes)
    replays: dict = {}

    head = costs.head_flops(cfg)

    def account(key, length: int, n_out: int, now: float, flops: list) -> None:
        prev_len, prev_out, prev_t = last.get(key, (0, 0, None))
        emitted = n_out > prev_out
        flops.append(costs.trunk_flops(family, cfg, prev_len, length) + (head if emitted else 0.0))
        if emitted:
            if prev_out > 0:
                itl.append(now - prev_t)
            prev_t = now
        last[key] = (length, n_out, prev_t)

    def on_step(d, step: int) -> None:
        now = time.perf_counter()
        flops: list = []
        for s in d.slots.values():
            account(s.request.meta, s.length, len(s.out_tokens), now, flops)
        for c in d.completions[seen[0]:]:
            key = c.request.meta
            prev_len = last.get(key, (0, 0, None))[0]
            account(key, prev_len + 1, len(c.tokens), now, flops)
            last.pop(key, None)
        seen[0] = len(d.completions)
        per_step.append((ctx.slice.open, sum(flops)))
        ctx.slice.tick(now - t0)

    def replay_counts() -> dict:
        return {id(g): g.replays for _, g in dec.graphs.items()} if dec.graphs else {}

    pre: dict = {}  # the layer counters where the profiler starts

    def slice_starts() -> None:
        replays.update(start=replay_counts())
        pre.update(t=time.perf_counter(), stats=dict(dec.stats), passes=dict(dec.trunk_passes))

    ctx.slice.on_start.append(slice_starts)
    ctx.slice.on_stop.append(lambda: replays.update(stop=replay_counts()))
    t0 = time.perf_counter()
    with torch.profiler.record_function("StreamingDecoder.run"):
        dec.run([], horizon_s=seconds, on_step=on_step, warmup=False)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    ctx.slice.close()
    ctx.window_ends()

    tokens_out = dec.stats["tokens_decoded"] - base[0]["tokens_decoded"]
    # the layer counters over the stretch before the profiler started
    st, tp = pre.get("stats", dec.stats), pre.get("passes", dec.trunk_passes)
    ctx.stats.update(
        counted_s=pre.get("t", t0 + window_s) - t0, steps=st["steps"] - base[0]["steps"],
        trunk_passes=tp["run"] - base[1]["run"],
        step_passes=sum(st[k] - base[0][k] for k in ("trunk_dispatches", "singleton_dispatches")),
        replays=replays)
    ctx.useful_flops = sum(f for open_, f in per_step if open_)
    ctx.attempted, ctx.failed = len(dec.completions), 0
    ctx.e2e["decode_tokens_per_s"] = tokens_out / window_s
    ctx.e2e["decode_itl_p95_ms"] = percentile(itl, 95) * 1e3 if itl else None

    # the sample the reference checks: drawn from the seed among the
    # completions, with the longest of them in it
    comps = dec.completions
    rng = np.random.default_rng(stable_seed(seed, "sample"))
    longest = max(range(len(comps)), key=lambda j: len(comps[j].request.prompt)
                  + len(comps[j].tokens)) if comps else None
    rest = [j for j in range(len(comps)) if j != longest]
    pick = ([longest] if comps else []) + [int(j) for j in rng.choice(
        rest, min(len(rest), cell["sample"] - 1), replace=False)]
    ctx.samples = [(planned[comps[j].request.meta].member, np.asarray(comps[j].request.prompt),
                    list(comps[j].tokens)) for j in sorted(pick)]
    return ctx.stats
