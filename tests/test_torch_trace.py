"""The program's tracer (``repro_torch.runtime.trace``) on the CPU.

Off, a span site keeps nothing, reads no clock and never enters a profiler
range.  On, spans nest with their parents' indices, counters add up, and
each span lies within 0.5 ms of its mirror in a CPU profiler's trace.  The
engine's and the decoder's counters are its own: with the tracer on, every
path counts what it counts with it off (so the JAX parity tests of
``stats`` hold whatever the tracer does), and the head-row and page
counters read what the dispatches computed and gathered.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ParamStore, enumerate_groups
from repro_torch.kernels import ops
from repro_torch.models.registry import get_adapter
from repro_torch.runtime import trace
from repro_torch.serving.costs import costs_for
from repro_torch.serving.decode import DecodeRequest, StreamingDecoder
from repro_torch.serving.executor import EdgeExecutor, MergeAwareEngine, ModelProgram, Request
from repro_torch.serving.workload import instances_from_store

MIDS = ("A", "B", "C")
MERGED = ("A", "B")  # C stays a singleton group
TIME_KEYS = ("elapsed_s", "requests_per_s", "tokens_per_s", "dma_hidden_s", "dma_stall_s")


@pytest.fixture(autouse=True)
def tracer_off():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def _engine(suffix_bank=True, buckets=(1, 2, 4)):
    adapter = get_adapter("dense")
    cfg = adapter.default_config()
    store = ParamStore.from_models({m: adapter.init(cfg, seed=i, device="cpu")
                                    for i, m in enumerate(MIDS)})
    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m in MERGED for r in adapter.records(cfg, store.materialize(m), m)
            if r.path in trunk]
    for g in enumerate_groups(recs):
        store.merge_group(g)
    programs = [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in MIDS]
    eng = MergeAwareEngine(store, instances_from_store(store, "tiny-yolo", model_ids=list(MIDS)),
                           programs, capacity_bytes=10 ** 9,
                           costs={"tiny-yolo": costs_for("tiny-yolo")}, buckets=buckets,
                           simulate_dma=False, suffix_bank=suffix_bank)
    return eng, cfg, programs


def _submit(eng, cfg, order):
    rng = np.random.default_rng(3)
    for i, m in enumerate(order):
        eng.submit(Request(m, torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 8))), 0.0,
                           30.0 + i * 1e-3, meta=i))


def _decode_requests(cfg, n=6, prompt=7, new=4):
    rng = np.random.default_rng(4)
    return [DecodeRequest(MIDS[i % len(MIDS)],
                          rng.integers(0, cfg.vocab_size, prompt).astype(np.int32),
                          max_new_tokens=new, meta=i) for i in range(n)]


def _untimed(stats):
    return {k: v for k, v in stats.items() if k not in TIME_KEYS}


def _serve(suffix_bank):
    eng, cfg, _ = _engine(suffix_bank)
    _submit(eng, cfg, [m for _ in range(3) for m in MIDS] + ["A"] * 3)
    stats = eng.serve(horizon_s=60.0)
    return (_untimed(stats), dict(eng.stats),
            [(c.request.meta, c.result.tolist()) for c in eng.completions])


def _decode(chunked):
    eng, cfg, _ = _engine()
    stats = eng.serve_decode(_decode_requests(cfg), page_size=4, num_pages=32, max_slots=4,
                             max_len=16, buckets=(1, 2, 4), chunked_prefill=chunked)
    dec = eng.last_decoder
    return (_untimed(stats), dict(dec.trunk_passes),
            [(c.request.meta, c.tokens, c.steps) for c in dec.completions])


def _lane():
    eng, cfg, programs = _engine()
    ex = EdgeExecutor(eng.store, instances_from_store(eng.store, "tiny-yolo",
                                                      model_ids=list(MIDS)),
                      {p.instance_id: p.forward for p in programs}, capacity_bytes=10 ** 9,
                      costs={"tiny-yolo": costs_for("tiny-yolo")}, simulate_dma=False)
    stats = ex.serve_decode(_decode_requests(cfg, n=3), programs, max_len=16)
    return _untimed(stats), [(c.request.meta, c.tokens) for c in ex.decode_completions]


PATHS = {"serve-bank": lambda: _serve(True), "serve-per-member": lambda: _serve(False),
         "decode": lambda: _decode(False), "decode-chunked": lambda: _decode(True),
         "edge-lane": _lane}


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------


def test_off_a_span_site_keeps_nothing_and_touches_no_clock_or_profiler(monkeypatch):
    def touched(*args, **kwargs):
        raise AssertionError("the tracer did work while off")

    monkeypatch.setattr(torch.profiler, "record_function", touched)
    monkeypatch.setattr(torch._C._autograd, "_profiler_enabled", touched)
    monkeypatch.setattr(trace, "_clock", touched)
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b")  # one shared no-op
    with trace.span("a"):
        trace.count("c", 3)
    for run in PATHS.values():
        run()
    assert trace.records() == [] and trace.counters() == {}


def test_off_no_range_reaches_a_running_profiler():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("engine.serve"):
            torch.ones(4).sum()
    assert "engine.serve" not in {e.name() for e in prof.profiler.kineto_results.events()}


# ---------------------------------------------------------------------------
# on
# ---------------------------------------------------------------------------


def test_spans_nest_with_their_parents_on_the_unix_clock():
    now = [0]
    trace.enable(True, clock=lambda: now[0], unix=lambda: 10 ** 9)

    def at(t):
        now[0] = t

    at(100)
    with trace.span("outer"):
        at(110)
        with trace.span("first"):
            at(150)
        at(160)
        with trace.span("second"):
            at(170)
            with trace.span("leaf"):
                at(175)
            at(200)
        at(300)
    recs = trace.records()
    assert [(r.name, r.parent) for r in recs] == [("outer", -1), ("first", 0), ("second", 0),
                                                  ("leaf", 2)]
    base = 10 ** 9  # the Unix time at enable, when the clock read 0
    assert [(r.start_ns - base, r.end_ns - base) for r in recs] == [
        (100, 300), (110, 150), (160, 200), (170, 175)]


def test_an_open_span_reads_none_and_a_reset_forgets_everything():
    trace.enable(True)
    with trace.span("open"):
        (rec,) = trace.records()
        assert rec.end_ns is None
        trace.reset()
    assert trace.records() == []
    with trace.span("after"):
        pass
    assert [r.parent for r in trace.records()] == [-1]


def test_counters_add_only_while_on():
    trace.count("x", 5)
    assert trace.counters() == {}
    trace.enable(True)
    trace.count("x", 2)
    trace.count("x")
    trace.count("y", 4)
    got = trace.counters()
    got["x"] = 0  # a copy
    assert trace.counters() == {"x": 3, "y": 4}
    trace.enable(False)
    trace.count("x", 9)
    assert trace.counters() == {"x": 3, "y": 4}
    trace.reset()
    assert trace.counters() == {}


def test_spans_lie_on_the_clock_of_their_profiler_mirrors():
    # the first range a process enters initialises the profiler's op, which
    # has taken over a millisecond inside the range on a CPU host
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.profiler.record_function("first"):
            pass
    trace.enable(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            with trace.span("outer"):
                with trace.span("inner"):
                    torch.ones(256).sum()
    events = prof.profiler.kineto_results.events()
    for name in ("outer", "inner"):
        mirrors = sorted((e.start_ns(), e.end_ns()) for e in events if e.name() == name)
        spans = sorted((r.start_ns, r.end_ns) for r in trace.records() if r.name == name)
        assert len(mirrors) == len(spans) == 20
        for (ms, me), (s, e) in zip(mirrors, spans):
            assert abs(s - ms) < 500_000 and abs(e - me) < 500_000, (name, s - ms, me - e)


@pytest.mark.parametrize("path", list(PATHS))
def test_the_tracer_on_changes_no_count_of_the_program(path):
    def run(on):
        trace.enable(on)
        trace.reset()
        ops.reset_kernel_launches()
        ops.reset_dispatch_counts()
        got = PATHS[path]()
        return got, ops.kernel_launches(), ops.route_launches(), ops.dispatch_counts()

    off = run(False)
    assert trace.records() == []
    on = run(True)
    assert on == off
    names = {r.name for r in trace.records()}
    want = {"serve-bank": "engine.microbatch", "serve-per-member": "engine.microbatch",
            "decode": "decoder.step", "decode-chunked": "decoder.prefill",
            "edge-lane": "EdgeExecutor.serve_decode.lane"}[path]
    assert want in names
    assert all(r.end_ns is not None and r.end_ns >= r.start_ns for r in trace.records())


# ---------------------------------------------------------------------------
# what the spans and counters of the serving tiers read
# ---------------------------------------------------------------------------


def test_engine_spans_and_head_rows():
    trace.enable(True)
    eng, cfg, _ = _engine(suffix_bank=True)
    # A, B, A: one banked micro-batch of 3 rows in bucket 4 (2 members x 4 head
    # rows computed); then C alone: a forward of 1 row in bucket 1
    _submit(eng, cfg, ["A", "B", "A"])
    eng.serve(horizon_s=60.0)
    assert trace.counters() == {"engine.head_rows_computed": 8, "engine.head_rows_used": 3}
    _submit(eng, cfg, ["C"])
    eng.serve(horizon_s=60.0)
    assert trace.counters() == {"engine.head_rows_computed": 9, "engine.head_rows_used": 4}
    recs = trace.records()
    assert [r.name for r in recs] == ["engine.serve", "engine.microbatch", "engine.wait"] * 2
    for i, r in enumerate(recs):
        assert r.parent == {"engine.serve": -1, "engine.microbatch": i - 1,
                            "engine.wait": i - 1}[r.name]

    # without the bank each member's suffix runs on its rows, padded onto
    # the ladder: A's two rows in bucket 2, B's one in bucket 1
    trace.reset()
    eng, cfg, _ = _engine(suffix_bank=False)
    _submit(eng, cfg, ["A", "B", "A"])
    eng.serve(horizon_s=60.0)
    assert trace.counters() == {"engine.head_rows_computed": 3, "engine.head_rows_used": 3}


@pytest.mark.parametrize("chunked", [False, True])
def test_decoder_spans_and_pages(chunked):
    """One request of a 6-token prompt and 3 new tokens, alone in a bucket
    of 2 (one row padded), pages of 4, ``max_len`` 16 (4 pages a row)."""
    trace.enable(True)
    eng, cfg, _ = _engine(buckets=(2,))
    dec = StreamingDecoder(eng, page_size=4, num_pages=16, max_slots=2, max_len=16,
                           buckets=(2,), chunked_prefill=chunked)
    prompt = np.arange(6, dtype=np.int32) % cfg.vocab_size
    dec.run([DecodeRequest("C", prompt, max_new_tokens=3, meta=0)])
    # 8 trunk passes, each reading 2 rows x 4 pages; the real row holds
    # 1..8 tokens after them: 1+1+1+1+2+2+2+2 pages
    assert dec.trunk_passes["run"] == 8
    assert trace.counters() == {"decoder.pages_gathered": 8 * 2 * 4, "decoder.pages_live": 12}
    recs = trace.records()
    steps = [i for i, r in enumerate(recs) if r.name == "decoder.step"]
    assert len(steps) == dec.stats["steps"] == (4 if chunked else 8)
    kids = [r.name for r in recs if r.parent == steps[0]]
    assert kids == (["decoder.prefill"] if chunked else []) + ["decoder.emit"]
    assert sum(r.name == "decoder.prefill" for r in recs) == (1 if chunked else 0)
    top = {r.name for r in recs if r.parent == -1}
    assert top == {"StreamingDecoder.run.steps"}
    assert {r.name for r in recs if r.parent == 0} == {"decoder.step"}
