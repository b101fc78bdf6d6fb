"""The readers of the program's spans and counters (``perfbench/spans.py``):
on synthetic events, on a CPU profiler's events, and over whole runs at
small sizes on the CPU with the calls of ``spans`` set into the harness as
``perfbench/span_run.py`` sets them."""
import types

import pytest
import torch

from perfbench import common, harness, span_run, spans
from perfbench.small import OVERRIDES, SECONDS

common.put_src_on_path()

from repro_torch.runtime import trace  # noqa: E402
from repro_torch.runtime.trace import Record  # noqa: E402

SEED = 2 ** 31 + 211


@pytest.fixture(autouse=True)
def tracer_off():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


# ---------------------------------------------------------------------------
# synthetic events
# ---------------------------------------------------------------------------


def _tracing():
    """A slice 0..1000 ns over one decoder step: a prefill chunk replayed
    as a graph (correlation 7, two kernels) with an inner span, the step's
    own dispatch launched eagerly (correlation 8), the emit's wait; the
    harness's callback after it."""
    recs = [Record("StreamingDecoder.run.steps", 0, 1000, -1),
            Record("decoder.step", 100, 800, 0),
            Record("decoder.prefill", 110, 300, 1),
            Record("inner", 120, 140, 2),
            Record("dispatch", 320, 500, 1),
            Record("decoder.emit", 500, 780, 1)]
    device = [(150, 250, 7), (250, 330, 7),  # the graph's kernels
              (520, 700, 8),  # the dispatch's kernel, running into the emit
              (900, 950, 9)]  # launched by the harness: under no span
    launches = {7: 200, 8: 450, 9: 850}
    return spans.Tracing(records=recs, mark=None, lo=0, hi=1000, device=device,
                         launches=launches)


def test_a_kernel_belongs_to_the_span_of_its_launch_call():
    tr = _tracing()
    # 180 ns launched in the prefill (through its graph's launch), of 410
    assert spans.prefill_device_share(tr) == pytest.approx(180 / 410)
    assert spans.device_share_under(tr, "dispatch") == pytest.approx(180 / 410)
    assert spans.device_share_under(tr, "decoder.step") == pytest.approx(360 / 410)


def test_idle_gaps_count_under_program_spans_and_not_the_harness():
    tr = _tracing()
    assert spans.idle_gaps(tr) == [(0, 150), (330, 520), (700, 900), (950, 1000)]
    # 0..150: middle 75 in run.steps; 330..520: middle 425 in the dispatch;
    # 700..900: middle 800 at the step's end; 950..1000: middle 975 in run.steps
    assert spans.host_idle_by_span(tr) == {"StreamingDecoder.run.steps": 200,
                                           "dispatch": 190, "decoder.step": 200}
    assert spans.host_idle_share(tr) == pytest.approx(590 / 1000)
    # the same gaps with the step's tail under the emit: a wait, not host work
    tr.records[5] = Record("decoder.emit", 500, 850, 1)
    assert spans.host_idle_share(tr) == pytest.approx(390 / 1000)
    # a gap outside every span is the harness's
    tr.records[0] = Record("StreamingDecoder.run.steps", 0, 60, -1)
    tr.records[1:] = [r._replace(parent=-1) if r.parent == 0 else r for r in tr.records[1:]]
    assert "StreamingDecoder.run.steps" not in spans.host_idle_by_span(tr)


def test_innermost_passes_over_a_closed_sibling():
    tr = _tracing()
    s = spans.Spans(tr.records)
    assert s.innermost(130) == 3 and s.innermost(310) == 1 and s.innermost(850) == 0
    assert s.innermost(1001) is None and s.innermost(-1) is None


def test_before_slice_readers_take_the_stretch_before_the_mark():
    recs = [Record("engine.microbatch", 0, 2_000_000, -1),
            Record("engine.microbatch", 3_000_000, 7_000_000, -1),
            Record("engine.microbatch", 8_000_000, 20_000_000, -1)]
    counted = {"engine.head_rows_used": 3, "engine.head_rows_computed": 8,
               "decoder.pages_live": 1, "decoder.pages_gathered": 4}
    tr = spans.Tracing(records=recs, mark=2, counted=counted,
                       counters={k: 2 * v for k, v in counted.items()})
    assert spans.mb_span_ms(tr) == pytest.approx(3.0)
    assert spans.head_row_share(tr) == pytest.approx(3 / 8)
    assert spans.page_live_share(tr) == pytest.approx(0.25)
    assert spans.step_span_ms(tr) is None
    tr.mark = None  # no slice: the whole window
    assert spans.mb_span_ms(tr) == pytest.approx(6.0)
    for read in (spans.mb_span_ms, spans.step_span_ms, spans.page_live_share,
                 spans.head_row_share, spans.prefill_device_share, spans.host_idle_share):
        assert read(None) is None
        assert read(spans.Tracing()) is None


class Event:
    """A kineto event as torch 2.11 gives it: no activity type."""

    def __init__(self, name, start, dur, corr, cuda=False, annotation=False):
        self._v = name, start, dur, corr, cuda, annotation

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[4] else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._v[5]


def test_slice_ends_matches_device_work_to_its_launch_call():
    trace.enable(True)
    with trace.span("decoder.prefill"):
        pass
    events = [Event("perfbench.slice", 0, 1000, 1, annotation=True),
              Event("decoder.prefill", 90, 200, 2, annotation=True),
              Event("aten::mm", 95, 10, 42),  # an op's own id, not a launch's
              Event("cudaGraphLaunch", 100, 30, 42),
              Event("cuLaunchKernelEx", 140, 5, 43),
              Event("decoder.prefill", 150, 40, 2, cuda=True, annotation=True),  # its mirror
              Event("gemm", 150, 40, 42, cuda=True), Event("relu", 190, 10, 42, cuda=True),
              Event("scan", 200, 20, 43, cuda=True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    tr = spans.Tracing()
    spans.slice_ends(tr, prof)
    assert (tr.lo, tr.hi) == (0, 1000)
    assert tr.launches == {42: 100, 43: 140}
    assert tr.device == [(150, 190, 42), (190, 200, 42), (200, 220, 43)]
    assert tr.mirrors == [("decoder.prefill", 90, 290)]


def test_slice_ends_reads_the_slice_and_the_mirrors_of_a_cpu_profiler():
    # the first range of a process initialises the profiler's op
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.profiler.record_function("first"):
            pass
    trace.enable(True)
    tr = spans.Tracing()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("perfbench.slice"):
            for _ in range(5):
                with trace.span("decoder.step"):
                    torch.ones(64).sum()
    spans.slice_ends(tr, prof)
    assert not trace.enabled()
    assert tr.lo is not None and tr.hi > tr.lo and tr.device == []
    assert [n for n, _, _ in tr.mirrors] == ["decoder.step"] * 5
    gaps = span_run.mirror_gaps(tr, "decoder.step")
    assert len(gaps) == 5 and all(abs(a) < 500_000 and abs(b) < 500_000 for a, b in gaps)
    assert spans.host_idle_share(tr) is None  # no device in a CPU trace


# ---------------------------------------------------------------------------
# whole runs on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def hooked(monkeypatch):
    """The harness with the calls of ``spans`` set in (``span_run.install``);
    yields the list of each run's context."""
    return span_run.install("traced", monkeypatch.setattr)


READS = {"falcon-mamba-7b.serve-mixed": (spans.mb_span_ms, spans.head_row_share),
         "stablelm-1.6b.serve-bursty": (spans.mb_span_ms, spans.head_row_share),
         "stablelm-1.6b.decode-chat": (spans.step_span_ms, spans.page_live_share)}


@pytest.mark.parametrize("name", list(READS))
def test_a_traced_run_reads_its_spans_and_counters(name, hooked):
    over = OVERRIDES[name]
    seconds = SECONDS[name]
    if "serve" in name:  # the slice from 1.25 s: micro-batches run before it (or,
        # on a host that stalls, it never opens and the readers take the window)
        over = dict(over, cell=dict(over["cell"], trace_s=0.5))
        seconds = 3.0
    out = harness.run_cell(name, SEED, seconds, True, device="cpu", overrides=over)
    assert out["correct"], out["compared"]
    (ctx,) = hooked
    ms, share = (f(ctx.tracing) for f in READS[name])
    assert ms is not None and 0 < ms < 60_000
    assert share is not None and 0 < share <= 1
    assert not trace.enabled()
    got = span_run.readings(ctx.tracing)  # what the script prints
    assert got[READS[name][0].__name__] == ms and got[READS[name][1].__name__] == share


@pytest.mark.parametrize("name", ["stablelm-1.6b.serve-bursty"])
def test_an_untraced_run_leaves_the_tracer_off(name, hooked):
    out = harness.run_cell(name, SEED, SECONDS[name], False, device="cpu",
                           overrides=OVERRIDES[name])
    assert out["correct"], out["compared"]
    (ctx,) = hooked
    assert not hasattr(ctx, "tracing")
    assert not trace.enabled() and trace.records() == [] and trace.counters() == {}
