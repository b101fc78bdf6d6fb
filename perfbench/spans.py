"""Readers of the program's spans and counters (``repro_torch.runtime.trace``)
in a traced run, and the two calls that feed them.

A traced run turns the tracer on where its window starts and marks where
the profiler's slice starts (:func:`on_window_start`, after
``Context.window_starts``), and hands the records, counters and the
profiler's events to ``ctx.tracing`` before the slice is dropped
(:func:`on_loop_end`, after the cell's loop).  An untraced run calls
neither, so its tracer stays off.  ``perfbench/harness.py`` does not make
these calls yet: ``perfbench/span_run.py`` sets them in its place and
prints what the readers read.

The span and counter metrics read the stretch of the window before the
slice (the counters as they stood where it started), as the harness's
counter metrics do: profiled, eager serve runs slower.  The slice metrics
read the profiler's events against the spans inside the slice; the spans
are on the clock of the profiler's host events, so they compare directly:

* a kernel (or copy, or set) belongs to the innermost span that enclosed
  its launch call, matched to the call by the kineto correlation id (the
  call of a graph's kernels is its ``cudaGraphLaunch``);
* an idle gap of the device belongs to the innermost span covering its
  middle; a gap under no span is the harness's own (its sleeps between
  arrivals, its callbacks between serve calls) and is not the program's.

Each reader takes a :class:`Tracing` (or None) and returns a number or
None where there is nothing to read.
"""
from __future__ import annotations

import bisect
import dataclasses
import statistics
from typing import Optional

# spans in which the host waits for the device: idle there is not host work
WAITS = ("engine.wait", "decoder.emit")
# the host calls that launch device work are CUDA API calls (cudaLaunchKernel,
# cudaGraphLaunch, cuLaunchKernel, ...); kineto gives such a call the
# correlation id of the device work it launched (torch 2.11's events carry no
# activity type to tell them by)
LAUNCH_PREFIX = "cu"


@dataclasses.dataclass
class Tracing:
    records: list = dataclasses.field(default_factory=list)  # trace.Record, whole window
    mark: Optional[int] = None  # len(records) where the slice started
    counted: dict = dataclasses.field(default_factory=dict)  # counters there
    counters: dict = dataclasses.field(default_factory=dict)  # at the slice's end
    lo: Optional[int] = None  # the slice, ns on the profiler's clock
    hi: Optional[int] = None
    device: list = dataclasses.field(default_factory=list)  # (start, end, correlation)
    launches: dict = dataclasses.field(default_factory=dict)  # correlation -> host ns
    mirrors: list = dataclasses.field(default_factory=list)  # (name, start, end) ranges

    def before(self) -> list:
        """The records of the stretch before the slice (all of them where
        no slice started)."""
        return self.records if self.mark is None else self.records[:self.mark]

    def counted_before(self) -> dict:
        return self.counters if self.mark is None else self.counted


def on_window_start(ctx) -> None:
    """At the window's start of a traced run: forget what the tracer held,
    turn it on, and mark the records where the slice starts."""
    from repro_torch.runtime import trace

    trace.reset()
    trace.enable(True)
    ctx.tracing = Tracing()
    ctx.slice.on_start.append(lambda: slice_starts(ctx.tracing))


def on_loop_end(ctx) -> None:
    """After the cell's loop, before the slice is dropped: hand the records,
    the counters and the slice's events (if it ran) to ``ctx.tracing``."""
    slice_ends(ctx.tracing, ctx.slice.prof if ctx.slice.state == "done" else None)


def slice_starts(tr: Tracing) -> None:
    from repro_torch.runtime import trace

    tr.mark = len(trace.records())
    tr.counted = trace.counters()


def slice_ends(tr: Tracing, prof) -> None:
    """Take the tracer's records and counters, turn it off, and read the
    slice's events from the stopped profiler ``prof`` (None: no slice)."""
    import torch

    from perfbench.trace import _annotation
    from repro_torch.runtime import trace

    tr.records, tr.counters = trace.records(), trace.counters()
    trace.enable(False)
    if prof is None:
        return
    names = {r.name for r in tr.records}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        a, b, n = e.start_ns(), e.start_ns() + e.duration_ns(), e.name()
        if e.device_type() == cuda:
            if not _annotation(e):
                tr.device.append((a, b, e.correlation_id()))
        elif n == "perfbench.slice":
            tr.lo, tr.hi = a, b
        elif _annotation(e):
            if n in names:
                tr.mirrors.append((n, a, b))
        elif n.startswith(LAUNCH_PREFIX):
            tr.launches[e.correlation_id()] = a


# -- the stretch before the slice ---------------------------------------------


def mean_span_ms(tr: Optional[Tracing], name: str) -> Optional[float]:
    """Mean duration in ms of the closed spans ``name`` before the slice."""
    if tr is None:
        return None
    d = [r.end_ns - r.start_ns for r in tr.before() if r.name == name and r.end_ns is not None]
    return statistics.fmean(d) * 1e-6 if d else None


def counter_share(tr: Optional[Tracing], part: str, whole: str) -> Optional[float]:
    """``part`` over ``whole`` of the counters where the slice started."""
    if tr is None:
        return None
    c = tr.counted_before()
    return c.get(part, 0) / c[whole] if c.get(whole) else None


def mb_span_ms(tr):
    return mean_span_ms(tr, "engine.microbatch")


def step_span_ms(tr):
    return mean_span_ms(tr, "decoder.step")


def page_live_share(tr):
    return counter_share(tr, "decoder.pages_live", "decoder.pages_gathered")


def head_row_share(tr):
    return counter_share(tr, "engine.head_rows_used", "engine.head_rows_computed")


# -- the slice -------------------------------------------------------------


class Spans:
    """The innermost span covering an instant, over records that nest
    (one thread) and whose parents are indices into the same list."""

    def __init__(self, records: list):
        self.records = records
        self.starts = [r.start_ns for r in records]

    def innermost(self, t: int) -> Optional[int]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            r = self.records[i]
            if r.end_ns is not None and r.end_ns >= t:
                return i
            i = r.parent
        return None

    def under(self, i: Optional[int], name: str) -> bool:
        """Span ``i`` is ``name`` or lies inside one."""
        while i is not None and i >= 0:
            if self.records[i].name == name:
                return True
            i = self.records[i].parent
        return False


def _in_slice(tr: Tracing) -> list:
    """The slice's device intervals, clipped to it."""
    return [(max(a, tr.lo), min(b, tr.hi), c) for a, b, c in tr.device
            if b > tr.lo and a < tr.hi]


def device_share_under(tr: Optional[Tracing], name: str) -> Optional[float]:
    """Of the device time in the slice, the share launched inside span
    ``name`` (or a span inside one)."""
    if tr is None or tr.lo is None or not tr.device:
        return None
    spans = Spans(tr.records)
    total = part = 0
    for a, b, c in _in_slice(tr):
        total += b - a
        t = tr.launches.get(c)
        if t is not None and spans.under(spans.innermost(t), name):
            part += b - a
    return part / total if total else None


def idle_gaps(tr: Tracing) -> list:
    """[(start, end)] of the slice where no device work ran."""
    gaps, cur = [], tr.lo
    for a, b, _ in sorted(_in_slice(tr)):
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if tr.hi > cur:
        gaps.append((cur, tr.hi))
    return gaps


def host_idle_by_span(tr: Optional[Tracing]) -> dict:
    """{span name: ns of the slice's idle gaps whose middle lies in it
    innermost}; gaps under no span are left out."""
    if tr is None or tr.lo is None or not tr.device:
        return {}
    spans = Spans(tr.records)
    out: dict = {}
    for a, b in idle_gaps(tr):
        i = spans.innermost((a + b) // 2)
        if i is not None:
            n = tr.records[i].name
            out[n] = out.get(n, 0) + (b - a)
    return out


def host_idle_share(tr: Optional[Tracing]) -> Optional[float]:
    """The share of the slice in which the device idled while the program
    did host work: gaps whose middle lies innermost in a span other than
    the waits (:data:`WAITS`), over the slice."""
    if tr is None or tr.lo is None or not tr.device:
        return None
    idle = host_idle_by_span(tr)
    return sum(v for n, v in idle.items() if n not in WAITS) / (tr.hi - tr.lo)


def prefill_device_share(tr):
    return device_share_under(tr, "decoder.prefill")

