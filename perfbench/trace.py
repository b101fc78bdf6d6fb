"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over a fixed
steady slice in the middle of the window, read straight from the kineto
events (no event tree is built).

From the device events inside the slice it gives the busy time (the union
of kernel, copy and set intervals), the time by kernel, the top device
operations and the longest idle gaps labelled by the innermost host event
that covered them.  Kernel calls are matched to their device time for the
roofline shares: in an eager run the i-th observed call of an op is its
kernel's i-th launch in the slice; a CUDA graph's calls are those its
capture made, times its replays in the slice.
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from perfbench import costs

# the port's kernels by the name of their __global__ function
KERNEL_OPS = {
    "bank_wgmma_kernel": "bank_matmul", "bank_matmul_kernel": "bank_matmul",
    "flash_mma_kernel": "flash_attention", "flash_kernel": "flash_attention",
    "mamba_scan_kernel": "mamba_scan", "gather_kernel": "page_gather",
    "decode_kernel": "decode_attention",
}



def _annotation(e) -> bool:
    """A ``record_function`` range (on the host, or mirrored on the
    device), not work; read by whichever accessor this torch has."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return "user_annotation" in kind()
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def kernel_base(name: str) -> str:
    """A device event's function name without return type, template
    arguments, parameters or the namespaces of the port's kernels (an
    anonymous one, and a route's inside it): "void (anonymous
    namespace)::tc::bank_wgmma_kernel<...>(...)" -> "bank_wgmma_kernel";
    library kernels keep their namespaces."""
    head = name[5:] if name.startswith("void ") else name
    head = head.replace("(anonymous namespace)", "{anon}")
    head = head.split("<", 1)[0].split("(", 1)[0].strip()
    return head.rsplit("::", 1)[-1] if head.startswith("{anon}::") else head


def op_of(name: str):
    return KERNEL_OPS.get(kernel_base(name))


@dataclasses.dataclass
class Summary:
    window_s: float = 0.0
    busy_s: float = 0.0
    by_kernel: dict = dataclasses.field(default_factory=dict)  # name -> seconds
    by_op: dict = dataclasses.field(default_factory=dict)  # op -> [durations in order]
    idle_gaps: list = dataclasses.field(default_factory=list)  # [(label, seconds)]
    rooflines: dict = dataclasses.field(default_factory=dict)  # op -> (bound_s, time_s)
    useful_flops: float = 0.0


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    cuda = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    return profile(activities=[ProfilerActivity.CPU, *cuda])


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Slice:
    """Starts the profiler at ``start`` and stops it at ``stop`` (seconds
    into the window), driven by :meth:`tick` between units of work."""

    def __init__(self, start_s: float, stop_s: float, enabled: bool):
        self.start_s, self.stop_s, self.enabled = start_s, stop_s, enabled
        self.state = "before"
        self.prof = None
        self.mark = None
        self.calls: list = []  # (op, args as Specs) observed in the slice
        self.on_start = []  # callbacks at the start and the stop
        self.on_stop = []

    def prepare(self) -> None:
        """Start and stop the profiler once before the window: its first
        start initialises CUPTI, which took seconds on the card."""
        if self.enabled:
            with _profiler():
                _sync()

    @property
    def open(self) -> bool:
        return self.state == "open"

    def tick(self, now_s: float) -> None:
        if not self.enabled:
            return
        if self.state == "before" and now_s >= self.start_s:
            self.prof = _profiler()
            self.prof.start()
            _sync()
            self.mark = torch.profiler.record_function("perfbench.slice")
            self.mark.__enter__()
            self.state = "open"
            for f in self.on_start:
                f()
        elif self.state == "open" and now_s >= self.stop_s:
            self.close()

    def close(self) -> None:
        if self.state != "open":
            return
        _sync()
        for f in self.on_stop:
            f()
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        self.state = "done"

    def observer(self, name, body, args, kwargs):
        """An ``ops.observed`` observer: records each call while open."""
        if self.open:
            self.calls.append((name, tuple(costs.Spec.of(a) if isinstance(a, torch.Tensor)
                                           else a for a in args),
                               {k: v for k, v in kwargs.items()
                                if not isinstance(v, torch.Tensor)}))
        return body(*args, **kwargs)

    # -- reading ----------------------------------------------------------------

    def summary(self) -> Summary:
        out = Summary()
        if self.state != "done":
            return out
        events = self.prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        lo = hi = None
        dev, host, marks = [], [], set()
        for e in events:
            span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            if e.device_type() == cuda:
                if not _annotation(e):
                    dev.append(span)
            elif span[2] == "perfbench.slice":
                lo, hi = span[0], span[1]
            else:
                host.append(span)
                if _annotation(e):
                    marks.add(span[2])
        # a host range is mirrored on the device under its own name
        dev = [d for d in dev if d[2] not in marks and d[2] != "perfbench.slice"]
        if lo is None:
            return out
        dev = sorted((max(a, lo), min(b, hi), n) for a, b, n in dev if b > lo and a < hi)
        out.window_s = (hi - lo) * 1e-9
        busy, gaps, cur_end = 0, [], lo
        for a, b, n in dev:
            if a > cur_end:
                gaps.append((cur_end, a))
            busy += max(0, b - max(a, cur_end))
            cur_end = max(cur_end, b)
            out.by_kernel[n] = out.by_kernel.get(n, 0.0) + (b - a) * 1e-9
            op = op_of(n)
            if op is not None:
                out.by_op.setdefault(op, []).append((b - a) * 1e-9)
        if hi > cur_end:
            gaps.append((cur_end, hi))
        out.busy_s = busy * 1e-9
        out.idle_gaps = label_gaps(gaps, host)
        return out


def label_gaps(gaps: list, host: list) -> list:
    """[(label, seconds)]: each idle gap's seconds under the innermost host
    event covering its middle (``host`` for none), summed by label, longest
    first."""
    host = sorted(host)
    totals: collections.Counter = collections.Counter()
    stack: list = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        totals[stack[-1][2] if stack else "host"] += (b - a) * 1e-9
    return totals.most_common(10)


def eager_rooflines(summary: Summary, calls: list) -> dict:
    """{op: (bound_s, time_s)} over the calls above the L2 cache, the i-th
    observed call of an op matched to its kernel's i-th launch; an op whose
    counts disagree, or with no call above the L2, gets none."""
    out = {}
    by_op: dict = {}
    for name, args, kwargs in calls:
        by_op.setdefault(name, []).append((args, kwargs))
    for op, seen in by_op.items():
        times = summary.by_op.get(op, [])
        if op not in costs.COSTS or len(times) != len(seen):
            continue
        bound = time = 0.0
        for (args, kwargs), t in zip(seen, times):
            c = costs.COSTS[op](*args, **kwargs)
            if costs.above_l2(c):
                bound += costs.bound_s(op, c)
                time += t
        if time > 0:
            out[op] = (bound, time)
    return out
