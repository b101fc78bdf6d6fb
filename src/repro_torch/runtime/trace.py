"""Spans and counters of the program, on the profiler's clock.

One tracer for the serving tiers.  While it is off (the default) a span
site costs one module-level flag check and returns one shared no-op
object: no clock is read, nothing is kept and ``torch.profiler`` is never
touched.  While it is on:

* :func:`span` keeps ``(name, start_ns, end_ns, parent)`` in memory,
  ``parent`` the index of the enclosing span (-1 at the top).  Times come
  from the injected clock (``time.perf_counter_ns``), moved once at
  :func:`enable` onto the Unix clock that kineto stamps host events with,
  so a span and the device events of the same instant compare directly.
  While a profiler runs, the span also enters ``record_function(name)``:
  the profiler's trace carries it under the same name, its mirror
  enclosing the span (the clock is read inside the range);
* :func:`count` adds to a named counter.

Spans live in memory and are read by whoever enabled them: nothing is
written out.  The tracer is for one thread, as the serve and decode loops
are.  Its counters stay out of the engine's and the decoder's ``stats``,
which the parity tests hold equal, key for key, to the JAX package's.

Sites (``serving/executor.py``, ``serving/decode.py``), each read by a
reader of ``perfbench/spans.py`` or by ``chip_smoke.py``'s
``profile_lane`` (the two lanes): ``engine.serve``, ``engine.microbatch``
and its child ``engine.wait``; ``StreamingDecoder.run.steps``,
``decoder.step`` and its children ``decoder.prefill`` / ``decoder.emit``;
``EdgeExecutor.serve_decode.lane``.  Counters:
``engine.head_rows_computed`` / ``engine.head_rows_used`` and
``decoder.pages_gathered`` / ``decoder.pages_live``.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]  # None while the span is open
    parent: int  # index of the enclosing span in records(); -1 at the top


_on = False
_records: list = []  # [name, start_ns, end_ns, parent], in start order
_counters: dict = {}
_stack: list = []  # indices of the open spans, innermost last
_clock: Callable[[], int] = time.perf_counter_ns
_offset = 0  # Unix ns less clock ns, measured at enable


def enable(on: bool = True, clock: Callable[[], int] = time.perf_counter_ns,
           unix: Callable[[], int] = time.time_ns) -> None:
    """Turn the tracer on or off.  On, ``clock`` (ns) times the spans and
    its offset to ``unix`` (the Unix clock in ns) is measured once here."""
    global _on, _clock, _offset
    if on:
        a = clock()
        u = unix()
        b = clock()
        _clock, _offset = clock, u - (a + b) // 2
    _on = on


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every span and counter."""
    _records.clear()
    _counters.clear()
    _stack.clear()


def records() -> list:
    """[:class:`Record`] in the order the spans started."""
    return [Record(*r) for r in _records]


def counters() -> dict:
    return dict(_counters)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (nothing while off)."""
    if _on:
        _counters[name] = _counters.get(name, 0) + n


class _Off:
    """The span of a tracer that is off: enters and leaves, keeps nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("_rec", "_index", "_range")

    def __init__(self, name: str):
        self._rec = [name, 0, None, -1]
        self._index = -1
        self._range = None

    def __enter__(self):
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self._rec[0])
            self._range.__enter__()
        self._rec[3] = _stack[-1] if _stack else -1
        self._index = len(_records)
        _stack.append(self._index)
        _records.append(self._rec)
        self._rec[1] = _clock() + _offset
        return self

    def __exit__(self, *exc) -> None:
        self._rec[2] = _clock() + _offset
        if _stack and _stack[-1] == self._index:
            _stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)


def span(name: str):
    """A context manager timing the code it encloses as span ``name``."""
    if not _on:
        return _OFF
    return _Span(name)

