"""CUDA graphs of the decode steps: the port's counterpart of the JAX
package's jitted decode steps (``StreamingDecoder._fn``'s cache of one
``jax.jit`` per step kind, and the jitted ``step_unpaged`` of
``EdgeExecutor.serve_decode``).

A :class:`StepGraph` captures one call of a step body on *fixed* arguments
(params and bank trees, the pool or cache), which every replay must be
handed again as the same objects, and on int32 host inputs (page tables,
lengths, tokens), which every replay uploads in one copy into a static
device buffer.  The body writes its pool or cache in place; a body that
returns other pool or cache tensors than it was given fails the capture
(:func:`check_in_place`).  The outputs live in the memory pool that every
graph of one :class:`StepGraphs` shares, so the next replay of any of them
may overwrite them: callers copy out what they keep first.

The kernel wrappers count their launches in Python (``ops.kernel_launches``,
``ops.route_launches``), so a replay is invisible to them.  A graph records
the launches its body made at capture, takes them back off (a capture
launches nothing) and adds them on every replay: a graphed run counts what
the same steps run eagerly count.

There is no eager fallback: a step that fails to capture or replay raises.
Capture a shape only after one eager launch of it (the callers' warm-ups):
that sizes ``decode_attention``'s counters and warms cuBLAS.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.utils.tree import flatten_paths


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [v for _, v in sorted(flatten_paths(tree).items()) if isinstance(v, torch.Tensor)]


def check_in_place(given, returned, what: str) -> None:
    """Raise unless ``returned`` holds exactly the tensors of ``given`` (a
    pool or cache a step was meant to write in place)."""
    a, b = _leaves(given), _leaves(returned)
    if len(a) != len(b) or any(x is not y for x, y in zip(a, b)):
        raise RuntimeError(f"{what}: the step returned new state tensors; a captured step "
                           "must write its pool or cache in place")


@contextlib.contextmanager
def uncounted():
    """Take the kernel launches made inside back off the counters (a
    capture launches nothing; the eager run that readies one is not a step
    of the run).  Yields the dict of what was taken off."""
    taken: dict = {}
    before = ops.launch_counters()
    try:
        yield taken
    finally:
        after = ops.launch_counters()
        taken.update({k: n - before.get(k, 0) for k, n in after.items()
                      if n != before.get(k, 0)})
        ops.add_launch_counters(taken, -1)


def _same(a, b) -> bool:
    """The same objects, tuples compared element by element."""
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a is b


class StepGraph:
    """One captured call ``body(*fixed, *inputs)``; ``inputs`` are int32
    device views of one static buffer, of ``shapes``.  ``replays`` counts
    this graph's replays."""

    def __init__(self, body: Callable, fixed: tuple, shapes: tuple, device, pool):
        self.fixed = fixed
        self.replays = 0
        self.shapes = tuple(tuple(int(d) for d in s) for s in shapes)
        sizes = [int(np.prod(s)) for s in self.shapes]
        self.buf = torch.zeros(sum(sizes), dtype=torch.int32, device=device)
        offs = np.cumsum([0] + sizes)
        self.inputs = tuple(self.buf[a:b].view(s)
                            for a, b, s in zip(offs[:-1], offs[1:], self.shapes))
        self.graph = torch.cuda.CUDAGraph()
        with uncounted() as self.launches:
            with torch.cuda.graph(self.graph, pool=pool):
                self.out = body(*fixed, *self.inputs)

    def replay(self, host: tuple) -> Any:
        flat = np.concatenate([np.asarray(a, dtype=np.int32).reshape(-1) for a in host])
        # from pageable memory the copy stages the bytes before it returns,
        # so ``flat`` may go; it is ordered before the replay on the stream
        self.buf.copy_(torch.from_numpy(flat), non_blocking=True)
        self.graph.replay()
        ops.add_launch_counters(self.launches)
        self.replays += 1
        return self.out


class StepGraphs:
    """The captured steps of one decoder or decode lane, keyed by the
    caller, sharing one memory pool; ``captures`` and ``replays`` count."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self._graphs: dict = {}
        self.captures = 0
        self.replays = 0

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def items(self) -> list:
        """[(key, StepGraph)] of the graphs held now."""
        return list(self._graphs.items())

    def clear(self) -> None:
        """Drop every graph (the fixed arguments they hold go with them)."""
        self._graphs.clear()

    def capture(self, key, body: Callable, fixed: tuple, shapes: tuple) -> None:
        """Capture ``body`` under ``key`` unless a graph is held there."""
        if key not in self._graphs:
            self._graphs[key] = StepGraph(body, fixed, shapes, self.device, self.pool)
            self.captures += 1

    def replay(self, key, fixed: tuple, host: tuple) -> Any:
        """Replay the graph captured under ``key`` with the int32 host
        arrays ``host``; ``fixed`` must be the objects it was captured with.
        Returns the body's outputs, valid until the next replay."""
        g = self._graphs[key]
        if not _same(fixed, g.fixed):
            raise RuntimeError(f"captured step {key!r}: its fixed arguments changed "
                               "without a new key")
        if tuple(tuple(np.shape(a)) for a in host) != g.shapes:
            raise RuntimeError(f"captured step {key!r}: input shapes {g.shapes} expected")
        out = g.replay(host)
        self.replays += 1
        return out
