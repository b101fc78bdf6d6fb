"""Streaming decode serving: paged KV cache + continuous batching over a
merged ParamStore (the port of ``repro.serving.decode``).

A merged group shares one physical trunk, so token-by-token generation for
EVERY member advances in a single trunk dispatch per step, with the private
unembed heads fanned out through the suffix bank (one ``ops.bank_matmul``
dispatch).  The KV side mirrors the weight side's page discipline:

* :class:`PagedKVPool` — fixed-size pages in one device-resident pool
  (``transformer.init_kv_pool`` layout), per-request page tables, a free
  list, and worst-case page *reservations* at admission so an admitted
  request can never hit pool exhaustion mid-decode.  The accounting identity
  ``allocated == in_flight + freed`` is an invariant.
* :class:`StreamingDecoder` — the continuous-batching loop: every step
  admits queued requests into free slots, advances each shared-prefix
  group's live rows by one token (prompt tokens are consumed through the
  same decode path, mixed prefill/decode), and retires finished requests —
  never draining the in-flight batch.
* a store rebinding (``ParamStore.merge_group`` / ``unmerge``) moves the
  store's binding epoch; the decoder notices on its next step, bumps every
  pool's epoch once, and re-reads ``prefix_groups()`` so re-merged trunks
  coalesce immediately.  In-flight page tables and lengths survive.

Over a store with a mesh placement (DESIGN.md S3) the bank fan-out runs
through the engine's shard-local wrapper (``maybe_shard_bank``: one
``bank_matmul`` launch per shard at the local member count), and each
admission credits its load's bytes to the shards they land on
(``AsyncDMA.account``).  Where the JAX package jits each step kind once
(``_fn``), the decoder on a CUDA device replays a CUDA graph per
(kind, callable, chunk, group, bucket, store epoch) (``serving.graphs``):
the group step (trunk + bank or heads), the singleton step and each
prefill chunk.  The pools are written in place and never reallocated, so a
graph binds them for its life; an epoch move drops every graph.  On the
CPU, and over a mesh of several distinct devices (a captured graph runs on
one), the same step bodies run eagerly.

Paged == unpaged contract: the paged path gathers pages into exactly the
contiguous ``init_cache`` layout (Smax = max_len) and both paths route
attention through ``ops.decode_attention`` (a recurrent or hybrid family
reads its whole state from one slot and runs the same layers on it), so
every generated token and its logits match a standalone unpaged
``decode_step`` replay of the same request (:func:`verify_bitwise`)
wherever the products and reductions give the same bits for a row at
batch 1 and at the bucket's batch.
"""
from __future__ import annotations

import dataclasses
import functools
import types
import weakref
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.runtime import trace
from repro_torch.serving.executor import MergeAwareEngine
from repro_torch.serving.graphs import StepGraphs, check_in_place, uncounted
from repro_torch.serving.workload import bucket_for
from repro_torch.utils.tree import flatten_paths


@dataclasses.dataclass
class DecodeRequest:
    instance_id: str
    prompt: Any  # (S,) int token ids
    max_new_tokens: int
    arrival_s: float = 0.0
    deadline_s: float = float("inf")
    meta: Any = None


@dataclasses.dataclass
class DecodeCompletion:
    request: DecodeRequest
    tokens: list  # generated token ids (greedy argmax, len == max_new_tokens)
    finished_s: float
    steps: int = 0  # engine steps this request was live for
    logits: Optional[list] = None  # per-token float32 logits rows (record_logits)
    admit_epoch: int = -1
    retire_epoch: int = -1


class PoolExhausted(RuntimeError):
    """A page allocation failed — only reachable if the reservation
    discipline is bypassed (admitting without ``can_admit``)."""


class PagedKVPool:
    """Page ownership for one device-side KV pool.

    The arrays live here: ``k``/``v`` (L, P, page, Hs, D) for a KV pool, or
    dicts of per-layer-kind arrays for a recurrent or hybrid state pool
    (``device`` is read from the first leaf).  Tables map a live request id
    to the ordered page list backing its sequence.  Admission
    RESERVES the worst case (ceil((prompt + max_new) / page)) so ``ensure``
    can always extend a live request; pages allocate lazily as the sequence
    grows and return to the free list on :meth:`release`.

    ``epoch`` is the rebinding invalidation counter: the decoder bumps it
    once per store binding epoch move — live tables survive (KV state is
    request state, not weight-derived cache), but anything derived per epoch
    must re-key on it.
    """

    def __init__(self, init_pool: Callable, num_pages: int, page_size: int):
        kv = init_pool(num_pages, page_size)
        self.k, self.v = kv["k"], kv["v"]
        leaf = self.k
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        self.device = getattr(leaf, "device", None)
        self.num_pages = num_pages
        self.page_size = page_size
        # pop() takes from the tail: keep it ascending so early requests get
        # low page ids (deterministic, easy to eyeball in tests)
        self._free = list(range(num_pages - 1, -1, -1))
        self.tables: dict = {}  # rid -> [page_idx, ...] (live requests only)
        self._reserved: dict = {}  # rid -> worst-case page count
        self.allocated_pages = 0  # lifetime pages handed out
        self.freed_pages = 0  # lifetime pages returned
        self.high_water = 0
        self.epoch = 0

    # -- accounting -----------------------------------------------------------

    def in_flight_pages(self) -> int:
        return sum(len(t) for t in self.tables.values())

    def identity_ok(self) -> bool:
        """allocated == in_flight + freed, free list consistent, and no page
        referenced by two live requests."""
        live = [p for t in self.tables.values() for p in t]
        return (self.allocated_pages == self.in_flight_pages() + self.freed_pages
                and len(live) == len(set(live))
                and not (set(live) & set(self._free))
                and len(self._free) + len(live) == self.num_pages)

    def pages_for(self, tokens: int) -> int:
        return -(-max(tokens, 1) // self.page_size)  # ceil, min 1

    def _available(self) -> int:
        """Free pages not spoken for by live requests' outstanding
        reservations — the admission headroom that guarantees no mid-flight
        exhaustion."""
        outstanding = sum(
            max(0, self._reserved[r] - len(self.tables[r]))
            for r in self.tables)
        return len(self._free) - outstanding

    def can_admit(self, tokens: int) -> bool:
        return self._available() >= self.pages_for(tokens)

    # -- lifecycle ------------------------------------------------------------

    def admit(self, rid, tokens: int) -> None:
        if rid in self.tables:
            raise ValueError(f"request {rid} already admitted")
        need = self.pages_for(tokens)
        if self._available() < need:
            raise PoolExhausted(f"admit({rid}): {need} pages reserved, "
                                f"{self._available()} available")
        self.tables[rid] = []
        self._reserved[rid] = need
        self.ensure(rid, min(tokens, self.page_size))  # first page up front

    def ensure(self, rid, tokens: int) -> None:
        """Grow ``rid``'s table until it covers ``tokens`` positions."""
        table = self.tables[rid]
        while len(table) * self.page_size < tokens:
            if not self._free:
                raise PoolExhausted(f"ensure({rid}): free list empty")
            table.append(self._free.pop())
            self.allocated_pages += 1
        self.high_water = max(self.high_water, self.in_flight_pages())

    def release(self, rid) -> None:
        pages = self.tables.pop(rid)
        self._reserved.pop(rid, None)
        self.freed_pages += len(pages)
        # return in reverse so the free list stays roughly LRU-ordered
        self._free.extend(reversed(pages))

    def bump_epoch(self) -> None:
        self.epoch += 1

    def table_rows(self, rids: list, max_pages: int) -> np.ndarray:
        """(B, max_pages) int32 page-table rows, short tables padded with
        page 0 — padding entries are only ever READ by the gather and their
        contents are masked by decode attention."""
        out = np.zeros((len(rids), max_pages), np.int32)
        for i, rid in enumerate(rids):
            t = self.tables[rid]
            out[i, : len(t)] = t
        return out


@dataclasses.dataclass
class _Slot:
    rid: int
    request: DecodeRequest
    prompt: list
    pos: int = 0  # prompt tokens consumed so far
    length: int = 0  # tokens written to KV so far
    last_token: int = 0
    out_tokens: list = dataclasses.field(default_factory=list)
    logits: Optional[list] = None
    steps: int = 0
    admit_epoch: int = 0

    @property
    def next_input(self) -> int:
        return (self.prompt[self.pos] if self.pos < len(self.prompt)
                else self.last_token)

    @property
    def finished(self) -> bool:
        return len(self.out_tokens) >= self.request.max_new_tokens


class StreamingDecoder:
    """Continuous-batching decode loop over a :class:`MergeAwareEngine`.

    Every :meth:`step`:

    1. (caller-driven via :meth:`run`) admit queued requests into free slots
       — FIFO, gated on ``max_slots`` AND a worst-case page reservation in
       the pool, with ``Scheduler.load`` + the engine's ``AsyncDMA`` paying
       the instance's incremental residency bytes;
    2. for each shared-prefix group with live slots: ONE ``trunk_step``
       dispatch advances all of the group's rows by one token (padded onto
       the bucket ladder by replicating the last real row — duplicate
       identical page writes are deterministic, outputs discarded), then ONE
       ``bank_head`` dispatch fans out every member's private head
       (per-member heads when the group isn't bank-congruent; singletons run
       the fused paged ``step``);
    3. retire finished requests — pages released, completion recorded —
       without ever draining the rest of the batch.

    Prompt tokens stream through the same decode path one per step: a
    request with prompt S and N new tokens is live for S + N - 1 steps.

    **Chunked prefill admission** (``chunked_prefill=True``): slots still
    consuming their prompt fast-forward up to ``page_size`` prompt tokens
    per step in ONE ``prefill_chunk`` dispatch before the group's normal
    single-token step.  The LAST prompt token always goes through the normal
    step: it emits the first generated token.  Chunk dispatches are counted
    in ``prefill_chunk_dispatches``, never in ``trunk_dispatches``.

    Tokens are the argmax over the full padded vocab, taken on the device
    (the first maximal index, as ``np.argmax``); only the token ids, and
    with ``record_logits`` the emitted rows, cross to the host.

    On a CUDA device every dispatch above is a replay of a captured graph
    (``graphs``: its ``captures`` and ``replays``); the warm-up captures the
    shapes it can foresee, and a shape first met in the run (a new group
    after an epoch move, a new set of members for per-member heads) is run
    once eagerly on a scratch pool, then captured.
    """

    def __init__(self, engine: MergeAwareEngine, page_size: int = 8,
                 num_pages: int = 128, max_slots: int = 8,
                 max_len: int = 32, buckets: Optional[tuple] = None,
                 record_logits: bool = False,
                 chunked_prefill: bool = False,
                 clock: Optional[Callable[[], float]] = None):
        if max_len % page_size:
            raise ValueError("max_len must be a multiple of page_size")
        # weak: the engine keeps its last decoder, and a cycle between them
        # would leave the decoder's CUDA graphs to whenever the collector runs
        self._engine = weakref.ref(engine)
        self.store = engine.store
        # default to the engine's clock so one injected fake drives both
        self.clock = clock if clock is not None else engine.clock
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_slots = max_slots
        self.max_len = max_len
        self.max_pages = max_len // page_size
        self.buckets = tuple(sorted(b for b in (buckets or engine.buckets)
                                    if b <= max_slots)) or (max_slots,)
        self.record_logits = record_logits
        self.chunked_prefill = chunked_prefill
        self.queue: deque = deque()
        self.slots: dict = {}  # rid -> _Slot, insertion-ordered
        self.completions: list = []
        self._pools: dict = {}  # init_pool callable key -> PagedKVPool
        self._rid = 0
        self._t0 = self.clock()
        self._epoch = self.store.epoch
        device = next(iter(self.store.buffers.values())).device
        placement = self.store.placement
        one_device = placement is None or len(placement.mesh.distinct_devices) == 1
        self.graphs = StepGraphs(device) if device.type == "cuda" and one_device else None
        # trunk passes: one per trunk or singleton step dispatch and one per
        # token of a prefill-chunk dispatch -- each runs every trunk layer
        # once on one token per row -- in the warm-up and in the run
        self.trunk_passes = {"warmup": 0, "run": 0}
        self.stats = {
            "steps": 0, "tokens_decoded": 0, "prompt_tokens": 0,
            "trunk_dispatches": 0, "bank_dispatches": 0,
            "head_dispatches": 0, "singleton_dispatches": 0,
            "group_steps": 0, "admitted": 0, "retired": 0,
            "epoch_bumps": 0, "max_active": 0, "swap_survivors": 0,
            "prefill_chunks": 0, "prefill_chunk_tokens": 0,
            "prefill_chunk_dispatches": 0,
        }

    # -- plumbing -------------------------------------------------------------

    @property
    def engine(self) -> MergeAwareEngine:
        engine = self._engine()
        if engine is None:
            raise ReferenceError("the decoder's engine is gone")
        return engine

    def _decode(self, iid: str):
        dec = self.engine.programs[iid].decode
        if dec is None:
            raise ValueError(f"{iid}: program has no decode surface")
        return dec

    def _device(self, iid: str) -> torch.device:
        """The device that holds the instance's weights: pools, caches and
        step inputs go there."""
        params = self.store.materialize_cached(self.engine.programs[iid].model_id)
        return next(iter(flatten_paths(params).values())).device

    def pool_for(self, iid: str) -> PagedKVPool:
        dec = self._decode(iid)
        key = MergeAwareEngine._callable_key(dec.init_pool)
        pool = self._pools.get(key)
        if pool is None:
            init = functools.partial(dec.init_pool, device=self._device(iid))
            pool = PagedKVPool(init, self.num_pages, self.page_size)
            self._pools[key] = pool
        return pool

    def submit(self, req: DecodeRequest) -> int:
        self._decode(req.instance_id)  # validate up front
        need = len(req.prompt) + req.max_new_tokens - 1
        if need > self.max_len:
            raise ValueError(f"request needs {need} KV positions > "
                             f"max_len {self.max_len}")
        self.queue.append(req)
        return len(self.queue)

    def _admit(self) -> None:
        """FIFO admission into free slots, head-of-line blocking on pool
        headroom (no reordering — deadline fairness is the scheduler order's
        job, not the pool's)."""
        while self.queue and len(self.slots) < self.max_slots:
            req = self.queue[0]
            pool = self.pool_for(req.instance_id)
            need_tokens = len(req.prompt) + req.max_new_tokens - 1
            if not pool.can_admit(need_tokens):
                break
            self.queue.popleft()
            rid = self._rid
            self._rid += 1
            pool.admit(rid, need_tokens)
            r = self.engine.scheduler.load(req.instance_id, 1)
            self.engine.dma.wait((req.instance_id, "decode"), r["loaded_bytes"])
            self.engine.dma.account(r["loaded_bytes_by_shard"])
            self.slots[rid] = _Slot(
                rid, req, [int(t) for t in req.prompt],
                logits=[] if self.record_logits else None,
                admit_epoch=pool.epoch)
            self.stats["admitted"] += 1
        self.stats["max_active"] = max(self.stats["max_active"], len(self.slots))

    @staticmethod
    def _pad_rows(bucket: int, *arrays):
        """Pad each array to ``bucket`` rows by replicating its last row."""
        pad = bucket - len(arrays[0])
        if pad <= 0:
            return arrays
        return tuple(np.concatenate([a, np.repeat(a[-1:], pad, 0)]) for a in arrays)

    # -- the step -------------------------------------------------------------

    def step(self) -> None:
        """Advance every live row by one token (one trunk + one head fan-out
        dispatch per shared group), then retire finished requests.  The
        step is the span ``decoder.step``; its children are each prefill
        chunk (``decoder.prefill``) and each group step's token read
        (``decoder.emit``)."""
        with trace.span("decoder.step"):
            self._step()

    def _step(self) -> None:
        if self.store.epoch != self._epoch:
            # a rebinding landed: one pool epoch bump per store epoch move;
            # page tables and lengths survive — in-flight requests keep their
            # KV prefix and decode subsequent tokens under the new bindings
            for pool in self._pools.values():
                pool.bump_epoch()
            if self.graphs is not None:
                self.graphs.clear()  # they bind the old epoch's params and banks
            self._epoch = self.store.epoch
            self.stats["epoch_bumps"] += 1
            self.stats["swap_survivors"] += len(self.slots)
        groups = self.engine.prefix_groups()  # re-plans on epoch move
        for group in groups:
            slots = [s for s in self.slots.values()
                     if s.request.instance_id in group]
            if not slots:
                continue
            if self.chunked_prefill:
                chunk = [s for s in slots if len(s.prompt) - 1 - s.pos >= 2]
                if chunk:
                    self._run_prefill_chunks(group, chunk)
            self._run_group_step(group, slots)
        self.stats["steps"] += 1
        for rid in [r for r, s in self.slots.items() if s.finished]:
            self._retire(rid)

    def _retire(self, rid: int) -> None:
        s = self.slots.pop(rid)
        pool = self.pool_for(s.request.instance_id)
        pool.release(rid)
        self.completions.append(DecodeCompletion(
            s.request, s.out_tokens, self.clock() - self._t0,
            steps=s.steps, logits=s.logits,
            admit_epoch=s.admit_epoch, retire_epoch=pool.epoch))
        self.stats["retired"] += 1

    def _run_prefill_chunks(self, group: list, slots: list) -> None:
        """Fast-forward prompt-consuming slots by up to ``page_size`` prompt
        tokens in ONE ``prefill_chunk`` dispatch per chunk size, always
        leaving the LAST prompt token for the normal single-token step.
        Padded rows replicate the last real row (duplicate identical page
        writes, outputs discarded)."""
        dec = self._decode(group[0])
        if dec.prefill_chunk is None:
            return
        pool = self.pool_for(group[0])
        by_k: dict = {}
        for s in slots:
            k = min(self.page_size, len(s.prompt) - 1 - s.pos)
            by_k.setdefault(k, []).append(s)
        for k, ss in sorted(by_k.items()):
            bucket = bucket_for(len(ss), self.buckets)
            with trace.span("decoder.prefill"):
                for s in ss:
                    pool.ensure(s.rid, s.length + k)
                tables, tokens, lengths = self._pad_rows(
                    bucket, pool.table_rows([s.rid for s in ss], self.max_pages),
                    np.array([s.prompt[s.pos:s.pos + k] for s in ss], np.int32),
                    np.array([s.length for s in ss], np.int32))
                # a batch past the largest bucket runs unpadded, at its own size
                self._launch(*self._prefill_call(group, k, len(tables)),
                             (tables, lengths, tokens), group)
                if trace.enabled():
                    self._count_pages(len(tables), [s.length for s in ss], k)
                self.stats["prefill_chunk_dispatches"] += 1
                self.trunk_passes["run"] += k
                for s in ss:
                    s.length += k
                    s.pos += k
                    self.stats["prefill_chunks"] += 1
                    self.stats["prefill_chunk_tokens"] += k
                    self.stats["prompt_tokens"] += k

    def _run_group_step(self, group: list, slots: list) -> None:
        pool = self.pool_for(group[0])
        bucket = bucket_for(len(slots), self.buckets)

        for s in slots:
            pool.ensure(s.rid, s.length + 1)
        tables, tokens, lengths = self._pad_rows(
            bucket, pool.table_rows([s.rid for s in slots], self.max_pages),
            np.array([s.next_input for s in slots], np.int32),
            np.array([s.length for s in slots], np.int32))

        members = sorted({s.request.instance_id for s in slots})
        call = self._group_call(group, members, len(tables))
        rows = self._launch(*call, (tables, lengths, tokens), group)  # (N, rows, V)
        if trace.enabled():
            self._count_pages(len(tables), [s.length for s in slots], 1)
        if len(group) > 1:
            self.stats["group_steps"] += 1
            self.stats["trunk_dispatches"] += 1
            if self._banked(group):
                self.stats["bank_dispatches"] += 1
                row_of = {iid: n for n, iid in enumerate(group)}
            else:
                self.stats["head_dispatches"] += len(members)
                row_of = {iid: n for n, iid in enumerate(members)}
        else:
            self.stats["singleton_dispatches"] += 1
            row_of = {group[0]: 0}
        self.trunk_passes["run"] += 1

        with trace.span("decoder.emit"):  # the .tolist() waits for the device
            emitting = []
            for j, s in enumerate(slots):
                s.steps += 1
                s.length += 1
                if s.pos < len(s.prompt):
                    s.pos += 1
                    self.stats["prompt_tokens"] += 1
                if s.pos >= len(s.prompt) and not s.finished:
                    emitting.append((j, s))
            if not emitting:
                return
            sel = rows[torch.as_tensor([row_of[s.request.instance_id] for _, s in emitting]),
                       torch.as_tensor([j for j, _ in emitting])]  # (E, V)
            toks = sel.argmax(dim=-1).tolist()
            host = sel.float().cpu().numpy() if self.record_logits else None
            for e, ((_, s), tok) in enumerate(zip(emitting, toks)):
                s.out_tokens.append(tok)
                s.last_token = tok
                self.stats["tokens_decoded"] += 1
                if s.logits is not None:
                    s.logits.append(host[e])

    def _count_pages(self, n_rows: int, lengths: list, passes: int) -> None:
        """Count the pages one dispatch of ``passes`` trunk passes reads:
        every pass reads all ``max_pages`` entries of each of the ``n_rows``
        table rows (padded rows too: a dense family's ``page_gather`` copies
        them all), of which, after its ``c``-th pass, a real row of length
        ``n`` before the dispatch holds tokens in ceil((n + c) / page_size)."""
        p = self.page_size
        trace.count("decoder.pages_gathered", passes * n_rows * self.max_pages)
        trace.count("decoder.pages_live", sum(-(-(n + c) // p) for n in lengths
                                              for c in range(1, passes + 1)))

    def _params(self, iid: str):
        return self.engine._params(iid)

    def _banked(self, group: list) -> bool:
        """A shared group whose heads fan out in one bank dispatch."""
        return (len(group) > 1 and self.engine._group_bankable(tuple(group))
                and self._decode(group[0]).bank_head is not None)

    # -- the step bodies: run eagerly on the CPU, captured on a CUDA device --

    def _group_call(self, group: list, members: list, bucket: int) -> tuple:
        """(key, body, fixed arguments) of one group step of ``bucket``
        rows: the trunk step and the bank (key ``(..., "bank", ...)``) or
        each present member's head, or a singleton's full step.  The body
        returns the logits rows (N, bucket, V): the bank's members in group
        order, the heads' in ``members`` order, a singleton's one row."""
        dec = self._decode(group[0])
        fkey = MergeAwareEngine._callable_key
        if len(group) == 1:
            def body(params, pool, tables, lengths, tokens):
                kv = {"k": pool.k, "v": pool.v}
                out, new = dec.step(params, kv, tables, lengths, tokens)
                check_in_place(kv, new, "step")
                return out[:, 0][None]

            return (("step", fkey(dec.step), tuple(group), bucket), body,
                    (self._params(group[0]), self.pool_for(group[0])))

        def trunk(params, pool, tables, lengths, tokens):
            kv = {"k": pool.k, "v": pool.v}
            hidden, new = dec.trunk_step(params, kv, tables, lengths, tokens)
            check_in_place(kv, new, "trunk_step")
            return hidden

        params = self._params(group[0])
        if self._banked(group):
            # under a mesh placement the fan-out is shard-local (an
            # engine-cached wrapper of one identity per group size)
            bank_head = self.engine.maybe_shard_bank(dec.bank_head, len(group))

            def body(params, bank, pool, tables, lengths, tokens):
                return bank_head(bank, trunk(params, pool, tables, lengths, tokens))[:, :, 0]

            return (("trunk", "bank", fkey(dec.trunk_step), tuple(group), bucket), body,
                    (params, self.engine._bank_params(group), self.pool_for(group[0])))

        def body(params, heads, pool, tables, lengths, tokens):
            hidden = trunk(params, pool, tables, lengths, tokens)
            return torch.stack([dec.head(p, hidden)[:, 0] for p in heads])

        return (("trunk", "heads", fkey(dec.trunk_step), tuple(group), tuple(members), bucket),
                body, (params, tuple(self._params(i) for i in members), self.pool_for(group[0])))

    def _prefill_call(self, group: list, k: int, bucket: int) -> tuple:
        """(key, body, fixed arguments) of one prefill chunk of ``k`` tokens."""
        dec = self._decode(group[0])

        def body(params, pool, tables, lengths, tokens):
            kv = {"k": pool.k, "v": pool.v}
            hidden, new = dec.prefill_chunk(params, kv, tables, lengths, tokens)
            check_in_place(kv, new, "prefill_chunk")
            return hidden

        return (("prefill", MergeAwareEngine._callable_key(dec.prefill_chunk), k, tuple(group),
                 bucket), body, (self._params(group[0]), self.pool_for(group[0])))

    def _launch(self, key: tuple, body, fixed: tuple, host: tuple, group: list):
        """``body(*fixed, *host arrays on the device)``: eagerly on the CPU;
        on a CUDA device the replay of its graph under ``key`` and the
        store epoch, captured first, after one eager run on a scratch pool,
        if this decoder has not met it yet."""
        pool = fixed[-1]
        if self.graphs is None:
            return body(*fixed, *(torch.as_tensor(a, device=pool.device) for a in host))
        key = (*key, self.store.epoch)
        if key not in self.graphs:
            shapes = [np.shape(a) for a in host]
            self._eager_once(body, fixed, shapes, group)
            self.graphs.capture(key, body, fixed, shapes)
        return self.graphs.replay(key, fixed, host)

    def _scratch_pool(self, group: list, device) -> types.SimpleNamespace:
        """A pool of ``max_pages`` pages for ``group`` that no request owns:
        the eager runs write their zero-token k/v there, never in the live
        pool."""
        kv = self._decode(group[0]).init_pool(self.max_pages, self.page_size, device=device)
        return types.SimpleNamespace(k=kv["k"], v=kv["v"], device=device)

    def _eager_once(self, body, fixed: tuple, shapes: list, group: list) -> None:
        """Run a step body once eagerly on zero inputs of ``shapes`` against
        a scratch pool and wait for it: the one eager launch a shape needs
        before its capture.  Like the capture it readies, it is left out of
        the launch counts and trunk passes, so a graphed run counts what the
        same steps run eagerly count."""
        device = fixed[-1].device
        zeros = [torch.zeros(s, dtype=torch.int32, device=device) for s in shapes]
        with uncounted():
            body(*fixed[:-1], self._scratch_pool(group, device), *zeros)
            torch.cuda.synchronize(device)

    # -- warmup + run ---------------------------------------------------------

    def _warmup(self) -> None:
        """Run every (group, bucket) decode path once before the clock
        starts — the :meth:`_group_call` body over all of a group's members
        and the :meth:`_prefill_call` body of each chunk size the queued
        prompts need — against a scratch pool: it builds the CUDA kernels
        and warms the GEMM libraries and the caching allocator.  On a CUDA
        device each body is then captured on the live pool, except a
        per-member heads step: which members it holds is known only when it
        is met."""
        for group in self.engine.prefix_groups():
            try:
                self._decode(group[0])
            except ValueError:
                continue
            device = self._device(group[0])
            scratch = self._scratch_pool(group, device)
            shapes = lambda b, k: ((b, self.max_pages), (b,), (b, k) if k else (b,))  # noqa: E731
            calls = [(self._group_call(group, list(group), b), shapes(b, 0), 1)
                     for b in self.buckets]
            calls += [(self._prefill_call(group, k, b), shapes(b, k), k)
                      for k in self._chunk_sizes(group) for b in self.buckets]
            for (_, body, fixed), shp, passes in calls:
                zeros = [torch.zeros(s, dtype=torch.int32, device=device) for s in shp]
                body(*fixed[:-1], scratch, *zeros).sum().item()  # .item() waits for the device
                self.trunk_passes["warmup"] += passes
            if self.graphs is not None and (len(group) == 1 or self._banked(group)):
                for (key, body, fixed), shp, _ in calls:
                    self.graphs.capture((*key, self.store.epoch), body, fixed, shp)

    def _chunk_sizes(self, group: list) -> list:
        """Exactly the prefill chunk sizes the queued prompts of ``group``
        will need (pos advances k + 1 per step: chunk then normal step)."""
        dec = self._decode(group[0])
        if not self.chunked_prefill or dec.prefill_chunk is None:
            return []
        ks: set = set()
        for req in self.queue:
            if req.instance_id not in group:
                continue
            pos, S = 0, len(req.prompt)
            while S - 1 - pos >= 2:
                k = min(self.page_size, S - 1 - pos)
                ks.add(k)
                pos += k + 1
        return sorted(ks)

    def run(self, requests: list, horizon_s: float = 60.0,
            on_step: Optional[Callable] = None, warmup: bool = True) -> dict:
        """Serve ``requests`` to completion (or the horizon).  ``on_step``
        fires after every engine step with (decoder, step_index) — the
        mid-decode rebinding hook.  The loop after the warm-up is the span
        ``StreamingDecoder.run.steps``."""
        for req in requests:
            self.submit(req)
        if warmup:
            self._warmup()
        self._t0 = self.clock()
        with trace.span("StreamingDecoder.run.steps"):
            while (self.queue or self.slots) and self.clock() - self._t0 < horizon_s:
                self._admit()
                if not self.slots:  # queue non-empty but nothing admittable
                    break
                self.step()
                if on_step is not None:
                    on_step(self, self.stats["steps"])
        elapsed = self.clock() - self._t0
        pools_ok = all(p.identity_ok() for p in self._pools.values())
        return {
            "completed": len(self.completions),
            "lost_in_flight": len(self.slots),
            "unadmitted": len(self.queue),
            "elapsed_s": elapsed,
            "tokens_per_s": self.stats["tokens_decoded"] / max(elapsed, 1e-9),
            "pool_identity_ok": pools_ok,
            "pool_high_water_pages": max(
                (p.high_water for p in self._pools.values()), default=0),
            **self.stats,
        }


def replay_unpaged(decoder: StreamingDecoder, completion: DecodeCompletion,
                   batch: int = 1) -> list:
    """Teacher-forced replay of one completed request through the family's
    UNPAGED ``decode_step`` (contiguous cache with Smax = max_len): feeds the
    prompt and then the generated tokens, and returns the float32 logits row
    of every step that emitted a generated token.  ``batch`` > 1 replays the
    request in every row of a batch of that size and returns row 0: set
    against ``batch=1`` it isolates what the batch size alone does to a row
    (GEMMs whose summation order depends on M)."""
    engine = decoder.engine
    prog = engine.programs[completion.request.instance_id]
    dec = prog.decode
    params = engine.store.materialize_cached(prog.model_id)
    device = decoder._device(completion.request.instance_id)
    cache = dec.init_cache(batch, decoder.max_len, device=device)
    prompt = [int(t) for t in completion.request.prompt]
    rows = []
    for i, tok in enumerate(prompt + completion.tokens[:-1]):
        logits, cache = dec.step_unpaged(
            params, cache, torch.full((batch, 1), tok, dtype=torch.int32, device=device))
        if i >= len(prompt) - 1:  # this step emits a generated token
            rows.append(logits[0, 0].float().cpu().numpy())
    return rows


def verify_bitwise(decoder: StreamingDecoder, sample: Optional[int] = None,
                   require_logits: bool = True) -> bool:
    """Replay completed requests through the unpaged ``decode_step`` and
    compare the generated tokens — and, when the decoder recorded them,
    every generated token's logits — bitwise.  Only valid for completions
    produced under the store's CURRENT bindings (skip after a mid-stream
    rebinding)."""
    ok = True
    comps = decoder.completions if sample is None else decoder.completions[:sample]
    for c in comps:
        if c.logits is None and require_logits:
            raise ValueError("verify_bitwise needs record_logits=True for logits comparison")
        rows = replay_unpaged(decoder, c)
        if len(rows) != len(c.tokens):
            ok = False
        for i, row in enumerate(rows):
            if int(np.argmax(row)) != c.tokens[i]:
                ok = False
            if c.logits is not None and not np.array_equal(row, c.logits[i]):
                ok = False
    return ok
