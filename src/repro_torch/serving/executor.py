"""Real (non-simulated) edge executors — the port of
``repro.serving.executor``.  Two serve paths share the scheduler policy:

* :class:`EdgeExecutor` — the time/space-sharing baseline: one padded
  batch per visit of the round robin, a synchronous (modelled) DMA stall
  before each swap, and a per-request decode lane on a contiguous cache;
* :class:`MergeAwareEngine` — the merge-aware hot path: shared prefix,
  suffix bank, async DMA prefetch, the streaming decode lane, the hot
  MergePlan swap and the drift ``revert``.  Over a store with a mesh
  placement (DESIGN.md S3) admission is per shard and the bank fan-out
  runs shard-locally (:meth:`MergeAwareEngine.maybe_shard_bank`).

PyTorch runs eagerly: where the JAX executors block on
``jax.block_until_ready`` these synchronise the device that holds the
result.  The per-request decode lane replays CUDA graphs on a card
(``serving.graphs``), where the JAX package jits its step; the serve
paths' forwards still run eagerly.  The statistics the two packages share
keep their meaning.

The DMA delay is modelled (``AsyncDMA``), while residency, eviction and
merging-aware incremental loads are real key-set operations.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.store import ParamStore
from repro_torch.serving.costs import PCIE_GBPS
from repro_torch.serving.graphs import StepGraphs, check_in_place
from repro_torch.serving.scheduler import Instance, Scheduler
from repro_torch.serving.workload import bucket_for, deadline_microbatches, pad_stack
from repro_torch.utils.tree import flatten_paths, leaf_bytes


IDLE_SLEEP_S = 2e-4  # back-off when every queue is empty and not draining


def block_until_ready(t: torch.Tensor) -> torch.Tensor:
    """Wait until the device that holds ``t`` has finished computing it."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return t


def base_model_id(instance_id: str) -> str:
    """ParamStore bindings key for an instance id: feed instances are named
    ``<model>#<k>`` (``workload.build_instances``); bare model ids pass
    through unchanged."""
    return instance_id.split("#", 1)[0]


@dataclasses.dataclass
class Request:
    instance_id: str
    payload: Any
    arrival_s: float
    deadline_s: float
    meta: Any = None  # opaque caller tag


class PlanApplyError(RuntimeError):
    """A hot plan swap failed mid-flight.  The engine guarantees the store
    was rolled back to its pre-swap buffers/bindings with exactly ONE epoch
    bump and no queued request dropped; callers keep serving the prior
    plan."""


def drop_expired(queues: dict, now: float) -> int:
    """Drop queue heads whose deadline has passed; returns the count."""
    n = 0
    for q in queues.values():
        while q and now > q[0].deadline_s:
            q.popleft()
            n += 1
    return n


@dataclasses.dataclass
class Completion:
    request: Request
    result: Any
    finished_s: float

    @property
    def met_sla(self) -> bool:
        return self.finished_s <= self.request.deadline_s


class EdgeExecutor:
    """instances + forward fns + store -> the per-request serve loop (the
    time/space-sharing baseline the merge-aware engine is held against)."""

    def __init__(
        self,
        store: ParamStore,
        instances: list,
        forward_fns: dict,  # instance_id -> callable(params, payload)
        capacity_bytes: int,
        costs: dict,
        simulate_dma: bool = True,
        buckets: tuple = (1, 2, 4, 8),
        clock: Callable[[], float] = time.monotonic,
    ):
        self.store = store
        self.clock = clock  # injected so harness replays can freeze time
        self.scheduler = Scheduler(instances, capacity_bytes, costs)
        self.forward = dict(forward_fns)
        self.simulate_dma = simulate_dma
        self.buckets = tuple(sorted(buckets))
        self.queues = {i.instance_id: deque() for i in instances}
        self.completions: list = []
        self.skipped: int = 0
        self.dropped_expired: int = 0
        self.decode_completions: list = []
        self.decode_graphs = None  # serve_decode's captured steps on a CUDA device

    def submit(self, req: Request):
        self.queues[req.instance_id].append(req)

    def _drop_expired(self, now: float):
        n = drop_expired(self.queues, now)
        self.skipped += n
        self.dropped_expired += n

    def _load(self, iid: str, batch: int):
        """Make ``iid`` resident under the scheduler's accounting (sleeping
        the modelled transfer of its incremental bytes) and return its
        params."""
        r = self.scheduler.load(iid, batch)
        if self.simulate_dma and r["loaded_bytes"]:
            time.sleep(r["loaded_bytes"] / 1e9 / PCIE_GBPS)
        return self.store.materialize_cached(base_model_id(iid))

    def serve(self, horizon_s: float, batch: int = 1, warmup: Any = None,
              drain: bool = False) -> dict:
        """Round-robin over instances until the horizon (or, with
        ``drain=True``, until every queue is empty); returns stats.  A
        ``warmup`` payload runs each instance's forward at every bucket of
        the ladder before the SLA clock starts.  The requests taken from a
        queue run as ONE padded batch through the same :func:`pad_stack`
        bucket ladder the engine uses: what this baseline lacks against
        the engine is sharing, prefetch and the suffix bank, not batching."""
        order = [i.instance_id for i in self.scheduler.order]
        ladder = tuple(sorted({b for b in self.buckets if b <= batch} | {batch}))
        if warmup is not None:
            for iid in order:
                params = self.store.materialize_cached(base_model_id(iid))
                for b in ladder:
                    wb, _ = pad_stack([warmup] * b, b)
                    block_until_ready(self.forward[iid](params, wb))
        t0 = self.clock()
        idx = 0
        empty_streak = 0
        while self.clock() - t0 < horizon_s:
            iid = order[idx % len(order)]
            idx += 1
            self._drop_expired(self.clock() - t0)
            q = self.queues[iid]
            if not q:
                if drain and not any(self.queues.values()):
                    break
                empty_streak += 1
                if empty_streak >= len(order):
                    # every queue was empty for a full pass: yield instead of
                    # busy-spinning on the clock
                    time.sleep(IDLE_SLEEP_S)
                    empty_streak = 0
                continue
            empty_streak = 0
            params = self._load(iid, batch)
            taken = [q.popleft() for _ in range(min(batch, len(q)))]
            stacked, _ = pad_stack([req.payload for req in taken],
                                   bucket_for(len(taken), ladder))
            out = block_until_ready(self.forward[iid](params, stacked))
            done = self.clock() - t0
            for j, req in enumerate(taken):
                self.completions.append(Completion(req, out[j], done))
        met = sum(1 for c in self.completions if c.met_sla)
        total = len(self.completions) + self.skipped
        return {
            "completed": len(self.completions),
            "met_sla": met,
            "skipped": self.skipped,
            "dropped_expired": self.dropped_expired,
            "sla_fraction": met / max(total, 1),
        }

    def serve_decode(self, requests: list, programs: list, max_len: int = 64,
                     horizon_s: float = 60.0) -> dict:
        """Per-request decode baseline lane: one request at a time in EDF
        order, each on its decode split's contiguous cache
        (``DecodeSplit.init_cache``), one per split, zeroed for each request
        and written in place — ONE chunked step over the whole prompt, then
        one single-token step per further generated token.  Greedy argmax
        over the full padded vocab (the first maximal index, as
        ``np.argmax``), as the streaming decoder takes it.  Stats mirror the
        decoder's ``tokens_decoded`` / ``steps`` / ``prompt_tokens``.

        Before the clock starts, the warm-up runs both shapes (prompt chunk
        and single token) of every model of the trace once eagerly, on a
        scratch cache.  On a CUDA device it then captures them on the lane's
        cache, and each ``step_unpaged`` is the replay of a CUDA graph per
        (model, step length, store epoch) (``decode_graphs``), as the JAX
        package jits it.  The timed loop runs inside the profiler range
        ``EdgeExecutor.serve_decode.lane``."""
        from repro_torch.serving.decode import DecodeCompletion

        progs = {p.instance_id: p for p in programs}
        for req in requests:
            if progs[req.instance_id].decode is None:
                raise ValueError(f"{req.instance_id}: program has no decode "
                                 "surface (adapter lacks can_decode)")
        device = next(iter(self.store.buffers.values())).device
        graphs = StepGraphs(device) if device.type == "cuda" else None
        self.decode_graphs = graphs
        caches: dict = {}  # init_cache callable key -> the lane's cache

        def tokens(values) -> torch.Tensor:
            return torch.as_tensor(values, dtype=torch.int32, device=device)[None, :]

        def graph_key(req, n: int) -> tuple:
            dec = progs[req.instance_id].decode
            return ("step_unpaged", MergeAwareEngine._callable_key(dec.step_unpaged),
                    base_model_id(req.instance_id), n, self.store.epoch)

        def lane_cache(dec) -> dict:
            key = MergeAwareEngine._callable_key(dec.init_cache)
            if key not in caches:
                caches[key] = dec.init_cache(1, max_len, device=device)
            return caches[key]

        def body(dec):
            def run(params, cache, toks):
                logits, new = dec.step_unpaged(params, cache, toks)
                check_in_place(cache, new, "step_unpaged")
                return logits
            return run

        def step(req, params, cache, toks: list) -> torch.Tensor:
            """One ``step_unpaged`` of ``toks``; the logits (1, S, V)."""
            if graphs is None:
                return body(progs[req.instance_id].decode)(params, cache, tokens(toks))
            return graphs.replay(graph_key(req, len(toks)), (params, cache),
                                 (np.asarray(toks, np.int32)[None, :],))

        order = sorted(requests, key=lambda r: (r.deadline_s, r.arrival_s))
        seen = set()
        for req in order:  # the warm-up: both shapes of every model
            dec = progs[req.instance_id].decode
            params = self.store.materialize_cached(base_model_id(req.instance_id))
            if (id(dec), len(req.prompt)) not in seen:
                seen.add((id(dec), len(req.prompt)))
                cache = dec.init_cache(1, max_len, device=device)
                _, cache = dec.step_unpaged(params, cache, tokens([0] * len(req.prompt)))
                block_until_ready(dec.step_unpaged(params, cache, tokens([0]))[0])
            if graphs is not None:  # a no-op for the shapes captured already
                for n in (len(req.prompt), 1):
                    graphs.capture(graph_key(req, n), body(dec), (params, lane_cache(dec)),
                                   ((1, n),))

        stats = {"steps": 0, "tokens_decoded": 0, "prompt_tokens": 0}
        completions: list = []
        t0 = self.clock()
        with torch.profiler.record_function("EdgeExecutor.serve_decode.lane"):
            for req in order:
                if self.clock() - t0 > horizon_s:
                    break
                params = self._load(req.instance_id, 1)
                cache = lane_cache(progs[req.instance_id].decode)
                for t in flatten_paths(cache).values():
                    if isinstance(t, torch.Tensor):
                        t.zero_()
                logits = step(req, params, cache, [int(t) for t in req.prompt])
                stats["steps"] += 1
                stats["prompt_tokens"] += len(req.prompt)
                out = [int(logits[0, -1].argmax())]
                stats["tokens_decoded"] += 1
                for _ in range(req.max_new_tokens - 1):
                    logits = step(req, params, cache, [out[-1]])
                    stats["steps"] += 1
                    out.append(int(logits[0, 0].argmax()))
                    stats["tokens_decoded"] += 1
                completions.append(DecodeCompletion(req, out, self.clock() - t0))
        self.decode_completions = completions
        elapsed = self.clock() - t0
        return {
            "completed": len(completions),
            "elapsed_s": elapsed,
            "tokens_per_s": stats["tokens_decoded"] / max(elapsed, 1e-9),
            **stats,
        }


@dataclasses.dataclass
class ModelProgram:
    """How the engine runs one instance.  ``forward`` is the whole model;
    with ``prefix``/``suffix`` the engine executes a merged stem once per
    micro-batch and fans out only the private heads.  ``prefix_paths`` are
    the flat param paths the prefix reads, checked against
    ``ParamStore.binding_signature`` before a prefix run is ever shared.
    ``suffix_paths``/``suffix_signature``/``bank_suffix`` are the
    suffix-bank tier: members with equal signatures run every private head
    in ONE dispatch."""

    instance_id: str
    model_id: str  # ParamStore bindings key
    forward: Callable  # (params, batched_x) -> batched_out
    prefix: Optional[Callable] = None
    suffix: Optional[Callable] = None
    prefix_paths: Optional[frozenset] = None
    suffix_paths: Optional[frozenset] = None
    suffix_signature: Optional[tuple] = None
    bank_suffix: Optional[Callable] = None  # (bank_params, feats) -> (N, ...)
    decode: Optional[Any] = None  # registry.DecodeSplit — the streaming lane

    @classmethod
    def from_adapter(cls, adapter, instance_id: str,
                     model_id: Optional[str] = None, cfg=None) -> "ModelProgram":
        """Build a program from a registered ``MergeableAdapter``; the
        adapter caches the cfg-bound callables, so every instance of one
        (adapter, cfg) hands the engine the SAME function objects."""
        cfg = adapter.default_config() if cfg is None else cfg
        sp = adapter.split(cfg) if adapter.can_split else None
        ds = adapter.decode_split(cfg) if (sp and adapter.can_decode) else None
        return cls(
            instance_id, model_id if model_id is not None else instance_id,
            forward=adapter.bound_forward(cfg),
            prefix=sp.prefix if sp else None,
            suffix=sp.suffix if sp else None,
            prefix_paths=sp.prefix_paths if sp else None,
            suffix_paths=sp.suffix_paths if sp else None,
            suffix_signature=sp.suffix_signature if sp else None,
            bank_suffix=sp.bank_suffix if sp else None,
            decode=ds,
        )


class AsyncDMA:
    """Models an async host->device copy engine: ``start`` begins a transfer
    (wall-clock timestamped), ``wait`` blocks only for the portion that did
    not overlap the compute issued in between.  With ``simulate=False`` the
    bookkeeping still runs but nothing sleeps."""

    def __init__(self, gbps: float, simulate: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self.gbps = gbps
        self.simulate = simulate
        self.clock = clock
        self._inflight: dict = {}  # key -> (t_start, duration_s)
        self.stall_s = 0.0
        self.hidden_s = 0.0
        self.transfers = 0
        # per-shard transferred-bytes ledger (DESIGN.md S3): the sharded
        # engine attributes each load's bytes to the shards they land on
        self.bytes_by_shard: dict = {}

    def seconds_for(self, nbytes: int) -> float:
        return nbytes / 1e9 / self.gbps

    def account(self, shard_bytes: dict) -> None:
        """Credit a completed load's bytes to the shards they landed on
        (``Scheduler.load``'s ``loaded_bytes_by_shard``)."""
        for s, b in shard_bytes.items():
            if b:
                self.bytes_by_shard[s] = self.bytes_by_shard.get(s, 0) + b

    def start(self, key, nbytes: int) -> None:
        self._inflight[key] = (self.clock(), self.seconds_for(nbytes))
        if nbytes:
            self.transfers += 1

    def wait(self, key, nbytes: int) -> float:
        """Block until the transfer for ``key`` is done; returns the visible
        stall.  A key never started (cold miss) pays the full transfer."""
        entry = self._inflight.pop(key, None)
        now = self.clock()
        if entry is None:
            remaining = self.seconds_for(nbytes)
            if nbytes:
                self.transfers += 1
        else:
            t_start, dur = entry
            elapsed = now - t_start
            remaining = Scheduler.overlapped_load_ms(dur * 1e3, elapsed * 1e3) / 1e3
            self.hidden_s += min(dur, elapsed)
        self.stall_s += remaining
        if self.simulate and remaining > 0:
            time.sleep(remaining)
        return remaining


class MergeAwareEngine:
    """Batched, prefetching serve loop over a merged ParamStore.

    Execution plan (recomputed whenever the store's binding epoch moves):
    instances whose ``prefix_paths`` all bind to identical store keys form a
    *shared-prefix group* — one prefix run serves every member's requests in
    a micro-batch; private suffixes fan out per instance, or in ONE bank
    dispatch when the members' heads are congruent.  Groups are visited in
    the scheduler's merging-aware round-robin order and the next group's
    incremental load is prefetched during the current group's compute.
    """

    def __init__(
        self,
        store: ParamStore,
        instances: list,
        programs: list,
        capacity_bytes: int,
        costs: dict,
        simulate_dma: bool = True,
        buckets: tuple = (1, 2, 4, 8),
        suffix_bank: bool = True,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.store = store
        self.clock = clock  # shared with the DMA model and the decoder
        # with a mesh-sharded store the capacity budget is PER-SHARD and
        # admission checks every shard's slice (replicated trunk everywhere,
        # private suffixes on their home shard) — DESIGN.md S3
        self.scheduler = Scheduler(
            instances, capacity_bytes, costs,
            shard_fn=store.resident_shards if store.n_shards > 1 else None,
            n_shards=store.n_shards)
        self.programs = {p.instance_id: p for p in programs}
        missing = set(self.programs) ^ {i.instance_id for i in instances}
        if missing:
            raise ValueError(f"programs/instances mismatch: {missing}")
        self.dma = AsyncDMA(PCIE_GBPS, simulate=simulate_dma, clock=clock)
        self.buckets = tuple(sorted(buckets))
        self.suffix_bank = suffix_bank
        self.queues = {i.instance_id: deque() for i in instances}
        self.completions: list = []
        self.skipped = 0
        self.stats = {
            "prefix_runs": 0, "suffix_runs": 0, "forward_runs": 0,
            "microbatches": 0, "param_lookups": 0, "idle_sleeps": 0,
            "suffix_dispatches": 0, "bank_hits": 0, "dropped_expired": 0,
        }
        self._groups: list = []
        self._groups_epoch = -1
        self._sigs: dict = {}  # iid -> binding signature, per groups epoch
        self._bankable: dict = {}  # group tuple -> bool, per groups epoch
        self._bank_sharded: dict = {}  # (callable, N, mesh, axis) -> shard-local fn
        self.last_decoder = None  # the StreamingDecoder of the last serve_decode

    @staticmethod
    def _callable_key(fn):
        """Sharing identity of a callable: closures produced from one body
        over the same captured values compare equal, so every member of one
        (adapter, cfg) maps onto ONE decode pool.  Falls back to object
        identity when the closure or defaults are unhashable."""
        code = getattr(fn, "__code__", None)
        if code is None:
            return id(fn)
        try:
            cells = tuple(id(c.cell_contents) for c in (fn.__closure__ or ()))
            key = (code, fn.__defaults__, cells)
            hash(key)
            return key
        except (TypeError, ValueError):
            return id(fn)

    def _binding_sig(self, iid: str) -> tuple:
        sig = self._sigs.get(iid)
        if sig is None:
            p = self.programs[iid]
            sig = self._sigs[iid] = self.store.binding_signature(p.model_id, p.prefix_paths)
        return sig

    # -- suffix bank ----------------------------------------------------------

    def _group_bankable(self, group: tuple) -> bool:
        """A shared group's fan-out runs as ONE banked dispatch iff every
        member's private head is congruent: a bank callable, the same suffix
        paths and the same suffix signature.  Cached per binding epoch."""
        hit = self._bankable.get(group)
        if hit is None:
            progs = [self.programs[i] for i in group]
            sigs = {p.suffix_signature for p in progs}
            paths = {p.suffix_paths for p in progs}
            hit = (self.suffix_bank and len(group) > 1
                   and progs[0].bank_suffix is not None
                   and None not in sigs and len(sigs) == 1
                   and None not in paths and len(paths) == 1)
            self._bankable[group] = hit
        return hit

    def _bank_sharding_active(self, n_bank: int) -> bool:
        """Sharded bank dispatch is on iff the store carries a mesh placement
        with >1 shards on the bank axis AND the bank divides evenly over
        them (an indivisible bank is placed replicated and dispatched
        whole)."""
        return (self.store.placement is not None and self.store.n_shards > 1
                and n_bank % self.store.n_shards == 0)

    def maybe_shard_bank(self, fn, n_bank: int):
        """Wrap a bank fan-out callable ``(bank_params, feats) -> (N, ...)``
        in ``distributed.sharding.shard_bank_fn`` over the placement's bank
        axis when sharding is active for ``n_bank`` (DESIGN.md S3): each
        shard runs the SAME callable over its N/n_shards bank slice with the
        replicated features, so ``ops.bank_matmul`` launches once per shard
        at the local member count.  Cached per (callable, N, mesh, axis), so
        repeat callers see one function object."""
        if not self._bank_sharding_active(n_bank):
            return fn
        from repro_torch.distributed.sharding import shard_bank_fn

        pl = self.store.placement
        key = (self._callable_key(fn), n_bank, pl.mesh, pl.bank_axis)
        wrapped = self._bank_sharded.get(key)
        if wrapped is None:
            wrapped = self._bank_sharded[key] = shard_bank_fn(fn, pl.mesh, pl.bank_axis)
        return wrapped

    def _bank_fn(self, group: list):
        """The group's bank fan-out: the lead program's ``bank_suffix``,
        shard-local under an active mesh placement (:meth:`maybe_shard_bank`)."""
        return self.maybe_shard_bank(self.programs[group[0]].bank_suffix, len(group))

    def _bank_params(self, group: list):
        """Stacked suffix-bank tree for the group, via the store's
        epoch-cached bank materialisation; ``bank_hits`` counts
        cache-served dispatches."""
        self.stats["param_lookups"] += 1
        mids = tuple(self.programs[i].model_id for i in group)
        bid = ParamStore.bank_id(mids)
        before = self.store.materializations.get(bid, 0)
        tree = self.store.materialize_bank(mids, self.programs[group[0]].suffix_paths)
        if self.store.materializations.get(bid, 0) == before:
            self.stats["bank_hits"] += 1
        return tree

    # -- plan -----------------------------------------------------------------

    def prefix_groups(self) -> list:
        """Shared-prefix groups as lists of instance ids, ordered by first
        appearance in the merging-aware round-robin order.  Cached per store
        binding epoch."""
        if self._groups_epoch == self.store.epoch:
            return self._groups
        self._sigs = {}
        self._bankable = {}
        groups: list = []
        by_sig: dict = {}
        for inst in self.scheduler.order:
            iid = inst.instance_id
            p = self.programs[iid]
            if not (p.prefix and p.suffix and p.prefix_paths):
                groups.append([iid])
                continue
            sig = self._binding_sig(iid)
            if sig in by_sig:
                by_sig[sig].append(iid)
            else:
                by_sig[sig] = member = [iid]
                groups.append(member)
        self._groups = groups
        self._groups_epoch = self.store.epoch
        return groups

    # -- hot plan swap / revert ------------------------------------------------

    def rebind_instances(self) -> dict:
        """Rebuild scheduler instances from the store's CURRENT bindings
        (cost id and accuracy carried over per instance) and swap them in
        via ``Scheduler.rebind``, which keeps residency for surviving keys —
        the shared tail of ``apply_plan`` and ``revert``."""
        kb_by_model: dict = {}  # store model -> {key: bytes}, computed once
        insts = []
        for iid, inst in self.scheduler.instances.items():
            mid = self.programs[iid].model_id
            if mid not in kb_by_model:
                kb_by_model[mid] = {k: leaf_bytes(self.store.buffers[k])
                                    for k in self.store.keys_for(mid)}
            kb = kb_by_model[mid]
            insts.append(Instance(iid, inst.model_id, frozenset(kb), kb, inst.accuracy))
        return self.scheduler.rebind(insts)

    def apply_plan(self, plan) -> dict:
        """Apply a MergePlan on the LIVE engine:

        1. ``ParamStore.apply_plan`` stages every column rebind and commits
           with a *single* epoch bump — the prefix-group plan, every cached
           tree and every bank invalidate exactly once;
        2. scheduler instances are rebuilt from the post-plan bindings and
           swapped in via ``Scheduler.rebind``;
        3. queues are untouched — queued requests are served against the new
           bindings on the next pass (``serve`` re-reads ``prefix_groups()``
           every iteration).

        The swap is atomic under failure: the engine snapshots buffers and
        bindings up front; on any failure it restores both wholesale,
        settles the epoch at exactly ONE bump past the pre-swap value,
        rebinds the scheduler from the restored bindings, and raises
        :class:`PlanApplyError`.  No queued request is dropped."""
        epoch0 = self.store.epoch
        buffers0 = dict(self.store.buffers)
        bindings0 = {m: dict(b) for m, b in self.store.bindings.items()}
        try:
            shared = self.store.apply_plan(plan)
        except Exception as exc:  # any failure rolls the whole swap back
            self.store.buffers.clear()
            self.store.buffers.update(buffers0)
            self.store.bindings.clear()
            self.store.bindings.update(bindings0)
            if self.store.epoch == epoch0:
                self.store.bump_epoch()  # one bump total for the failed swap
            else:
                self.store._cache.clear()  # already bumped: just invalidate
            self.rebind_instances()
            raise PlanApplyError(f"plan swap failed and was rolled back: {exc}") from exc
        rebind = self.rebind_instances()
        return {
            "shared_keys": shared,
            "epoch_bumps": self.store.epoch - epoch0,
            "pending_requests": sum(len(q) for q in self.queues.values()),
            **rebind,
        }

    def revert(self, monitor, report) -> dict:
        """Revert breached models to their original weights on the LIVE
        engine (§5.1 step 5) — the drift-side twin of ``apply_plan``, with
        the same no-drain guarantees:

        1. ``DriftMonitor.revert`` stages every breached model's private
           rebind and commits with a *single* epoch bump — cached trees, the
           prefix-group plan AND the suffix banks (cached in the same store
           cache ``bump_epoch`` clears) invalidate exactly once;
        2. scheduler instances are rebuilt from the post-revert bindings;
           shared keys the surviving members still reference stay resident
           (``Scheduler.rebind``), so only the reverted model pays its
           private bytes;
        3. queues are untouched: requests queued at breach time are served
           against the reverted bindings on the next pass, never dropped."""
        epoch0 = self.store.epoch
        pending = sum(len(q) for q in self.queues.values())
        monitor.revert(report)
        rebind = self.rebind_instances()
        return {
            "reverted": sorted(report.reverted),
            "epoch_bumps": self.store.epoch - epoch0,
            "pending_requests": pending,
            **rebind,
        }

    # -- queue plumbing --------------------------------------------------------

    def submit(self, req: Request):
        self.queues[req.instance_id].append(req)

    def _drop_expired(self, now: float):
        n = drop_expired(self.queues, now)
        self.skipped += n
        self.stats["dropped_expired"] += n

    def _params(self, iid: str):
        self.stats["param_lookups"] += 1
        return self.store.materialize_cached(self.programs[iid].model_id)

    # -- execution -------------------------------------------------------------

    def _run_group(self, group: list, reqs: list, t0: float):
        """One group visit: deadline-sorted micro-batches over the union of
        the group's drained requests; shared groups run the prefix once per
        batch, singletons the whole forward.  A shared micro-batch whose
        rows belong to more than one member of a bankable group runs every
        member's head in ONE bank dispatch and scatters each completion out
        of its (member, row) cell; otherwise each member's suffix runs on
        its own rows.  ``suffix_dispatches`` counts device dispatches of
        suffix work, ``suffix_runs`` logical member-head executions."""
        shared = len(group) > 1
        bankable = shared and self._group_bankable(tuple(group))
        for mb in deadline_microbatches(reqs, self.buckets):
            self.stats["microbatches"] += 1
            batch, n = pad_stack([r.payload for r in mb.requests], mb.bucket)
            banked = bankable and len({r.instance_id for r in mb.requests}) > 1
            if banked:
                lead = group[0]
                feats = self.programs[lead].prefix(self._params(lead), batch)
                self.stats["prefix_runs"] += 1
                bank_out = self._bank_fn(group)(self._bank_params(group), feats)
                self.stats["suffix_runs"] += len(group)
                self.stats["suffix_dispatches"] += 1
                block_until_ready(bank_out)
                slot = {iid: i for i, iid in enumerate(group)}
                done = self.clock() - t0
                # each completion owns a copy of its row, as the JAX
                # package's indexing gives one: a view would keep the whole
                # micro-batch output alive as long as any completion is
                for j, r in enumerate(mb.requests):
                    self.completions.append(
                        Completion(r, bank_out[slot[r.instance_id], j].clone(), done))
                continue
            rows_by_iid: dict = {}
            for j, r in enumerate(mb.requests):
                rows_by_iid.setdefault(r.instance_id, []).append(j)
            if shared:
                lead = group[0]
                feats = self.programs[lead].prefix(self._params(lead), batch)
                self.stats["prefix_runs"] += 1
                outs, pos = {}, {}
                for iid, idx in rows_by_iid.items():
                    if len(idx) == mb.bucket:
                        sub = feats  # whole batch belongs to this instance
                    else:
                        # fan out only this instance's rows, padded back onto
                        # the bucket ladder so suffix shapes stay bounded
                        sb = next(b for b in self.buckets if len(idx) <= b)
                        take = idx + [idx[-1]] * (sb - len(idx))
                        sub = feats[torch.tensor(take, device=feats.device)]
                    outs[iid] = self.programs[iid].suffix(self._params(iid), sub)
                    pos[iid] = {g: k for k, g in enumerate(idx)}
                    self.stats["suffix_runs"] += 1
                    self.stats["suffix_dispatches"] += 1
            else:
                (iid,) = group
                outs = {iid: self.programs[iid].forward(self._params(iid), batch)}
                pos = {iid: {j: j for j in range(len(mb.requests))}}
                self.stats["forward_runs"] += 1
            for o in outs.values():
                block_until_ready(o)
            done = self.clock() - t0
            for j, r in enumerate(mb.requests):
                row = pos[r.instance_id][j]
                self.completions.append(Completion(r, outs[r.instance_id][row].clone(), done))

    def _warmup(self, payload) -> None:
        """Run every (group, bucket) path once before the SLA clock starts:
        it builds the CUDA kernels, initialises the GEMM libraries and warms
        the caching allocator.  ``payload`` follows the request-payload
        contract and goes through the same :func:`pad_stack`."""
        for group in self.prefix_groups():
            banked = len(group) > 1 and self._group_bankable(tuple(group))
            for b in self.buckets:
                batch, _ = pad_stack([payload] * b, b)
                if len(group) > 1:
                    lead = self.programs[group[0]]
                    feats = lead.prefix(self._params(group[0]), batch)
                    if banked:
                        # single-member micro-batches still take the
                        # per-member path, so warm both fan-outs
                        block_until_ready(self._bank_fn(group)(self._bank_params(group), feats))
                    for iid in group:
                        block_until_ready(self.programs[iid].suffix(self._params(iid), feats))
                else:
                    (iid,) = group
                    block_until_ready(self.programs[iid].forward(self._params(iid), batch))

    def serve_decode(self, requests: list, horizon_s: float = 60.0,
                     on_step: Optional[Callable] = None, **kw) -> dict:
        """Streaming decode lane: paged KV pool + continuous batching via
        ``serving.decode.StreamingDecoder`` — the shared trunk of a merged
        group advances every in-flight row ONE token per step in a single
        dispatch, private heads fan out through the suffix bank.  ``**kw``
        forwards pool/batching knobs (``page_size``, ``num_pages``,
        ``max_slots``, ``max_len``, ``buckets``, ``record_logits``,
        ``chunked_prefill``); ``on_step(decoder, step)`` fires after every
        step.  The decoder is kept on ``last_decoder``."""
        from repro_torch.serving.decode import StreamingDecoder

        dec = StreamingDecoder(self, **kw)
        self.last_decoder = dec
        return dec.run(requests, horizon_s=horizon_s, on_step=on_step)

    def serve(self, horizon_s: float, warmup: Any = None, drain: bool = True) -> dict:
        """Serve until the horizon (or until the queues are drained, with
        ``drain=True``).  Returns stats including cache/prefetch health;
        every counter is the delta over this call."""
        if warmup is not None:
            self._warmup(warmup)
        mat_before = dict(self.store.materializations)
        stats_before = dict(self.stats)
        done_before = len(self.completions)
        skipped_before = self.skipped
        stall_before, hidden_before = self.dma.stall_s, self.dma.hidden_s
        epoch_start = self.store.epoch
        t0 = self.clock()
        gi = 0
        empty_streak = 0
        while self.clock() - t0 < horizon_s:
            groups = self.prefix_groups()  # re-plan if an epoch moved
            self._drop_expired(self.clock() - t0)
            if not any(self.queues.values()):
                if drain:
                    break
                self.stats["idle_sleeps"] += 1
                time.sleep(IDLE_SLEEP_S)
                continue
            group = groups[gi % len(groups)]
            nxt = groups[(gi + 1) % len(groups)]
            gi += 1
            reqs = []
            for iid in group:
                q = self.queues[iid]
                while q:
                    reqs.append(q.popleft())
            if not reqs:
                empty_streak += 1
                if empty_streak >= len(groups):
                    self.stats["idle_sleeps"] += 1
                    time.sleep(IDLE_SLEEP_S)
                    empty_streak = 0
                continue
            empty_streak = 0
            max_batch = min(len(reqs), self.buckets[-1])
            loaded = 0
            shard_bytes: dict = {}
            for iid in group:
                r = self.scheduler.load(iid, max_batch)
                loaded += r["loaded_bytes"]
                for s, b in r["loaded_bytes_by_shard"].items():
                    shard_bytes[s] = shard_bytes.get(s, 0) + b
            self.dma.wait(tuple(group), loaded)
            self.dma.account(shard_bytes)
            # prefetch the NEXT group's incremental bytes; the transfer's
            # clock runs while this group computes (§3.2 pipelining)
            if tuple(nxt) != tuple(group):
                pre = sum(self.scheduler.peek_load_bytes(iid) for iid in nxt)
                self.dma.start(tuple(nxt), pre)
            self._run_group(group, reqs, t0)
        new = self.completions[done_before:]
        met = sum(1 for c in new if c.met_sla)
        skipped = self.skipped - skipped_before
        lookups = self.stats["param_lookups"] - stats_before["param_lookups"]
        rebuilds = sum(self.store.materializations.get(m, 0) - mat_before.get(m, 0)
                       for m in self.store.materializations)
        last = max((c.finished_s for c in new), default=0.0)
        return {
            "completed": len(new),
            "met_sla": met,
            "skipped": skipped,
            "sla_fraction": met / max(len(new) + skipped, 1),
            "elapsed_s": last,
            "requests_per_s": len(new) / max(last, 1e-9),
            "cache_hit_rate": 1.0 - rebuilds / max(lookups, 1),
            "materializations": rebuilds,
            "binding_epochs": self.store.epoch - epoch_start + 1,
            "dma_stall_s": self.dma.stall_s - stall_before,
            "dma_hidden_s": self.dma.hidden_s - hidden_before,
            "dma_bytes_by_shard": dict(self.dma.bytes_by_shard),
            **{k: v - stats_before[k] for k, v in self.stats.items()},
        }
