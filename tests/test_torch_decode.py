"""The port's streaming decode against the JAX package.

JAX params cross through ``repro_torch.bridge``; prompts come from numpy.
The JAX side runs its kernels through the plain versions (the CPU default,
as its own tests do).  Config: stablelm-1.6b's smoke config with per-layer
blocks, float32.

Tolerances:
  * across packages, 1e-4 — XLA and PyTorch reduce the same float32 GEMMs,
    norms and softmaxes in different orders, and the differences compound
    through the layers (as in test_torch_models.py); tokens and the
    decoders' statistics must be equal;
  * inside the port, paged against unpaged: bitwise at batch 1.  At a
    bucket of more than one row the CPU GEMMs are not row-stable (a row's
    product differs in the last bits between M = 1 and M = 4, shown below),
    so there tokens must be equal and logits agree to 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import stablelm_1_6b as jax_stablelm
from repro.core import ParamStore as JaxStore
from repro.core import enumerate_groups as jax_enumerate_groups
from repro.models import transformer as JT
from repro.models.registry import get_adapter as jax_get_adapter
from repro.serving import decode as JD
from repro.serving.costs import costs_for as jax_costs_for
from repro.serving.executor import MergeAwareEngine as JaxEngine
from repro.serving.executor import ModelProgram as JaxProgram
from repro.serving.workload import instances_from_store as jax_instances
from repro_torch import bridge
from repro_torch.core import ParamStore, enumerate_groups
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_adapter
from repro_torch.serving import decode as TD
from repro_torch.serving.costs import costs_for
from repro_torch.serving.executor import MergeAwareEngine, ModelProgram
from repro_torch.serving.workload import instances_from_store

XTOL = dict(rtol=1e-4, atol=1e-4)
ROW_TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
MIDS = ("A", "B", "C", "D")
MERGED = ("A", "B", "D")  # C stays unmerged: a singleton group
DECODE_KW = dict(page_size=4, num_pages=32, max_slots=6, max_len=16, buckets=(1, 2, 4))
TIME_KEYS = ("elapsed_s", "tokens_per_s")


def _cfgs(**over):
    jcfg = dataclasses.replace(jax_stablelm.smoke_config(), scan_layers=False, **over)
    names = {f.name for f in dataclasses.fields(TT.DenseLMConfig)} - {"dtype"}
    return jcfg, TT.DenseLMConfig(**{n: getattr(jcfg, n) for n in names}, dtype="float32")


def _np(t):
    return np.asarray(bridge.tensor_to_array(t), np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# PagedKVPool mechanics (the page bookkeeping is the JAX package's, copied)
# ---------------------------------------------------------------------------


def _mk_pool(cls, num_pages=8, page=4):
    init = lambda P, pg: {"k": np.zeros((1, P, pg, 1, 1)),  # noqa: E731
                          "v": np.zeros((1, P, pg, 1, 1))}
    return cls(init, num_pages, page)


def test_pool_admit_grow_release_accounting():
    pool = _mk_pool(TD.PagedKVPool, num_pages=8, page=4)
    pool.admit("a", 10)  # reserves ceil(10/4)=3, allocates the first page
    assert len(pool.tables["a"]) == 1 and pool.allocated_pages == 1
    pool.ensure("a", 5)  # crosses into page 2
    assert len(pool.tables["a"]) == 2
    pool.ensure("a", 5)  # idempotent — already covered
    assert len(pool.tables["a"]) == 2 and pool.allocated_pages == 2
    assert pool.high_water == 2 and pool.identity_ok()
    pool.release("a")
    assert pool.freed_pages == 2 and pool.in_flight_pages() == 0
    assert pool.identity_ok()
    assert sorted(pool._free, reverse=True) == list(range(7, -1, -1))


def test_pool_reservation_blocks_overcommit():
    """Admission reserves the WORST case: a request that fits the free
    pages but not the unreserved headroom is refused, which is what makes
    mid-flight ``ensure`` infallible."""
    pool = _mk_pool(TD.PagedKVPool, num_pages=4, page=4)
    pool.admit("a", 12)  # reserves 3 of 4 pages, allocates 1
    assert len(pool._free) == 3  # free pages exist...
    assert not pool.can_admit(8)  # ...but only 1 is unreserved
    with pytest.raises(TD.PoolExhausted):
        pool.admit("b", 8)
    assert pool.can_admit(4)
    pool.admit("b", 4)
    pool.ensure("a", 12)  # the reserved pages are really there
    assert len(pool.tables["a"]) == 3 and pool.identity_ok()


def test_pool_no_page_shared_between_live_requests():
    pool = _mk_pool(TD.PagedKVPool, num_pages=8, page=4)
    pool.admit("a", 8)
    pool.admit("b", 8)
    pool.ensure("a", 8)
    pool.ensure("b", 8)
    assert not (set(pool.tables["a"]) & set(pool.tables["b"]))
    assert pool.identity_ok()
    pool.release("a")
    pool.admit("c", 8)
    pool.ensure("c", 8)  # recycled pages, still disjoint from b
    assert not (set(pool.tables["c"]) & set(pool.tables["b"]))
    assert pool.identity_ok()


def test_pool_double_admit_rejected():
    pool = _mk_pool(TD.PagedKVPool)
    pool.admit("a", 4)
    with pytest.raises(ValueError):
        pool.admit("a", 4)


def test_pool_random_lifecycle_matches_the_jax_package():
    """A seeded random sequence of admit / ensure / release drives both
    packages' pools: tables, counters, free lists and the identity agree
    after every operation."""
    rng = np.random.default_rng(0)
    pools = [_mk_pool(cls, num_pages=16, page=4) for cls in (JD.PagedKVPool, TD.PagedKVPool)]
    live, nxt = {}, 0
    for _ in range(300):
        op = rng.integers(3)
        if op == 0:
            need = int(rng.integers(1, 20))
            ok = [p.can_admit(need) for p in pools]
            assert ok[0] == ok[1]
            if ok[0]:
                for p in pools:
                    p.admit(nxt, need)
                live[nxt] = need
                nxt += 1
        elif op == 1 and live:
            rid = list(live)[int(rng.integers(len(live)))]
            upto = int(rng.integers(1, live[rid] + 1))
            for p in pools:
                p.ensure(rid, upto)
        elif op == 2 and live:
            rid = list(live)[int(rng.integers(len(live)))]
            for p in pools:
                p.release(rid)
            del live[rid]
        j, t = pools
        assert t.tables == j.tables and t._free == j._free
        assert (t.allocated_pages, t.freed_pages, t.high_water) == \
            (j.allocated_pages, j.freed_pages, j.high_water)
        assert t.identity_ok() and j.identity_ok()
        rids = sorted(live)
        np.testing.assert_array_equal(t.table_rows(rids, 5), j.table_rows(rids, 5))


# ---------------------------------------------------------------------------
# the decode functions against the JAX package
# ---------------------------------------------------------------------------


def _params(jcfg, seed=0):
    jp = JT.init(jcfg, jax.random.PRNGKey(seed))
    return jp, bridge.to_torch(jp, device=CPU)


@pytest.mark.parametrize("kv_repl", [1, 2])
def test_decode_step_matches_reference(kv_repl):
    """A 3-token first step (the masked-attention branch), then single
    tokens (the decode_attention branch): logits and both caches agree."""
    jcfg, tcfg = _cfgs(kv_repl=kv_repl, n_kv_heads=2)
    jp, tp = _params(jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 8), dtype=np.int32)
    jc, tc = JT.init_cache(jcfg, 2, 16), TT.init_cache(tcfg, 2, 16, device=CPU)
    assert tc["k"].shape == tuple(jc["k"].shape) and tc["length"] == 0
    for lo, hi in [(0, 3)] + [(i, i + 1) for i in range(3, 8)]:
        jl, jc = JT.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, lo:hi]))
        tl, tc = TT.decode_step(tcfg, tp, tc, _t(toks[:, lo:hi]))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **XTOL)
        assert tc["length"] == int(jc["length"]) == hi
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), **XTOL)
    np.testing.assert_allclose(_np(tc["v"]), np.asarray(jc["v"]), **XTOL)


def _paged_inputs(rng, jcfg, B=3, P=12, page=4, maxp=3):
    """Shuffled physical pages per row, ragged lengths, a pool already
    holding random k/v (stale tenants included)."""
    tables = np.stack([rng.permutation(P)[:maxp] for _ in range(B)]).astype(np.int32)
    lengths = rng.integers(0, page * maxp - 4, B).astype(np.int32)
    shape = (jcfg.n_layers, P, page, jcfg.kv_stored_heads, jcfg.head_dim)
    pool = {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}
    return tables, lengths, pool


def test_paged_trunk_step_and_decode_step_match_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(2)
    tables, lengths, pool = _paged_inputs(rng, jcfg)
    toks = rng.integers(0, jcfg.vocab_size, 3).astype(np.int32)
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    tpool = {k: _t(v.copy()) for k, v in pool.items()}
    jh, jpool2 = JT.paged_trunk_step(jcfg, jp, jpool, jnp.asarray(tables),
                                     jnp.asarray(lengths), jnp.asarray(toks))
    th, tpool2 = TT.paged_trunk_step(tcfg, tp, tpool, _t(tables), _t(lengths), _t(toks))
    assert th.shape == (3, 1, jcfg.d_model)
    np.testing.assert_allclose(_np(th), np.asarray(jh), **XTOL)
    assert tpool2["k"] is tpool["k"]  # written in place
    for kv in ("k", "v"):
        np.testing.assert_allclose(_np(tpool2[kv]), np.asarray(jpool2[kv]), **XTOL)
    jl, _ = JT.paged_decode_step(jcfg, jp, jpool, jnp.asarray(tables),
                                 jnp.asarray(lengths), jnp.asarray(toks))
    tpool = {k: _t(v.copy()) for k, v in pool.items()}
    tl, _ = TT.paged_decode_step(tcfg, tp, tpool, _t(tables), _t(lengths), _t(toks))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **XTOL)


def test_paged_prefill_chunk_matches_reference_and_single_steps():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(3)
    tables, lengths, pool = _paged_inputs(rng, jcfg)
    toks = rng.integers(0, jcfg.vocab_size, (3, 4)).astype(np.int32)
    jh, jpool = JT.paged_prefill_chunk(jcfg, jp, {k: jnp.asarray(v) for k, v in pool.items()},
                                       jnp.asarray(tables), jnp.asarray(lengths),
                                       jnp.asarray(toks))
    tpool = {k: _t(v.copy()) for k, v in pool.items()}
    th, tpool = TT.paged_prefill_chunk(tcfg, tp, tpool, _t(tables), _t(lengths), _t(toks))
    assert th.shape == (3, 4, jcfg.d_model)
    np.testing.assert_allclose(_np(th), np.asarray(jh), **XTOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(_np(tpool[kv]), np.asarray(jpool[kv]), **XTOL)
    # one chunk IS the four single-token steps, bitwise
    spool = {k: _t(v.copy()) for k, v in pool.items()}
    for c in range(4):
        h, spool = TT.paged_trunk_step(tcfg, tp, spool, _t(tables), _t(lengths + c),
                                       _t(toks[:, c]))
        assert torch.equal(h[:, 0], th[:, c])
    assert torch.equal(spool["k"], tpool["k"]) and torch.equal(spool["v"], tpool["v"])


# ---------------------------------------------------------------------------
# merged serving: the port's decoder alone, then against the JAX package's
# ---------------------------------------------------------------------------


def _trunk_groups(adapter, cfg, store, mids, enumerate_fn):
    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m in mids for r in adapter.records(cfg, store.materialize(m), m)
            if r.path in trunk]
    return enumerate_fn(recs)


def _engines(merged=True):
    """The same four stablelm-smoke variants in both packages, A/B/D merged
    (or not), C a singleton; engines with far deadlines and no DMA sleep."""
    jcfg, tcfg = _cfgs()
    jadapter, tadapter = jax_get_adapter("dense"), get_adapter("dense")
    jparams = {m: JT.init(jcfg, jax.random.PRNGKey(i)) for i, m in enumerate(MIDS)}
    js = JaxStore.from_models(jparams)
    ts = ParamStore.from_models({m: bridge.to_torch(p, device=CPU) for m, p in jparams.items()})
    groups = (_trunk_groups(jadapter, jcfg, js, MERGED, jax_enumerate_groups),
              _trunk_groups(tadapter, tcfg, ts, MERGED, enumerate_groups))
    if merged:
        for jg, tg in zip(*groups):
            js.merge_group(jg)
            ts.merge_group(tg)
    buckets = DECODE_KW["buckets"]
    jeng = JaxEngine(js, jax_instances(js, "tiny-yolo", model_ids=list(MIDS)),
                     [JaxProgram.from_adapter(jadapter, m, cfg=jcfg) for m in MIDS],
                     capacity_bytes=10 ** 9, costs={"tiny-yolo": jax_costs_for("tiny-yolo")},
                     buckets=buckets, simulate_dma=False)
    teng = MergeAwareEngine(ts, instances_from_store(ts, "tiny-yolo", model_ids=list(MIDS)),
                            [ModelProgram.from_adapter(tadapter, m, cfg=tcfg) for m in MIDS],
                            capacity_bytes=10 ** 9, costs={"tiny-yolo": costs_for("tiny-yolo")},
                            buckets=buckets, simulate_dma=False)
    return jeng, teng, groups, jcfg


def _requests(cls, cfg, n_per_model=2, prompt_len=6, max_new=5):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32)
               for _ in range(n_per_model * len(MIDS))]
    return [cls(m, prompts[j * len(MIDS) + i], max_new_tokens=max_new)
            for j in range(n_per_model) for i, m in enumerate(MIDS)]


def _assert_decoders_agree(jstats, tstats, jdec, tdec, logits=True):
    assert {k: v for k, v in tstats.items() if k not in TIME_KEYS} == \
        {k: v for k, v in jstats.items() if k not in TIME_KEYS}
    jc = {c.request.meta: c for c in jdec.completions}
    tc = {c.request.meta: c for c in tdec.completions}
    assert sorted(tc) == sorted(jc)
    for m in jc:
        assert tc[m].tokens == jc[m].tokens
        assert (tc[m].steps, tc[m].admit_epoch, tc[m].retire_epoch) == \
            (jc[m].steps, jc[m].admit_epoch, jc[m].retire_epoch)
        if logits:
            np.testing.assert_allclose(np.stack(tc[m].logits), np.stack(jc[m].logits), **XTOL)


@pytest.mark.parametrize("chunked_prefill", [False, True])
def test_streaming_decoders_of_both_packages_agree(chunked_prefill):
    """Merged A/B/D plus singleton C, the same prompts through both
    packages' StreamingDecoders: equal statistics and tokens, logits within
    1e-4; the merged group steps with one trunk and one bank dispatch."""
    jeng, teng, _, jcfg = _engines()
    assert teng.prefix_groups() == jeng.prefix_groups()
    assert sorted(map(tuple, teng.prefix_groups())) == [("A", "B", "D"), ("C",)]
    jreqs = _requests(JD.DecodeRequest, jcfg)
    treqs = _requests(TD.DecodeRequest, jcfg)
    for i, (jr, tr) in enumerate(zip(jreqs, treqs)):
        jr.meta = tr.meta = i
    kw = dict(DECODE_KW, record_logits=True, chunked_prefill=chunked_prefill)
    jstats = jeng.serve_decode(jreqs, **kw)
    tstats = teng.serve_decode(treqs, **kw)
    assert tstats["completed"] == len(treqs)
    assert tstats["lost_in_flight"] == 0 and tstats["unadmitted"] == 0
    assert tstats["pool_identity_ok"]
    assert tstats["trunk_dispatches"] == tstats["bank_dispatches"] == tstats["group_steps"] > 0
    assert tstats["head_dispatches"] == 0 and tstats["singleton_dispatches"] > 0
    assert (tstats["prefill_chunk_dispatches"] > 0) == chunked_prefill
    _assert_decoders_agree(jstats, tstats, jeng.last_decoder, teng.last_decoder)


def test_mid_stream_merge_in_both_packages():
    """Unmerged start; ``merge_group`` from ``on_step`` at step 3 in both
    packages: one pool epoch bump, no request lost, the merged group's
    shared trunk runs from the very next step, and the packages agree."""
    jeng, teng, (jgroups, tgroups), jcfg = _engines(merged=False)
    assert all(len(g) == 1 for g in teng.prefix_groups())
    seen = {}

    def hook(name, eng, groups):
        def on_step(dec, step):
            if step == 3:
                seen[name] = dict(in_flight=len(dec.slots),
                                  group_steps=dec.stats["group_steps"])
                for g in groups:
                    eng.store.merge_group(g)
            elif step == 4:
                seen[name]["group_steps_next"] = dec.stats["group_steps"]
        return on_step

    jreqs = _requests(JD.DecodeRequest, jcfg)
    treqs = _requests(TD.DecodeRequest, jcfg)
    for i, (jr, tr) in enumerate(zip(jreqs, treqs)):
        jr.meta = tr.meta = i
    jstats = jeng.serve_decode(jreqs, on_step=hook("jax", jeng, jgroups), **DECODE_KW)
    tstats = teng.serve_decode(treqs, on_step=hook("torch", teng, tgroups), **DECODE_KW)
    s = seen["torch"]
    assert s == seen["jax"]
    assert s["in_flight"] > 0 and s["group_steps"] == 0 and s["group_steps_next"] == 1
    assert tstats["completed"] == len(treqs) and tstats["lost_in_flight"] == 0
    assert tstats["epoch_bumps"] == 1 and tstats["swap_survivors"] == s["in_flight"]
    assert sorted(map(tuple, teng.prefix_groups())) == [("A", "B", "D"), ("C",)]
    assert tstats["pool_identity_ok"]
    swapped = [c for c in teng.last_decoder.completions if c.retire_epoch > c.admit_epoch]
    assert len(swapped) == s["in_flight"]
    _assert_decoders_agree(jstats, tstats, jeng.last_decoder, teng.last_decoder, logits=False)


def test_paged_equals_unpaged_bitwise_at_batch_one():
    """One slot, so every dispatch has batch 1: the paged, chunk-admitted,
    bank-fanned decode replays bitwise through the unpaged decode_step."""
    _, teng, _, jcfg = _engines()
    treqs = _requests(TD.DecodeRequest, jcfg, n_per_model=1)
    for chunked in (False, True):
        stats = teng.serve_decode(treqs, record_logits=True, chunked_prefill=chunked,
                                  **dict(DECODE_KW, max_slots=1, buckets=(1,)))
        assert stats["completed"] == len(treqs) and stats["bank_dispatches"] > 0
        assert TD.verify_bitwise(teng.last_decoder)


def test_paged_vs_unpaged_at_bucketed_batch_tokens_exact_logits_close():
    _, teng, _, jcfg = _engines()
    treqs = _requests(TD.DecodeRequest, jcfg)
    stats = teng.serve_decode(treqs, record_logits=True, chunked_prefill=True, **DECODE_KW)
    assert stats["completed"] == len(treqs)
    dec = teng.last_decoder
    for c in dec.completions:
        rows = TD.replay_unpaged(dec, c)
        assert [int(np.argmax(r)) for r in rows] == c.tokens
        np.testing.assert_allclose(np.stack(rows), np.stack(c.logits), **ROW_TOL)
    # the same request replicated over a batch of 4: row 0 differs from the
    # batch-1 replay by the batch size alone, within the same tolerance
    c = dec.completions[0]
    rows4 = TD.replay_unpaged(dec, c, batch=4)
    assert len(rows4) == len(c.tokens)
    np.testing.assert_allclose(np.stack(rows4), np.stack(TD.replay_unpaged(dec, c)), **ROW_TOL)


def test_cpu_gemm_is_not_row_stable_across_batch():
    """Why the bucketed replay above is not bitwise on this host: the same
    row through ``torch.matmul`` at M = 4 and at M = 1 differs in its last
    bits (XLA's CPU GEMM, which the JAX package's own decode tests rely on,
    is row-stable)."""
    _, tcfg = _cfgs()
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 1, tcfg.d_model), generator=g)
    w = torch.randn((tcfg.d_model, tcfg.d_ff), generator=g)
    batched, single = torch.matmul(x, w)[:1], torch.matmul(x[:1], w)
    assert not torch.equal(batched, single)
    torch.testing.assert_close(batched, single, **ROW_TOL)


def test_decode_split_is_cached_and_the_engine_clock_drives_the_decoder():
    """``decode_split`` hands every member one set of function objects (one
    pool per config); an injected engine clock is the decoder's clock."""
    _, tcfg = _cfgs()
    adapter = get_adapter("dense")
    assert adapter.decode_split(tcfg) is adapter.decode_split(tcfg)
    assert not get_adapter("small_cnn").can_decode
    with pytest.raises(NotImplementedError):
        get_adapter("small_cnn").decode_split(get_adapter("small_cnn").default_config())
    progs = [ModelProgram.from_adapter(adapter, m, cfg=tcfg) for m in ("A", "B")]
    assert progs[0].decode is progs[1].decode
    assert MergeAwareEngine._callable_key(progs[0].decode.init_pool) == \
        MergeAwareEngine._callable_key(progs[1].decode.init_pool)
    ticks = iter(range(10 ** 6))
    store = ParamStore.from_models({m: adapter.init(tcfg, seed=i, device=CPU)
                                    for i, m in enumerate(("A", "B"))})
    eng = MergeAwareEngine(store, instances_from_store(store, "tiny-yolo"), progs,
                           capacity_bytes=10 ** 9, costs={"tiny-yolo": costs_for("tiny-yolo")},
                           simulate_dma=False, clock=lambda: float(next(ticks)))
    reqs = [TD.DecodeRequest(m, np.arange(3, dtype=np.int32), max_new_tokens=2)
            for m in ("A", "B")]
    stats = eng.serve_decode(reqs, **DECODE_KW)
    assert eng.last_decoder.clock is eng.clock
    assert stats["completed"] == 2 and stats["elapsed_s"] > 0
    assert stats["elapsed_s"] == int(stats["elapsed_s"])  # read from the fake clock
    assert all(c.finished_s == int(c.finished_s) for c in eng.last_decoder.completions)


@pytest.mark.parametrize("drop", ["engine", "decoder-replaced", "both"])
def test_engine_and_decoder_are_freed_without_the_collector(drop):
    """The decoder holds its engine weakly (the engine keeps its last
    decoder), so with the collector off a replaced decoder, a dropped
    engine, and an engine with its last decoder are each freed at once:
    a decoder's CUDA graphs go when it does, not inside whatever capture a
    later collection interrupts.  A decoder whose engine is gone raises."""
    import gc
    import weakref

    _, tcfg = _cfgs()
    adapter = get_adapter("dense")
    progs = [ModelProgram.from_adapter(adapter, m, cfg=tcfg) for m in ("A", "B")]
    store = ParamStore.from_models({m: adapter.init(tcfg, seed=i, device=CPU)
                                    for i, m in enumerate(("A", "B"))})
    reqs = lambda: [TD.DecodeRequest(m, np.arange(3, dtype=np.int32), max_new_tokens=2)  # noqa: E731
                    for m in ("A", "B")]
    gc.collect()
    gc.disable()
    try:
        eng = MergeAwareEngine(store, instances_from_store(store, "tiny-yolo"), progs,
                               capacity_bytes=10 ** 9,
                               costs={"tiny-yolo": costs_for("tiny-yolo")}, simulate_dma=False)
        eng.serve_decode(reqs(), **DECODE_KW)
        first, dead_engine = weakref.ref(eng.last_decoder), weakref.ref(eng)
        if drop == "decoder-replaced":
            eng.serve_decode(reqs(), **DECODE_KW)
            assert first() is None and eng.last_decoder.engine is eng
        elif drop == "engine":
            dec = eng.last_decoder
            del eng
            assert dead_engine() is None and first() is dec
            with pytest.raises(ReferenceError):
                dec.engine
        else:
            del eng
            assert dead_engine() is None and first() is None
    finally:
        gc.enable()
