"""The port's griffin (recurrentgemma) streaming decode against the JAX
package: the unpaged ``decode_step`` / ``prefill``, the paged steps over
the state pool, and both packages' ``StreamingDecoder`` on a merged group
with a tied head.

JAX params cross through ``repro_torch.bridge`` and are never re-drawn;
tokens, tables and pools come from numpy.  The JAX side runs its kernels
through the plain versions (the CPU default, as its own tests do).
Configs: the hybrid adapter's default (untied, window 8) and
recurrentgemma-9b's smoke config (tied, window 16), float32, with per-layer
blocks.  Every sequence runs past the window, so the ring buffer wraps.

Tolerances:
  * across packages in float32, 1e-4 (as in test_torch_recurrent.py): XLA
    and PyTorch reduce the same GEMMs, norms, softmaxes and scans in
    different orders; tokens and the decoders' statistics must be equal;
  * inside the port: a prefill chunk is its single-token steps bitwise,
    and at one slot the paged stream replays bitwise through the unpaged
    ``decode_step``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ParamStore as JaxStore
from repro.core import enumerate_groups as jax_enumerate_groups
from repro.models import griffin as JG
from repro.models.registry import get_adapter as jax_get_adapter
from repro.serving import decode as JD
from repro.serving.costs import costs_for as jax_costs_for
from repro.serving.executor import MergeAwareEngine as JaxEngine
from repro.serving.executor import ModelProgram as JaxProgram
from repro.serving.workload import instances_from_store as jax_instances
from repro_torch import bridge
from repro_torch.core import ParamStore, enumerate_groups
from repro_torch.kernels import ops
from repro_torch.models import griffin as TG
from repro_torch.models.registry import get_adapter
from repro_torch.serving import decode as TD
from repro_torch.serving.costs import costs_for
from repro_torch.serving.executor import MergeAwareEngine, ModelProgram
from repro_torch.serving.workload import instances_from_store
from test_torch_recurrent import XTOL, _cfgs, _jax_params, _merge, _np, _t

CPU = torch.device("cpu")
MIDS = ("A", "B", "C", "D")
MERGED = ("A", "B", "D")  # C stays unmerged: a singleton group
# prompts of 10 and 12 new tokens: 21 positions, past the smoke window (16)
DECODE_KW = dict(page_size=4, num_pages=32, max_slots=6, max_len=24, buckets=(1, 2, 4),
                 chunked_prefill=True)
PROMPT, NEW = 10, 12
TIME_KEYS = ("elapsed_s", "tokens_per_s")


def _params(which):
    jcfg, tcfg = _cfgs("hybrid", which)
    jp = _jax_params("hybrid", which, 0, 0.05)
    return jcfg, tcfg, jp, bridge.to_torch(jp, device=CPU)


def _state_close(tstate, jstate):
    """Every array of a cache or pool (nested dicts) within XTOL."""
    for key, j in jstate.items():
        if isinstance(j, dict):
            _state_close(tstate[key], j)
        elif key != "length":
            np.testing.assert_allclose(_np(tstate[key]), np.asarray(j), **XTOL)


@pytest.mark.parametrize("which", ["adapter", "smoke"])
def test_griffin_decode_step_and_prefill_match_reference(which):
    """A 5-token prefill, then single tokens until the sequence is 1.5
    windows long: logits at every step and the final state agree."""
    jcfg, tcfg, jp, tp = _params(which)
    n = 3 * tcfg.window // 2
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, n)).astype(np.int32)
    max_len = 2 * tcfg.window
    jl, jc = JG.prefill(jcfg, jp, jnp.asarray(toks[:, :5]), max_len)
    tl, tc = TG.prefill(tcfg, tp, _t(toks[:, :5]), max_len)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **XTOL)
    attn = next(k for k in tc if k.endswith("_attn"))
    assert tc[attn]["k"].shape == tuple(jc[attn]["k"].shape)  # (R, B, W, Hs, D)
    assert tc[attn]["k"].shape[2] == tcfg.window
    for i in range(5, n):
        jl, jc = JG.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc = TG.decode_step(tcfg, tp, tc, _t(toks[:, i:i + 1]))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **XTOL)
        assert tc["length"] == int(jc["length"]) == i + 1
    _state_close(tc, jc)


def _paged_inputs(rng, cfg, B=4, P=10, maxp=3):
    """Shuffled physical pages per row; lengths with a fresh row (0) whose
    slot holds a stale tenant's state and a row past the window (its ring
    has wrapped); a pool of random states in the pool's layout."""
    tables = np.stack([rng.permutation(P)[:maxp] for _ in range(B)]).astype(np.int32)
    lengths = np.array([0, 5, 1, cfg.window + 7][:B], np.int32)
    shapes = TG.init_state_pool(cfg, P, 4, device="meta")
    pool = {kv: {key: rng.standard_normal(tuple(t.shape)).astype(np.float32)
                 for key, t in d.items()} for kv, d in shapes.items()}
    return tables, lengths, pool


def _jpool(pool):
    return {kv: {key: jnp.asarray(a) for key, a in d.items()} for kv, d in pool.items()}


def _tpool(pool):
    return {kv: {key: _t(a.copy()) for key, a in d.items()} for kv, d in pool.items()}


@pytest.mark.parametrize("which", ["adapter", "smoke"])
def test_griffin_paged_steps_match_reference(which):
    """paged_trunk_step, paged_prefill_chunk and paged_decode_step against
    the JAX package's, ragged lengths with a fresh row: hidden states,
    logits and the whole pool agree; the pool is written in place; the
    fresh row reads zeros, not the stale tenant; a chunk is its single
    steps bitwise."""
    jcfg, tcfg, jp, tp = _params(which)
    rng = np.random.default_rng(2)
    tables, lengths, pool = _paged_inputs(rng, tcfg)
    toks = rng.integers(0, jcfg.vocab_size, (4, 3)).astype(np.int32)
    jargs = (jnp.asarray(tables), jnp.asarray(lengths))
    targs = (_t(tables), _t(lengths))

    jh, jpool = JG.paged_trunk_step(jcfg, jp, _jpool(pool), *jargs, jnp.asarray(toks[:, 0]))
    tpool = _tpool(pool)
    th, tpool2 = TG.paged_trunk_step(tcfg, tp, tpool, *targs, _t(toks[:, 0]))
    assert th.shape == (4, 1, jcfg.d_model)
    assert all(tpool2[kv][key] is tpool[kv][key] for kv in tpool for key in tpool[kv])
    np.testing.assert_allclose(_np(th), np.asarray(jh), **XTOL)
    _state_close(tpool2, jpool)
    zpool = _tpool(pool)
    for d in zpool.values():
        for a in d.values():
            a[:, tables[0, 0]] = 0.0
    zh, _ = TG.paged_trunk_step(tcfg, tp, zpool, *targs, _t(toks[:, 0]))
    assert torch.equal(zh, th)

    jh, jpool = JG.paged_prefill_chunk(jcfg, jp, _jpool(pool), *jargs, jnp.asarray(toks))
    th, tpool = TG.paged_prefill_chunk(tcfg, tp, _tpool(pool), *targs, _t(toks))
    assert th.shape == (4, 3, jcfg.d_model)
    np.testing.assert_allclose(_np(th), np.asarray(jh), **XTOL)
    _state_close(tpool, jpool)
    spool = _tpool(pool)
    for c in range(3):
        h, spool = TG.paged_trunk_step(tcfg, tp, spool, _t(tables), _t(lengths + c),
                                       _t(toks[:, c]))
        assert torch.equal(h[:, 0], th[:, c])
    for kv in spool:
        for key in spool[kv]:
            assert torch.equal(spool[kv][key], tpool[kv][key])

    jl, _ = JG.paged_decode_step(jcfg, jp, _jpool(pool), *jargs, jnp.asarray(toks[:, 0]))
    tl, _ = TG.paged_decode_step(tcfg, tp, _tpool(pool), *targs, _t(toks[:, 0]))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **XTOL)


def _engines():
    """Both packages' engines over recurrentgemma's smoke config (tied head)
    with A/B/D merged and C a singleton."""
    jcfg, tcfg = _cfgs("hybrid", "smoke")
    jadapter, tadapter = jax_get_adapter("hybrid"), get_adapter("hybrid")
    jparams = {m: _jax_params("hybrid", "smoke", i, 0.05 * (i + 1)) for i, m in enumerate(MIDS)}
    js = JaxStore.from_models(jparams)
    ts = ParamStore.from_models({m: bridge.to_torch(p, device=CPU) for m, p in jparams.items()})
    _merge(jadapter, jcfg, js, MERGED, jax_enumerate_groups)
    _merge(tadapter, tcfg, ts, MERGED, enumerate_groups)
    common = dict(capacity_bytes=10 ** 9, buckets=DECODE_KW["buckets"], simulate_dma=False)
    jeng = JaxEngine(js, jax_instances(js, "tiny-yolo", model_ids=list(MIDS)),
                     [JaxProgram.from_adapter(jadapter, m, cfg=jcfg) for m in MIDS],
                     costs={"tiny-yolo": jax_costs_for("tiny-yolo")}, **common)
    teng = MergeAwareEngine(ts, instances_from_store(ts, "tiny-yolo", model_ids=list(MIDS)),
                            [ModelProgram.from_adapter(tadapter, m, cfg=tcfg) for m in MIDS],
                            costs={"tiny-yolo": costs_for("tiny-yolo")}, **common)
    return jeng, teng, jcfg, tcfg


def _requests(cls, cfg, n):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32) for _ in range(n)]
    return [cls(MIDS[i % len(MIDS)], prompts[i], max_new_tokens=NEW, meta=i) for i in range(n)]


def test_merged_tied_hybrid_group_streams_identically_in_both_packages():
    """Merged A/B/D (tied heads: one trunk dispatch, then one head per
    member) plus singleton C, the same prompts through both packages'
    StreamingDecoders with chunked prefill, every request past the window:
    equal statistics and tokens, logits within 1e-4, pool identity."""
    jeng, teng, jcfg, tcfg = _engines()
    assert sorted(map(tuple, teng.prefix_groups())) == [("A", "B", "D"), ("C",)]
    assert PROMPT + NEW - 1 > tcfg.window
    jstats = jeng.serve_decode(_requests(JD.DecodeRequest, jcfg, 8), record_logits=True,
                               **DECODE_KW)
    ops.reset_dispatch_counts()
    tstats = teng.serve_decode(_requests(TD.DecodeRequest, jcfg, 8), record_logits=True,
                               **DECODE_KW)
    dispatched = ops.dispatch_counts()["rg_lru_scan"]
    assert tstats["completed"] == 8 and tstats["pool_identity_ok"]
    assert tstats["lost_in_flight"] == 0 and tstats["unadmitted"] == 0
    assert tstats["trunk_dispatches"] == tstats["group_steps"] > 0
    assert tstats["bank_dispatches"] == 0 and tstats["head_dispatches"] > tstats["group_steps"]
    assert tstats["singleton_dispatches"] > 0 and tstats["prefill_chunk_dispatches"] > 0
    assert {k: v for k, v in tstats.items() if k not in TIME_KEYS} == \
        {k: v for k, v in jstats.items() if k not in TIME_KEYS}
    jc = {c.request.meta: c for c in jeng.last_decoder.completions}
    tc = {c.request.meta: c for c in teng.last_decoder.completions}
    assert sorted(tc) == sorted(jc) == list(range(8))
    for m in jc:
        assert tc[m].tokens == jc[m].tokens
        np.testing.assert_allclose(np.stack(tc[m].logits), np.stack(jc[m].logits), **XTOL)

    # every rg_lru_scan dispatch is one recurrent layer of one trunk pass
    passes = teng.last_decoder.trunk_passes
    n_rec = tcfg.pattern.count("rec") * tcfg.n_repeats
    assert dispatched == n_rec * (passes["warmup"] + passes["run"])
    assert passes["run"] > tstats["trunk_dispatches"] + tstats["singleton_dispatches"]


def test_griffin_paged_equals_unpaged_bitwise_at_one_slot_on_a_recycled_slot():
    """One slot, so every dispatch has batch 1: the paged, chunk-admitted
    stream replays bitwise through the unpaged decode_step, and every
    request after the first is admitted onto the state slot its
    predecessor left."""
    _, teng, jcfg, _ = _engines()
    first_pages = {}  # request id -> its state slot (page 0)

    def on_step(dec, step):
        pool = next(iter(dec._pools.values()))
        first_pages.update((rid, t[0]) for rid, t in pool.tables.items())

    reqs = [r for r in _requests(TD.DecodeRequest, jcfg, 8) if r.instance_id in MERGED][:3]
    stats = teng.serve_decode(reqs, record_logits=True, on_step=on_step,
                              **dict(DECODE_KW, max_slots=1, buckets=(1,)))
    assert stats["completed"] == 3 and stats["prefill_chunk_dispatches"] > 0
    assert len(first_pages) == 3 and len(set(first_pages.values())) == 1  # one slot, recycled
    assert TD.verify_bitwise(teng.last_decoder)


def test_griffin_decode_split_builds_and_needs_the_full_ring():
    """The hybrid adapter decodes; its unpaged cache refuses max_len <
    window (the paged ring always has ``window`` slots, so paged == unpaged
    needs the full ring), and its pool is the nested state pool."""
    _, tcfg = _cfgs("hybrid", "smoke")
    adapter = get_adapter("hybrid")
    ds = adapter.decode_split(tcfg)
    assert ds is adapter.decode_split(tcfg) and ds.bank_head is None
    assert ds.prefill_chunk is not None
    with pytest.raises(ValueError, match="window <= max_len"):
        ds.init_cache(1, tcfg.window - 1, device=CPU)
    cache = ds.init_cache(2, tcfg.window, device=CPU)
    assert cache["length"] == 0 and cache["2_attn"]["k"].shape[2] == tcfg.window
    pool = TD.PagedKVPool(lambda P, pg: ds.init_pool(P, pg, device=CPU), 5, 4)
    assert isinstance(pool.k, dict) and pool.device == CPU
    assert pool.k["0_rec"].shape == (tcfg.n_repeats, 5, tcfg.d_rnn)
    assert pool.v["2_attn"].shape == (tcfg.n_repeats, 5, tcfg.window,
                                      tcfg.kv_stored_heads, tcfg.head_dim)
