"""The port's recurrent families against the JAX package, on shared
parameters: ``ssm`` (falcon-mamba-7b: the selective scan) and ``hybrid``
(recurrentgemma-9b: the RG-LRU plus sliding-window attention).

JAX params cross through ``repro_torch.bridge``; inputs come from numpy.
The JAX side runs its kernels through the plain versions (the CPU default,
as its own tests do).  Configs: each family's adapter default (untied, so
its heads bank) and the smoke config of the full model (tied), both with
per-layer blocks, float32, at a ragged sequence length (the JAX models pad
the scans up to their chunk, the port's scans take any length).

Tolerances:
  * across packages in float32, 1e-4 — XLA and PyTorch reduce the same
    float32 GEMMs, norms and scans in different orders, and the
    differences compound through the layers (as in test_torch_models.py);
    tokens and the decoders' statistics must be equal;
  * inside the port on the CPU: ``suffix(prefix(x)) == forward(x)`` and
    bank == per-member head bitwise; a member's head served on a subset of
    a micro-batch's rows against the direct forward on the whole batch,
    1e-5 (the CPU GEMMs are not row-stable across M, see
    test_torch_decode.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import falcon_mamba_7b as jax_falcon
from repro.configs import recurrentgemma_9b as jax_rgemma
from repro.core import ParamStore as JaxStore
from repro.core import enumerate_groups as jax_enumerate_groups
from repro.models import griffin as JG
from repro.models import ssm as JS
from repro.models.registry import get_adapter as jax_get_adapter
from repro.serving import decode as JD
from repro.serving.costs import costs_for as jax_costs_for
from repro.serving.executor import MergeAwareEngine as JaxEngine
from repro.serving.executor import ModelProgram as JaxProgram
from repro.serving.workload import instances_from_store as jax_instances
from repro_torch import bridge
from repro_torch.configs import falcon_mamba_7b, recurrentgemma_9b
from repro_torch.core import ParamStore, enumerate_groups
from repro_torch.models import griffin as TG
from repro_torch.models import ssm as TS
from repro_torch.models.registry import get_adapter
from repro_torch.serving import decode as TD
from repro_torch.serving.costs import costs_for
from repro_torch.serving.executor import MergeAwareEngine, ModelProgram, Request
from repro_torch.serving.workload import deadline_microbatches, instances_from_store, pad_stack
from repro_torch.utils.tree import flatten_paths

XTOL = dict(rtol=1e-4, atol=1e-4)
ROW_TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
S_RAGGED = 21  # not a multiple of the configs' scan chunk (16)
# family -> (JAX model module, port model module, port config class,
#            JAX config module, port config module)
FAMILIES = {
    "ssm": (JS, TS, TS.MambaConfig, jax_falcon, falcon_mamba_7b),
    "hybrid": (JG, TG, TG.GriffinConfig, jax_rgemma, recurrentgemma_9b),
}
CASES = [(f, w) for f in FAMILIES for w in ("adapter", "smoke")]


def _port_cfg(cls, jcfg):
    names = {f.name for f in dataclasses.fields(cls)} - {"dtype"}
    return cls(**{n: getattr(jcfg, n) for n in names}, dtype=np.dtype(jcfg.dtype).name)


def _cfgs(family, which, **over):
    _, _, cls, jconf, _ = FAMILIES[family]
    if which == "adapter":
        jcfg = jax_get_adapter(family).default_config()
    else:
        jcfg = dataclasses.replace(jconf.smoke_config(), scan_layers=False)
    jcfg = dataclasses.replace(jcfg, **over)
    return jcfg, _port_cfg(cls, jcfg)


@functools.lru_cache(maxsize=None)
def _jax_params(family, which, seed, jitter=0.0):
    """The JAX package's init (cached: its op-by-op dispatch is the slow part
    of these tests), with deterministic non-zero offsets on every leaf when
    ``jitter`` is set (zero-init biases and norm scales would hide their
    paths).  Callers treat the tree as read-only."""
    jmod = FAMILIES[family][0]
    params = jmod.init(_cfgs(family, which)[0], jax.random.PRNGKey(seed))
    if not jitter:
        return params
    return jax.tree_util.tree_map(lambda l: jnp.asarray(
        np.asarray(l) + (jitter * np.cos(np.arange(l.size))).reshape(l.shape).astype(l.dtype)),
        params)


def _np(t):
    return np.asarray(bridge.tensor_to_array(t), np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _tokens(cfg, shape, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)
    return jnp.asarray(toks), torch.from_numpy(toks.astype(np.int64))


def test_port_configs_match_reference_widths():
    for family, (_, _, cls, jconf, tconf) in FAMILIES.items():
        for name in ("full_config", "smoke_config"):
            jcfg, tcfg = getattr(jconf, name)(), getattr(tconf, name)()
            assert _port_cfg(cls, jcfg) == tcfg
            assert tcfg.padded_vocab == jcfg.padded_vocab
        assert tconf.full_config().dtype == "bfloat16"
        assert tconf.FAMILY == family == get_adapter(family).name
        assert _port_cfg(cls, jax_get_adapter(family).default_config()) == \
            get_adapter(family).default_config()
    assert recurrentgemma_9b.full_config().head_dim == 256
    assert recurrentgemma_9b.full_config().tie_embeddings
    assert not falcon_mamba_7b.full_config().tie_embeddings


@pytest.mark.parametrize("family,which", CASES)
def test_init_has_the_reference_paths_shapes_and_dtypes(family, which):
    jmod, tmod, _, _, _ = FAMILIES[family]
    jcfg, tcfg = _cfgs(family, which, dtype=jnp.bfloat16)
    want = {p: (tuple(l.shape), str(l.dtype)) for p, l in
            flatten_paths(jax.eval_shape(lambda: jmod.init(
                jcfg, jax.random.PRNGKey(0)))).items()}
    got = {p: (tuple(l.shape), str(l.dtype).replace("torch.", ""))
           for p, l in flatten_paths(tmod.init(tcfg, 0, device="meta")).items()}
    assert got == want


@pytest.mark.parametrize("family,which", CASES)
def test_trunk_head_forward_bank_match_reference(family, which):
    jmod, tmod, _, _, _ = FAMILIES[family]
    jcfg, tcfg = _cfgs(family, which)
    mids = ("A", "B", "C")
    jparams = {m: _jax_params(family, which, i, 0.05 * (i + 1)) for i, m in enumerate(mids)}
    tparams = {m: bridge.to_torch(p, device=CPU) for m, p in jparams.items()}
    jt, tt = _tokens(jcfg, (2, S_RAGGED), 0)

    jx = jmod.trunk(jcfg, jparams["A"], jt)
    np.testing.assert_allclose(_np(tmod.trunk(tcfg, tparams["A"], tt)), np.asarray(jx), **XTOL)
    # the head on the SAME hidden states isolates the suffix
    txj = bridge.array_to_tensor(jx, CPU)
    np.testing.assert_allclose(_np(tmod.head(tcfg, tparams["B"], txj)),
                               np.asarray(jmod.head(jcfg, jparams["B"], jx)), **XTOL)
    np.testing.assert_allclose(_np(tmod.forward(tcfg, tparams["C"], tt)),
                               np.asarray(jmod.forward(jcfg, jparams["C"], jt)), **XTOL)
    if tcfg.tie_embeddings:
        with pytest.raises(ValueError, match="tied"):
            tmod.bank_head(tcfg, tparams["A"], txj)
        return
    tbank = ParamStore.from_models(tparams).materialize_bank(mids, tmod.head_paths(tparams["A"]))
    jbank = jax.tree_util.tree_map(lambda *l: jnp.stack(l),
                                   *[{k: p[k] for k in ("final_norm", "lm_head")}
                                     for p in jparams.values()])
    got = tmod.bank_head(tcfg, tbank, txj)
    assert got.shape == (3, 2, S_RAGGED, jcfg.padded_vocab) and got.dtype == torch.float32
    for mode in ("ref", "interpret"):
        want = jmod.bank_head(jcfg, jbank, jx, mode=mode)
        np.testing.assert_allclose(_np(got), np.asarray(want), **XTOL)


@pytest.mark.parametrize("family,which", CASES)
def test_split_and_bank_are_bitwise_inside_the_port(family, which):
    _, tcfg = _cfgs(family, which)
    adapter = get_adapter(family)
    mids = ("A", "B", "C")
    params = {m: adapter.init(tcfg, seed=i, device=CPU) for i, m in enumerate(mids)}
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, tcfg.vocab_size, (4, 9)))
    sp = adapter.split(tcfg)
    feats = sp.prefix(params["A"], toks)
    assert torch.equal(sp.suffix(params["A"], feats), adapter.forward(tcfg, params["A"], toks))
    assert (sp.bank_suffix is None) == tcfg.tie_embeddings
    if tcfg.tie_embeddings:
        # the tied head reads the embedding table, which the trunk owns
        assert "embed/table" in sp.prefix_paths and sp.suffix_paths is None
        return
    bank = ParamStore.from_models(params).materialize_bank(mids, sp.suffix_paths)
    out = sp.bank_suffix(bank, feats)
    for i, m in enumerate(mids):
        assert torch.equal(out[i], sp.suffix(params[m], feats))


def test_griffin_takes_standard_positions_only_and_has_no_decode_yet():
    """Explicit positions take the blocked attention (tests/test_torch_families.py
    holds them against the JAX package); given as 0..S-1 they agree with the
    standard path's flash attention.  Streaming decode is there
    (tests/test_torch_griffin_decode.py holds it against the JAX package):
    the adapter decodes and every program gets the split."""
    _, tcfg = _cfgs("hybrid", "adapter")
    params = get_adapter("hybrid").init(tcfg, seed=0, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 12)))
    explicit = TG.trunk(tcfg, params, toks,
                        positions=torch.arange(12, dtype=torch.int32).expand(2, 12))
    torch.testing.assert_close(explicit, TG.trunk(tcfg, params, toks), rtol=1e-5, atol=1e-5)
    adapter = get_adapter("hybrid")
    assert adapter.can_decode
    ds = adapter.decode_split(tcfg)
    assert ds.trunk_paths == adapter.split(tcfg).prefix_paths
    assert ModelProgram.from_adapter(adapter, "A", cfg=tcfg).decode is ds


# ---------------------------------------------------------------------------
# ssm decode against the JAX package
# ---------------------------------------------------------------------------


def _ssm_params(which="adapter"):
    jcfg, tcfg = _cfgs("ssm", which)
    jp = _jax_params("ssm", which, 0, 0.05)
    return jcfg, tcfg, jp, bridge.to_torch(jp, device=CPU)


@pytest.mark.parametrize("which", ["adapter", "smoke"])
def test_ssm_decode_step_matches_reference(which):
    """A 3-token first step (the prompt through the scan at S = 3), then
    single tokens (S = 1 with a carried state): logits and state agree."""
    jcfg, tcfg, jp, tp = _ssm_params(which)
    _, toks = _tokens(jcfg, (2, 7), 1)
    toks = toks.numpy().astype(np.int32)
    jc, tc = JS.init_cache(jcfg, 2), TS.init_cache(tcfg, 2, device=CPU)
    assert tc["h"].shape == tuple(jc["h"].shape) and tc["conv"].shape == tuple(jc["conv"].shape)
    for lo, hi in [(0, 3)] + [(i, i + 1) for i in range(3, 7)]:
        jl, jc = JS.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, lo:hi]))
        tl, tc = TS.decode_step(tcfg, tp, tc, _t(toks[:, lo:hi]))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **XTOL)
        assert tc["length"] == int(jc["length"]) == hi
    np.testing.assert_allclose(_np(tc["h"]), np.asarray(jc["h"]), **XTOL)
    np.testing.assert_allclose(_np(tc["conv"]), np.asarray(jc["conv"]), **XTOL)


def _paged_inputs(rng, jcfg, B=4, P=10, maxp=3):
    """Shuffled physical pages per row, lengths with a fresh row (0) whose
    page holds a stale tenant's state, a pool of random states."""
    tables = np.stack([rng.permutation(P)[:maxp] for _ in range(B)]).astype(np.int32)
    lengths = np.array([0, 5, 1, 9][:B], np.int32)
    pool = {"k": rng.standard_normal((jcfg.n_layers, P, jcfg.d_inner, jcfg.d_state)),
            "v": rng.standard_normal((jcfg.n_layers, P, jcfg.d_conv - 1, jcfg.d_inner))}
    return tables, lengths, {k: v.astype(np.float32) for k, v in pool.items()}


def test_ssm_paged_trunk_step_and_decode_step_match_reference():
    jcfg, tcfg, jp, tp = _ssm_params()
    rng = np.random.default_rng(2)
    tables, lengths, pool = _paged_inputs(rng, jcfg)
    toks = rng.integers(0, jcfg.vocab_size, 4).astype(np.int32)
    args = (jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(toks))
    jh, jpool = JS.paged_trunk_step(jcfg, jp, {k: jnp.asarray(v) for k, v in pool.items()},
                                    *args)
    tpool = {k: _t(v.copy()) for k, v in pool.items()}
    th, tpool2 = TS.paged_trunk_step(tcfg, tp, tpool, _t(tables), _t(lengths), _t(toks))
    assert th.shape == (4, 1, jcfg.d_model) and tpool2["k"] is tpool["k"]  # in place
    np.testing.assert_allclose(_np(th), np.asarray(jh), **XTOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(_np(tpool2[kv]), np.asarray(jpool[kv]), **XTOL)
    # the fresh row read zeros, not the stale tenant: a second pool whose
    # fresh slot held zeros gives the same bits
    zpool = {k: _t(v.copy()) for k, v in pool.items()}
    for v in zpool.values():
        v[:, tables[0, 0]] = 0.0
    zh, _ = TS.paged_trunk_step(tcfg, tp, zpool, _t(tables), _t(lengths), _t(toks))
    assert torch.equal(zh, th)
    jl, _ = JS.paged_decode_step(jcfg, jp, {k: jnp.asarray(v) for k, v in pool.items()}, *args)
    tl, _ = TS.paged_decode_step(tcfg, tp, {k: _t(v.copy()) for k, v in pool.items()},
                                 _t(tables), _t(lengths), _t(toks))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **XTOL)


def test_ssm_paged_prefill_chunk_matches_reference_and_single_steps():
    jcfg, tcfg, jp, tp = _ssm_params()
    rng = np.random.default_rng(3)
    tables, lengths, pool = _paged_inputs(rng, jcfg)
    toks = rng.integers(0, jcfg.vocab_size, (4, 3)).astype(np.int32)
    jh, jpool = JS.paged_prefill_chunk(jcfg, jp, {k: jnp.asarray(v) for k, v in pool.items()},
                                       jnp.asarray(tables), jnp.asarray(lengths),
                                       jnp.asarray(toks))
    th, tpool = TS.paged_prefill_chunk(tcfg, tp, {k: _t(v.copy()) for k, v in pool.items()},
                                       _t(tables), _t(lengths), _t(toks))
    assert th.shape == (4, 3, jcfg.d_model)
    np.testing.assert_allclose(_np(th), np.asarray(jh), **XTOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(_np(tpool[kv]), np.asarray(jpool[kv]), **XTOL)
    spool = {k: _t(v.copy()) for k, v in pool.items()}
    for c in range(3):  # one chunk IS the single-token steps, bitwise
        h, spool = TS.paged_trunk_step(tcfg, tp, spool, _t(tables), _t(lengths + c),
                                       _t(toks[:, c]))
        assert torch.equal(h[:, 0], th[:, c])
    assert torch.equal(spool["k"], tpool["k"]) and torch.equal(spool["v"], tpool["v"])


# ---------------------------------------------------------------------------
# merged serving
# ---------------------------------------------------------------------------

MIDS = ("A", "B", "C", "D")
MERGED = ("A", "B", "D")  # C stays unmerged: a singleton group
DECODE_KW = dict(page_size=4, num_pages=32, max_slots=6, max_len=16, buckets=(1, 2, 4),
                 chunked_prefill=True)
TIME_KEYS = ("elapsed_s", "tokens_per_s")


def _merge(adapter, cfg, store, mids, enumerate_fn):
    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m in mids for r in adapter.records(cfg, store.materialize(m), m)
            if r.path in trunk]
    for g in enumerate_fn(recs):
        store.merge_group(g)


def test_merged_ssm_group_streams_identically_in_both_packages():
    """Merged A/B/D plus singleton C, the same prompts through both
    packages' StreamingDecoders: equal statistics and tokens, logits within
    1e-4; the merged group steps with one trunk and one bank dispatch.
    Then, at one slot, the port's paged stream replays bitwise through its
    unpaged decode_step."""
    jcfg, tcfg = _cfgs("ssm", "adapter")
    jadapter, tadapter = jax_get_adapter("ssm"), get_adapter("ssm")
    jparams = {m: _jax_params("ssm", "adapter", i) for i, m in enumerate(MIDS)}
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
    assert sorted(map(tuple, teng.prefix_groups())) == [("A", "B", "D"), ("C",)]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab_size, 6).astype(np.int32) for _ in range(8)]
    reqs = {}
    for name, cls in (("jax", JD.DecodeRequest), ("torch", TD.DecodeRequest)):
        reqs[name] = [cls(MIDS[i % 4], prompts[i], max_new_tokens=5, meta=i) for i in range(8)]
    jstats = jeng.serve_decode(reqs["jax"], record_logits=True, **DECODE_KW)
    tstats = teng.serve_decode(reqs["torch"], record_logits=True, **DECODE_KW)
    assert tstats["completed"] == 8 and tstats["pool_identity_ok"]
    assert tstats["trunk_dispatches"] == tstats["bank_dispatches"] == tstats["group_steps"] > 0
    assert tstats["singleton_dispatches"] > 0 and tstats["prefill_chunk_dispatches"] > 0
    assert {k: v for k, v in tstats.items() if k not in TIME_KEYS} == \
        {k: v for k, v in jstats.items() if k not in TIME_KEYS}
    jc = {c.request.meta: c for c in jeng.last_decoder.completions}
    tc = {c.request.meta: c for c in teng.last_decoder.completions}
    assert sorted(tc) == sorted(jc) == list(range(8))
    for m in jc:
        assert tc[m].tokens == jc[m].tokens
        np.testing.assert_allclose(np.stack(tc[m].logits), np.stack(jc[m].logits), **XTOL)
    stats = teng.serve_decode(reqs["torch"][:4], record_logits=True,
                              **dict(DECODE_KW, max_slots=1, buckets=(1,)))
    assert stats["completed"] == 4 and stats["bank_dispatches"] > 0
    assert TD.verify_bitwise(teng.last_decoder)


def test_tied_griffin_group_serves_per_member_through_the_engine():
    """recurrentgemma's smoke config (tied head): every trunk group merged,
    so the embedding table is shared; the engine runs the trunk once per
    micro-batch and each member's head on its own rows (a tied head has no
    bank).  Every served row matches the member's direct forward, in the
    port and in the JAX package."""
    jcfg, tcfg = _cfgs("hybrid", "smoke")
    adapter = get_adapter("hybrid")
    mids = ("A", "B", "C")
    jparams = {m: _jax_params("hybrid", "smoke", i, 0.05 * (i + 1))
               for i, m in enumerate(mids)}
    store = ParamStore.from_models({m: bridge.to_torch(p, device=CPU)
                                    for m, p in jparams.items()})
    unmerged = store.resident_bytes()
    _merge(adapter, tcfg, store, mids, enumerate_groups)
    assert store.bindings["A"]["embed/table"] == store.bindings["C"]["embed/table"]
    assert store.bindings["A"]["final_norm/scale"] != store.bindings["B"]["final_norm/scale"]
    assert store.resident_bytes() < 0.4 * unmerged
    buckets = (1, 2, 4)
    eng = MergeAwareEngine(store, instances_from_store(store, "tiny-yolo"),
                           [ModelProgram.from_adapter(adapter, m, cfg=tcfg) for m in mids],
                           capacity_bytes=10 ** 9, costs={"tiny-yolo": costs_for("tiny-yolo")},
                           buckets=buckets, simulate_dma=False)
    assert eng.prefix_groups() == [list(mids)] and not eng._group_bankable(tuple(mids))
    rng = np.random.default_rng(5)
    reqs = [Request(m, torch.from_numpy(rng.integers(0, tcfg.vocab_size, (1, 10))), 0.0,
                    30.0 + (j * 3 + i) * 1e-3) for j in range(2) for i, m in enumerate(mids)]
    for r in reqs:
        eng.submit(r)
    stats = eng.serve(horizon_s=60.0)
    mbs = deadline_microbatches(reqs, buckets)
    assert stats["completed"] == len(reqs)
    assert stats["prefix_runs"] == stats["microbatches"] == len(mbs)
    assert stats["suffix_dispatches"] == stats["suffix_runs"] == sum(
        len({r.instance_id for r in mb.requests}) for mb in mbs)
    res = {id(c.request): c.result for c in eng.completions}
    merged = {m: jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(store.materialize(m)))
              for m in mids}
    jforward = jax.jit(functools.partial(JG.forward, jcfg))
    for mb in mbs:
        batch, _ = pad_stack([r.payload for r in mb.requests], mb.bucket)
        jbatch = jnp.asarray(batch.numpy().astype(np.int32))
        members = {r.instance_id for r in mb.requests}
        direct = {m: adapter.forward(tcfg, store.materialize(m), batch) for m in members}
        want = {m: np.asarray(jforward(merged[m], jbatch)) for m in members}
        for j, r in enumerate(mb.requests):
            got = res[id(r)]
            torch.testing.assert_close(got, direct[r.instance_id][j], **ROW_TOL)
            np.testing.assert_allclose(_np(got), want[r.instance_id][j], **XTOL)
