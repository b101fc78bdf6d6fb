"""The port's moe family (``repro_torch.models.moe``, ``MoEAdapter``)
against the JAX package's.

JAX params cross through ``repro_torch.bridge``; tokens and activations
come from numpy.  Configs: ``MoEAdapter.default_config()`` (4 experts,
top-2, a shared expert, per-token routing) and olmoe-1b-7b's smoke config
with per-layer blocks (8 experts, top-2, qk-norm, groups of 64 tokens), in
float32.

Tolerances:
  * routing decisions — the top-k expert indices, the kept mask and every
    token's queue position (the dispatch tensor) — exactly equal: a
    decision is discrete, and an ulp in the router's logits could flip it,
    so each test also reports the least gap between the K-th and
    (K + 1)-th probability at its seed (a flip needs a gap near 1e-7);
  * combine weights and aux loss 1e-6 (float32 softmax in both);
  * activations, logits, loss and caches 1e-4: XLA and PyTorch reduce the
    same float32 GEMMs, norms and softmaxes in different orders;
  * inside the port, paged against unpaged decode: bitwise at one slot.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import olmoe_1b_7b as jax_olmoe
from repro.models import moe as JM
from repro.models.registry import get_adapter as jax_get_adapter
from repro_torch import bridge
from repro_torch.configs import olmoe_1b_7b
from repro_torch.core import ParamStore, enumerate_groups
from repro_torch.models import moe as TM
from repro_torch.models.registry import get_adapter
from repro_torch.serving import decode as TD
from repro_torch.serving.costs import costs_for
from repro_torch.serving.executor import MergeAwareEngine, ModelProgram
from repro_torch.serving.workload import instances_from_store
from repro_torch.utils.tree import flatten_paths, unflatten_paths

XTOL = dict(rtol=1e-4, atol=1e-4)
RTOL = dict(rtol=1e-6, atol=1e-6)
CPU = torch.device("cpu")


def _port_cfg(jcfg) -> TM.MoELMConfig:
    names = {f.name for f in dataclasses.fields(TM.MoELMConfig)} - {"dtype"}
    return TM.MoELMConfig(**{n: getattr(jcfg, n) for n in names}, dtype="float32")


def _cfgs(which: str):
    if which == "default":
        jcfg = jax_get_adapter("moe").default_config()
        return jcfg, get_adapter("moe").default_config()
    jcfg = dataclasses.replace(jax_olmoe.smoke_config(), scan_layers=False)
    return jcfg, _port_cfg(jcfg)


CFGS = ["default", "olmoe-smoke"]


def _params(jcfg, seed=0):
    jp = jax.jit(JM.init, static_argnums=0)(jcfg, jax.random.PRNGKey(seed))
    return jp, bridge.to_torch(jp, device=CPU)


# the JAX package's decode steps, jitted (its eager op-by-op dispatch is slow)
_jdecode = jax.jit(JM.decode_step, static_argnums=0)


def _np(t):
    return np.asarray(bridge.tensor_to_array(t), np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tokens(jcfg, shape, seed):
    return np.random.default_rng(seed).integers(0, jcfg.vocab_size, shape).astype(np.int32)


def test_configs_are_the_reference_widths():
    for name in ("full_config", "smoke_config"):
        j, t = getattr(jax_olmoe, name)(), getattr(olmoe_1b_7b, name)()
        names = {f.name for f in dataclasses.fields(TM.MoELMConfig)} - {"dtype"}
        assert {n: getattr(t, n) for n in names} == {n: getattr(j, n) for n in names}
        assert t.dtype == jnp.dtype(j.dtype).name


@pytest.mark.parametrize("which", CFGS)
def test_params_have_the_reference_paths_shapes_and_dtypes(which):
    jcfg, tcfg = _cfgs(which)
    want = {p: (tuple(a.shape), jnp.dtype(a.dtype).name)
            for p, a in flatten_paths(jax.eval_shape(
                lambda: JM.init(jcfg, jax.random.PRNGKey(0)))).items()}
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in flatten_paths(TM.init(tcfg, 0, device="meta")).items()}
    assert got == want


def test_top_k_takes_the_lower_index_first_on_ties():
    """``jax.lax.top_k``'s order, ties included."""
    probs = np.array([[[0.2, 0.3, 0.3, 0.1, 0.1]], [[0.25, 0.25, 0.25, 0.25, 0.0]]],
                     np.float32)
    cfg = dataclasses.replace(get_adapter("moe").default_config(), n_experts=5, top_k=3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = TM.top_k(cfg, _t(probs))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert ti.numpy().tolist() == [[[1, 2, 0]], [[0, 1, 2]]]


def _topk_gap(probs: np.ndarray, K: int) -> float:
    srt = -np.sort(-probs, axis=-1)
    return float((srt[..., K - 1] - srt[..., K]).min())


@pytest.mark.parametrize("which", CFGS)
def test_route_decisions_equal_the_reference(which):
    jcfg, tcfg = _cfgs(which)
    jp, tp = _params(jcfg)
    w_j, w_t = jp["blocks"]["0"]["moe"]["router"]["w"], tp["blocks"]["0"]["moe"]["router"]["w"]
    G, s = 3, min(tcfg.group_size, 16)
    x = np.random.default_rng(4).standard_normal((G, s, tcfg.d_model)).astype(np.float32)
    jd, jc, ja = JM.route(jcfg, w_j, jnp.asarray(x))
    td, tc, ta = TM.route(tcfg, w_t, _t(x))
    probs = np.asarray(jax.nn.softmax(jnp.einsum("gsd,de->gse", jnp.asarray(x), w_j), -1))
    print(f"{which}: least gap between the K-th and (K+1)-th probability "
          f"{_topk_gap(probs, tcfg.top_k):.3e}")
    _, ji = jax.lax.top_k(jnp.asarray(probs), tcfg.top_k)
    _, ti = TM.top_k(tcfg, _t(probs))
    assert np.array_equal(ti.numpy(), np.asarray(ji))  # expert_idx
    assert np.array_equal(td.numpy(), np.asarray(jd))  # kept mask and queue positions
    assert np.array_equal(td.numpy().sum(-1) > 0, np.asarray(jd).sum(-1) > 0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **RTOL)
    np.testing.assert_allclose(float(ta), float(ja), **RTOL)


def test_route_drops_past_capacity_as_the_reference():
    """A group where every token prefers one expert: capacity C keeps the
    first C (token, k) pairs k-major, in both packages."""
    jcfg, tcfg = _cfgs("olmoe-smoke")
    w = np.zeros((tcfg.d_model, tcfg.n_experts), np.float32)
    w[:, 3] = 1.0
    w[:, 5] = 0.5
    x = np.abs(np.random.default_rng(5).standard_normal((1, 32, tcfg.d_model))).astype(np.float32)
    jd, jc, _ = JM.route(jcfg, jnp.asarray(w), jnp.asarray(x))
    td, tc, _ = TM.route(tcfg, _t(w), _t(x))
    kept = td.numpy().sum(-1)  # (G, s, E)
    assert kept[0, :, 3].sum() == tcfg.capacity(32) < 32  # tokens were dropped
    assert np.array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **RTOL)


@pytest.mark.parametrize("which", CFGS)
def test_moe_ffn_matches_reference(which):
    jcfg, tcfg = _cfgs(which)
    jp, tp = _params(jcfg)
    x = np.random.default_rng(6).standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    jt, tt = {}, {}
    jy, ja = JM.moe_ffn(jcfg, jp["blocks"]["1"]["moe"], jnp.asarray(x), taps=jt, tap_path="m")
    ty, ta = TM.moe_ffn(tcfg, tp["blocks"]["1"]["moe"], _t(x), taps=tt, tap_path="m")
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **XTOL)
    np.testing.assert_allclose(float(ta), float(ja), **RTOL)
    assert sorted(tt) == sorted(jt)
    for k in jt:
        np.testing.assert_allclose(_np(tt[k]), np.asarray(jt[k]), **XTOL)


@pytest.mark.parametrize("which", CFGS)
def test_forward_layer_activations_and_loss_match_reference(which):
    jcfg, tcfg = _cfgs(which)
    jp, tp = _params(jcfg)
    ja, ta = jax_get_adapter("moe"), get_adapter("moe")
    toks = _tokens(jcfg, (2, 9), 7)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jaux = JM.forward(jcfg, jp, jnp.asarray(batch["tokens"]))
    tl, taux = TM.forward(tcfg, tp, _t(batch["tokens"]))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **XTOL)
    np.testing.assert_allclose(float(taux), float(jaux), **XTOL)
    # the adapter's forward is head(trunk(x)): the logits without the aux
    assert torch.equal(ta.forward(tcfg, tp, _t(batch["tokens"])), tl)
    jacts = ja.layer_activations(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tacts = ta.layer_activations(tcfg, tp, {k: _t(v) for k, v in batch.items()})
    assert sorted(tacts) == sorted(jacts) and "blocks/0/moe/router" in tacts
    for k in jacts:
        np.testing.assert_allclose(tacts[k], np.asarray(jacts[k], np.float32), **XTOL)
    jloss = ja.loss(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss = ta.loss(tcfg, tp, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), **XTOL)


def test_dense_first_layers_forward_and_decode_match_reference():
    """deepseek's layout: one dense block under ``dense_blocks/0`` before
    the moe blocks, and its own decode cache."""
    jcfg = dataclasses.replace(jax_get_adapter("moe").default_config(), n_layers=3,
                               first_dense_layers=1)
    tcfg = _port_cfg(jcfg)
    jp, tp = _params(jcfg, seed=1)
    toks = _tokens(jcfg, (2, 6), 8)
    np.testing.assert_allclose(_np(TM.forward(tcfg, tp, _t(toks))[0]),
                               np.asarray(JM.forward(jcfg, jp, jnp.asarray(toks))[0]), **XTOL)
    jc, tc = JM.init_cache(jcfg, 2, 8), TM.init_cache(tcfg, 2, 8, device=CPU)
    for lo, hi in [(0, 3), (3, 4), (4, 5)]:
        jl, jc = _jdecode(jcfg, jp, jc, jnp.asarray(toks[:, lo:hi]))
        tl, tc = TM.decode_step(tcfg, tp, tc, _t(toks[:, lo:hi]))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **XTOL)
    for kv in ("k", "v", "k_dense", "v_dense"):
        np.testing.assert_allclose(_np(tc[kv]), np.asarray(jc[kv]), **XTOL)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", CFGS)
def test_decode_step_matches_reference(which):
    """The decode split's config (group_size 1): a 3-token first step (the
    masked-attention branch), then single tokens (decode_attention)."""
    jcfg, tcfg = _cfgs(which)
    jcfg, tcfg = (dataclasses.replace(c, group_size=1) for c in (jcfg, tcfg))
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, (2, 7), 9)
    jc, tc = JM.init_cache(jcfg, 2, 16), TM.init_cache(tcfg, 2, 16, device=CPU)
    assert tc["k"].shape == tuple(jc["k"].shape)
    for lo, hi in [(0, 3)] + [(i, i + 1) for i in range(3, 7)]:
        jl, jc = _jdecode(jcfg, jp, jc, jnp.asarray(toks[:, lo:hi]))
        tl, tc = TM.decode_step(tcfg, tp, tc, _t(toks[:, lo:hi]))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **XTOL)
        assert int(tc["length"]) == int(jc["length"]) == hi
    for kv in ("k", "v"):
        np.testing.assert_allclose(_np(tc[kv]), np.asarray(jc[kv]), **XTOL)


def _paged_inputs(rng, cfg, B=3, P=12, page=4, maxp=3):
    tables = np.stack([rng.permutation(P)[:maxp] for _ in range(B)]).astype(np.int32)
    lengths = rng.integers(0, page * maxp - 4, B).astype(np.int32)
    shape = (cfg.n_layers, P, page, cfg.kv_stored_heads, cfg.head_dim)
    pool = {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}
    return tables, lengths, pool


@pytest.mark.parametrize("which", CFGS)
def test_paged_steps_match_reference(which):
    """``paged_trunk_step``, ``paged_decode_step`` and
    ``paged_prefill_chunk`` against the JAX package's on shuffled pages
    with stale tenants; the pool is written in place."""
    jcfg, tcfg = _cfgs(which)
    jcfg, tcfg = (dataclasses.replace(c, group_size=1) for c in (jcfg, tcfg))
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(10)
    tables, lengths, pool = _paged_inputs(rng, tcfg)
    toks = rng.integers(0, jcfg.vocab_size, 3).astype(np.int32)
    args = (tables, lengths, toks)
    jh, jpool = JM.paged_trunk_step(jcfg, jp, {k: jnp.asarray(v) for k, v in pool.items()},
                                    *map(jnp.asarray, args))
    tpool = {k: _t(v) for k, v in pool.items()}
    th, tpool2 = TM.paged_trunk_step(tcfg, tp, tpool, *map(_t, args))
    assert tpool2["k"] is tpool["k"]
    np.testing.assert_allclose(_np(th), np.asarray(jh), **XTOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(_np(tpool2[kv]), np.asarray(jpool[kv]), **XTOL)
    jl, _ = JM.paged_decode_step(jcfg, jp, {k: jnp.asarray(v) for k, v in pool.items()},
                                 *map(jnp.asarray, args))
    tl, _ = TM.paged_decode_step(tcfg, tp, {k: _t(v) for k, v in pool.items()}, *map(_t, args))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **XTOL)
    chunk = rng.integers(0, jcfg.vocab_size, (3, 3)).astype(np.int32)
    jh, jpool = JM.paged_prefill_chunk(jcfg, jp, {k: jnp.asarray(v) for k, v in pool.items()},
                                       jnp.asarray(tables), jnp.asarray(lengths),
                                       jnp.asarray(chunk))
    th, tpool = TM.paged_prefill_chunk(tcfg, tp, {k: _t(v) for k, v in pool.items()},
                                       _t(tables), _t(lengths), _t(chunk))
    np.testing.assert_allclose(_np(th), np.asarray(jh), **XTOL)
    np.testing.assert_allclose(_np(tpool["k"]), np.asarray(jpool["k"]), **XTOL)


def test_paged_decode_rejects_dense_first_layers_and_windows():
    cfg = get_adapter("moe").default_config()
    for bad in (dict(first_dense_layers=1, n_layers=3), dict(window=4)):
        with pytest.raises(ValueError):
            TM.init_kv_pool(dataclasses.replace(cfg, **bad), 4, 4, device=CPU)


def test_paged_equals_unpaged_bitwise_at_one_slot():
    """The adapter's decode split (group_size 1) through the streaming
    decoder on a merged pair, one slot: every token and logits row equals
    the unpaged replay bitwise."""
    adapter = get_adapter("moe")
    cfg = adapter.default_config()
    jcfg = jax_get_adapter("moe").default_config()
    _, base = _params(jcfg)
    other = {p: t + 0.01 * torch.randn(t.shape, generator=torch.Generator().manual_seed(1))
             if p.startswith(("final_norm/", "lm_head/")) else t
             for p, t in flatten_paths(base).items()}
    store = ParamStore.from_models({"A": base, "B": unflatten_paths(other)})
    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m in ("A", "B") for r in adapter.records(cfg, store.materialize(m), m)
            if r.path in trunk]
    for g in enumerate_groups(recs):
        store.merge_group(g)
    eng = MergeAwareEngine(store, instances_from_store(store, "tiny-yolo", model_ids=["A", "B"]),
                           [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in "AB"],
                           capacity_bytes=10 ** 9, costs={"tiny-yolo": costs_for("tiny-yolo")},
                           buckets=(1, 2))
    assert len(eng.prefix_groups()) == 1 and eng._group_bankable(("A", "B"))
    rng = np.random.default_rng(11)
    reqs = [TD.DecodeRequest(m, rng.integers(0, cfg.vocab_size, 5).astype(np.int32), 6)
            for m in "ABAB"]
    stats = eng.serve_decode(reqs, record_logits=True, page_size=4, num_pages=16,
                             max_slots=1, max_len=12, chunked_prefill=True)
    assert stats["completed"] == 4 and stats["bank_dispatches"] > 0
    assert adapter.decode_split(cfg).init_cache(1, 4, device=CPU)["k"].shape[0] == cfg.n_layers
    assert TD.verify_bitwise(eng.last_decoder)
