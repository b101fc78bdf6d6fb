"""The port's store and serving engine against the JAX package.

The same merges on the same (bridged) params must give the same bindings,
store keys, epochs and resident bytes as ``repro.core.ParamStore``; and the
two ``MergeAwareEngine``s (JAX in ref mode, ``simulate_dma=False``, far
deadlines) must serve the same requests with the same engine statistics
and allclose completions (1e-4: float32 summation order, see
test_torch_models.py).
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
from repro.models.registry import get_adapter as jax_get_adapter
from repro.serving.costs import costs_for as jax_costs_for
from repro.serving.executor import MergeAwareEngine as JaxEngine
from repro.serving.executor import ModelProgram as JaxProgram
from repro.serving.executor import Request as JaxRequest
from repro.serving.workload import instances_from_store as jax_instances
from repro_torch import bridge
from repro_torch.core import ParamStore, enumerate_groups
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_adapter
from repro_torch.serving.costs import costs_for
from repro_torch.serving.executor import MergeAwareEngine, ModelProgram, Request
from repro_torch.serving.workload import (
    deadline_microbatches, instances_from_store, pad_stack,
)

XTOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
BUCKETS = (1, 2, 4)
MERGED = ("A", "B", "D")  # C stays unmerged: a singleton group


def _family(name):
    jadapter = jax_get_adapter(name)
    tadapter = get_adapter(name)
    if name == "small_cnn":
        return jadapter, tadapter, jadapter.default_config(), tadapter.default_config()
    jcfg = dataclasses.replace(jax_stablelm.smoke_config(), scan_layers=False)
    names = {f.name for f in dataclasses.fields(TT.DenseLMConfig)} - {"dtype"}
    tcfg = TT.DenseLMConfig(**{n: getattr(jcfg, n) for n in names}, dtype="float32")
    return jadapter, tadapter, jcfg, tcfg


def _stores(name, mids=("A", "B", "C", "D")):
    jadapter, tadapter, jcfg, tcfg = _family(name)
    jparams = {m: jadapter.init(jcfg, jax.random.PRNGKey(i)) for i, m in enumerate(mids)}
    tparams = {m: bridge.to_torch(p, device=CPU) for m, p in jparams.items()}
    return JaxStore.from_models(jparams), ParamStore.from_models(tparams)


def _trunk_groups(adapter, cfg, store, mids, enumerate_fn):
    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m in mids for r in adapter.records(cfg, store.materialize(m), m)
            if r.path in trunk]
    return enumerate_fn(recs)


def _assert_same_store(js, ts):
    assert ts.bindings == js.bindings
    assert set(ts.buffers) == set(js.buffers)
    assert ts.epoch == js.epoch
    assert ts.resident_bytes() == js.resident_bytes()
    assert ts.shared_keys() == js.shared_keys()
    for m in js.bindings:
        assert ts.model_bytes(m) == js.model_bytes(m)
        assert ts.binding_signature(m) == js.binding_signature(m)


@pytest.mark.parametrize("name", ["small_cnn", "dense"])
def test_merges_give_same_bindings_keys_and_bytes(name):
    jadapter, tadapter, jcfg, tcfg = _family(name)
    js, ts = _stores(name)
    jgroups = _trunk_groups(jadapter, jcfg, js, MERGED, jax_enumerate_groups)
    tgroups = _trunk_groups(tadapter, tcfg, ts, MERGED, enumerate_groups)
    assert [g.signature for g in tgroups] == [g.signature for g in jgroups]
    before = ts.resident_bytes()
    for jg, tg in zip(jgroups, tgroups):
        assert ts.merge_group(tg) == js.merge_group(jg)
    _assert_same_store(js, ts)
    assert ts.resident_bytes() < before
    # a second merge of the same signatures is disambiguated, never aliased
    assert ts.merge_group(tgroups[0]) == js.merge_group(jgroups[0])
    _assert_same_store(js, ts)
    # shared keys hand every member the SAME tensor object
    key = next(iter(ts.shared_keys()))
    path = next(p for p, k in ts.bindings["A"].items() if k == key)
    flat = {m: ts.materialize(m) for m in MERGED}
    leaves = [flat[m] for m in MERGED]
    for part in path.split("/"):
        leaves = [leaf[part] for leaf in leaves]
    assert all(leaf is leaves[0] for leaf in leaves)
    # values match the JAX store's bitwise
    for k in ts.buffers:
        np.testing.assert_array_equal(bridge.tensor_to_array(ts.buffers[k]),
                                      np.asarray(js.buffers[k]))
    ts.unmerge(tgroups[1])
    js.unmerge(jgroups[1])
    _assert_same_store(js, ts)


def _payloads(name, cfg, n):
    rng = np.random.default_rng(5)
    if name == "small_cnn":
        return [rng.standard_normal((1, 32, 32, 3)).astype(np.float32) for _ in range(n)]
    return [rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("name", ["small_cnn", "dense"])
@pytest.mark.parametrize("suffix_bank", [True, False])
def test_engines_serve_the_same_requests_alike(name, suffix_bank):
    jadapter, tadapter, jcfg, tcfg = _family(name)
    mids = ("A", "B", "C", "D")
    js, ts = _stores(name, mids)
    for jg, tg in zip(_trunk_groups(jadapter, jcfg, js, MERGED, jax_enumerate_groups),
                      _trunk_groups(tadapter, tcfg, ts, MERGED, enumerate_groups)):
        js.merge_group(jg)
        ts.merge_group(tg)

    # 3 interleaved rounds over all members, then 4 more for A alone: fan-out
    # micro-batches, a single-member one, and the unmerged C's singleton group
    order = [m for _ in range(3) for m in mids] + ["A"] * 4
    payloads = _payloads(name, jcfg, len(order))
    jeng = JaxEngine(js, jax_instances(js, "tiny-yolo", model_ids=list(mids)),
                     [JaxProgram.from_adapter(jadapter, m, cfg=jcfg) for m in mids],
                     capacity_bytes=10 ** 9, costs={"tiny-yolo": jax_costs_for("tiny-yolo")},
                     buckets=BUCKETS, simulate_dma=False, suffix_bank=suffix_bank)
    teng = MergeAwareEngine(ts, instances_from_store(ts, "tiny-yolo", model_ids=list(mids)),
                            [ModelProgram.from_adapter(tadapter, m, cfg=tcfg) for m in mids],
                            capacity_bytes=10 ** 9, costs={"tiny-yolo": costs_for("tiny-yolo")},
                            buckets=BUCKETS, simulate_dma=False, suffix_bank=suffix_bank)
    for i, (m, p) in enumerate(zip(order, payloads)):
        deadline = 30.0 + i * 1e-3
        jeng.submit(JaxRequest(m, jnp.asarray(p), 0.0, deadline, meta=i))
        teng.submit(Request(m, torch.from_numpy(p.astype(np.int64) if p.dtype == np.int32
                                                else p), 0.0, deadline, meta=i))
    jstats = jeng.serve(horizon_s=60.0, warmup=jnp.asarray(payloads[0]))
    tstats = teng.serve(horizon_s=60.0, warmup=teng.queues["A"][0].payload)

    assert [g for g in teng.prefix_groups()] == [g for g in jeng.prefix_groups()]
    for k in ("completed", "microbatches", "prefix_runs", "suffix_runs",
              "suffix_dispatches", "bank_hits", "forward_runs", "skipped"):
        assert tstats[k] == jstats[k], k
    assert tstats["completed"] == len(order)
    assert tstats["forward_runs"] > 0 and tstats["prefix_runs"] > 0
    if suffix_bank:
        assert tstats["bank_hits"] > 0
    jres = {c.request.meta: np.asarray(c.result) for c in jeng.completions}
    tres = {c.request.meta: bridge.tensor_to_array(c.result) for c in teng.completions}
    assert sorted(tres) == sorted(jres)
    for i in jres:
        np.testing.assert_allclose(tres[i], jres[i], **XTOL)


def test_banked_rows_equal_direct_forwards_bitwise_on_cpu():
    """Every served row equals the member's direct forward on the same
    padded batch, bitwise (the port's CPU serving contract)."""
    _, adapter, _, cfg = _family("dense")
    mids = ("A", "B", "D")
    store = ParamStore.from_models({m: adapter.init(cfg, seed=i, device=CPU)
                                    for i, m in enumerate(mids)})
    for g in _trunk_groups(adapter, cfg, store, mids, enumerate_groups):
        store.merge_group(g)
    eng = MergeAwareEngine(store, instances_from_store(store, "tiny-yolo"),
                           [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in mids],
                           capacity_bytes=10 ** 9, costs={"tiny-yolo": costs_for("tiny-yolo")},
                           buckets=BUCKETS, simulate_dma=False)
    gen = torch.Generator().manual_seed(0)
    reqs = [Request(m, torch.randint(0, cfg.vocab_size, (1, 8), generator=gen), 0.0,
                    30.0 + (j * 3 + i) * 1e-3)
            for j in range(3) for i, m in enumerate(mids)]
    for r in reqs:
        eng.submit(r)
    stats = eng.serve(horizon_s=60.0, warmup=reqs[0].payload)
    assert stats["suffix_dispatches"] == stats["microbatches"] - stats["forward_runs"]
    res = {id(c.request): c.result for c in eng.completions}
    for mb in deadline_microbatches(reqs, BUCKETS):
        batch, n = pad_stack([r.payload for r in mb.requests], mb.bucket)
        assert batch.device == reqs[0].payload.device and n == len(mb.requests)
        for j, r in enumerate(mb.requests):
            direct = adapter.forward(cfg, store.materialize(r.instance_id), batch)[j]
            assert torch.equal(res[id(r)], direct)
