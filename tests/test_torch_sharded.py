"""The port's mesh-sharded serve tier (DESIGN.md S3): ``distributed.sharding``,
``distributed.partitioning``, ``distributed.elastic``, ``ckpt.reshard``, the
store's placement and per-shard epochs, sharded admission, the shard-local
bank dispatch and ``bench.shard_serve`` — against the JAX package.

The JAX package's own mesh tests (``tests/test_sharded_store.py``) need 8
devices and skip on a plain host.  The port's mesh is a list of devices that
may repeat, so every test here runs on a (2, 4) mesh of eight ``cpu``
entries.  Cross-package checks:

* bookkeeping, EXACTLY equal: the JAX ``ParamStore`` takes a duck-typed
  placement, so a test-local stub with ``n_shards = 4`` (whose ``place`` /
  ``place_bank`` return their argument) gives it the port's shard count;
  ``shard_of``, ``resident_shards``, ``shard_epochs``,
  ``resident_bytes_by_shard`` and the scheduler's per-shard loads and
  admission order must equal the port's on the same plan;
* the logical rules and ``param_specs`` on a stub mesh (the JAX functions
  read only ``mesh.shape``);
* the port's sharded decode lane against the JAX bench's unsharded lane
  (``benchmarks/shard_serve.py``, ``placement=None``) on the JAX bench's
  draws: tokens exactly, logits within rtol = atol = 1e-5 after dividing
  both rows by the JAX row's largest magnitude, as the LM bench tests hold
  served rows (float32; XLA and torch sum in other orders, and the
  perturbed heads put logits near 17, where such sums land 1.4e-5 apart).
"""
import dataclasses
import pathlib
import sys
import types

import jax
import numpy as np
import pytest
import torch

import repro.core as jax_core
from repro.distributed import partitioning as JPART
from repro.distributed import sharding as JSHARD
from repro.models.registry import get_adapter as jax_get_adapter
from repro.serving import scheduler as jax_sched
from repro.serving.costs import costs_for as jax_costs_for
from repro.serving.workload import instances_from_store as jax_instances
from repro_torch import bridge
from repro_torch.bench import lm_merging as TLM
from repro_torch.bench import shard_serve as TSS
from repro_torch.ckpt.reshard import reshard_params, reshard_store
from repro_torch.core import MergePlan, ParamStore, enumerate_groups
from repro_torch.distributed import partitioning as TPART
from repro_torch.distributed.elastic import plan_for_devices
from repro_torch.distributed.sharding import (
    BankShards, LogicalRules, P, current_rules, logical_to_spec, make_mesh, shard_bank_fn,
    use_rules,
)
from repro_torch.kernels import ops
from repro_torch.serving.costs import costs_for
from repro_torch.serving.executor import MergeAwareEngine, ModelProgram, Request
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.workload import instances_from_store

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from benchmarks import lm_merging as LM  # noqa: E402
from benchmarks import shard_serve as SS  # noqa: E402
from test_torch_lm_bench import _lm_scenario  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
PROD_RULES = {"embed_fsdp": "data", "tensor": "model", "vocab": "model", "expert": "model",
              "layers": None, "batch": ("data",)}


def _placement():
    return TSS.mesh_placement(CPU)


class StubPlacement:
    """The JAX store's duck-typed placement at the port's shard count: places
    nothing."""

    n_shards = 4

    def place(self, arr, path=None):
        return arr

    def place_bank(self, arr):
        return arr


# ---------------------------------------------------------------------------
# the JAX bench's scenario: its zoo, its plan, its requests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scenario():
    """The JAX shard bench's draws as a port scenario, its plan's JSON, and
    its unsharded lane (``_engine(..., placement=None)`` + ``serve_decode``)."""
    jadapter = jax_get_adapter("dense")
    jcfg = jadapter.default_config()
    res, _ = LM.plan_variants(jadapter, jcfg)
    plan_json = res.plan.to_json()
    jeng = SS._engine(jadapter, jcfg, jax_core.MergePlan.from_json(plan_json))
    jreqs = SS._requests(jcfg, list(jeng.programs))
    jstats = jeng.serve_decode(jreqs, **SS.DECODE_KW)
    prompts = {}
    for j in range(SS.N_PER_MODEL):
        for i, m in enumerate(jeng.programs):
            prompts[(i, j)] = np.asarray(jreqs[j * len(jeng.programs) + i].prompt)
    scn = dataclasses.replace(
        _lm_scenario(), prompt=lambda i, j, n: prompts[(i, j)][:n].astype(np.int32))
    return dict(scn=scn, plan_json=plan_json, jstats=jstats,
                jmap=SS._completion_map(jeng.last_decoder), jadapter=jadapter, jcfg=jcfg)


def _plan(scenario):
    return MergePlan.from_json(scenario["plan_json"])


# ---------------------------------------------------------------------------
# the mesh, the rules, the partitioning
# ---------------------------------------------------------------------------


def test_mesh_positions_and_distinct_devices():
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    assert mesh.distinct_devices == (CPU,) and mesh.primary == CPU
    mixed = make_mesh((2, 4), ("data", "model"), ["cpu"] * 4 + ["meta"] * 4)
    assert mixed.device_at(data=1, model=0) == torch.device("meta")
    assert mixed.devices_along("model") == (CPU,) * 4
    assert mixed.distinct_devices == (CPU, torch.device("meta"))
    with pytest.raises(ValueError):
        make_mesh((2, 4), ("data", "model"), ["cpu"] * 7)
    with pytest.raises(IndexError):
        mesh.device_at(model=4)


def test_put_holds_a_replicated_tensor_once_per_distinct_device():
    mixed = make_mesh((2, 4), ("data", "model"), ["cpu"] * 4 + ["meta"] * 4)
    pl = TPART.MeshPlacement(LogicalRules(mixed, {}))
    t = torch.randn(3, 5)
    out = pl.place(t, "blocks/0/attn/wq")
    assert out is t  # already on the primary device
    (copy,) = TPART.replicas(out)
    assert copy.device.type == "meta" and copy.shape == t.shape
    assert TPART.replicas(_placement().place(torch.randn(2))) == ()
    split = TPART.MeshPlacement(LogicalRules(mixed, PROD_RULES))
    with pytest.raises(NotImplementedError):
        split.place(torch.randn(64, 64), "blocks/0/attn/wq")


def test_logical_rules_and_param_specs_match_the_reference():
    """``resolve``, ``leaf_logical_axes`` and ``param_specs`` under
    production-like rules on a stub (2, 4) mesh, over the dense smoke
    tree and a few synthetic leaves of every rule."""
    stub = types.SimpleNamespace(shape={"data": 2, "model": 4})
    jrules = JSHARD.LogicalRules(stub, PROD_RULES)
    trules = LogicalRules(make_mesh((2, 4), ("data", "model"), "cpu"), PROD_RULES)
    for axes in [("batch", "tensor"), ("embed_fsdp", "vocab"), (("data", "model"), "tensor"),
                 ("tensor", "tensor"), (None, "layers", "expert"), ()]:
        assert tuple(trules.resolve(axes)) == tuple(jrules.resolve(axes)), axes
    jadapter = jax_get_adapter("dense")
    jcfg = jadapter.default_config()
    jparams = jadapter.init(jcfg, jax.random.PRNGKey(0))
    extra = {f"x/{suffix}": np.zeros((4, 8, 12)[-len(axes):], np.float32)
             for suffix, axes in JPART._RULES}
    extra.update({f"stack/{suffix}": np.zeros((3, 4, 8, 12)[-len(axes) - 1:], np.float32)
                  for suffix, axes in JPART._RULES})
    extra["big/w"] = np.zeros((2048, 1024), np.float32)
    for tree in (jparams, {"x": extra, "blocks": jparams.get("blocks", {})}):
        jspecs = JPART.param_specs(tree, jrules)
        want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(s)
                for path, s in jax.tree_util.tree_flatten_with_path(
                    jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
        ttree = bridge.to_torch(tree, device="meta")
        specs = TPART.param_specs(ttree, trules)
        got = {p: tuple(specs_leaf) for p, specs_leaf in _flat_specs(specs).items()}
        assert got == want
    for path, leaf in extra.items():
        assert TPART.leaf_logical_axes(path, leaf.shape) == \
            JPART.leaf_logical_axes(path, leaf.shape), path
    assert TPART.param_specs({"a": torch.zeros(2), "n": {}}, None) == {"a": P(), "n": {}}


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_use_rules_scopes_the_current_rules():
    rules = LogicalRules(make_mesh((2, 4), ("data", "model"), "cpu"), {"tensor": "model"})
    assert current_rules() is None and logical_to_spec(None, ("tensor",)) == P()
    with use_rules(rules) as r:
        assert r is rules and current_rules() is rules
        assert logical_to_spec(current_rules(), ("tensor", None)) == P("model", None)
    assert current_rules() is None


def test_placement_resolves_four_bank_shards():
    pl = _placement()
    assert pl.n_shards == 4
    assert pl.bank_sharding(8).spec == P("model")
    assert pl.bank_sharding(7).spec == P()  # indivisible bank replicates
    w = torch.randn(8, 3, 5)
    shards = pl.place_bank(w)
    assert isinstance(shards, BankShards) and len(shards) == 4
    assert shards.shape == (8, 3, 5) and [t.device for t in shards.shards] == [CPU] * 4
    assert all(s.data_ptr() == w[2 * i].data_ptr() for i, s in enumerate(shards.shards))
    assert pl.place_bank(w[:7]).shape == (7, 3, 5)
    with pytest.raises(ValueError):
        TPART.MeshPlacement(LogicalRules(pl.mesh, {}), bank_axis="pod")


def test_plan_for_devices_matches_the_reference():
    from repro.distributed.elastic import plan_for_devices as jplan

    for args in [(8, 4), (16, 4, 2), (32, 4, 2), (4, 4), (12, 4, 0)]:
        got, want = plan_for_devices(*args), jplan(*args)
        assert (got.shape, got.axes, got.n_devices) == (want.shape, want.axes, want.n_devices)
    with pytest.raises(ValueError):
        plan_for_devices(2, 4)


def test_reshard_params_keeps_values_and_structure():
    rules = LogicalRules(make_mesh((2, 4), ("data", "model"), "cpu"), PROD_RULES)
    params = {"blocks": {"0": {"attn": {"wq": np.ones((8, 8), np.float32)}}},
              "ln": {}, "b": torch.arange(3.0)}
    out = reshard_params(params, rules)
    assert set(out) == {"blocks", "ln", "b"} and out["ln"] == {}
    assert torch.equal(out["blocks"]["0"]["attn"]["wq"], torch.ones(8, 8))
    assert out["b"] is params["b"]


# ---------------------------------------------------------------------------
# the store on a (2, 4) mesh of cpu entries
# ---------------------------------------------------------------------------


def _lm():
    scn = TLM.numpy_scenario(device="cpu")
    trunk = scn.adapter.split(scn.cfg).prefix_paths
    recs = [r for m in ("lm-A", "lm-B", "lm-D") for r in
            scn.adapter.records(scn.cfg, scn.zoo[m], m) if r.path in trunk]
    return scn, enumerate_groups(recs)


def _merged(scn, groups, placement=None):
    store = ParamStore.from_models(dict(scn.zoo), placement=placement)
    for g in groups:
        store.merge_group(g)
    return store


def _materialize_equal(a, b, mids) -> bool:
    from repro_torch.utils.tree import flatten_paths

    for m in mids:
        fa, fb = flatten_paths(a.materialize(m)), flatten_paths(b.materialize(m))
        if fa.keys() != fb.keys() or not all(torch.equal(fa[p], fb[p]) for p in fa):
            return False
    return True


def test_merge_unmerge_roundtrip_bitwise_vs_unplaced():
    scn, groups = _lm()
    placed, plain = _merged(scn, groups, _placement()), _merged(scn, groups)
    assert placed.n_shards == 4 and plain.n_shards == 1
    assert _materialize_equal(placed, plain, scn.mids)
    toks = torch.from_numpy(np.arange(16, dtype=np.int32).reshape(2, 8) % scn.cfg.vocab_size)
    for m in scn.mids:
        a = scn.adapter.forward(scn.cfg, placed.materialize(m), toks)
        assert torch.equal(a, scn.adapter.forward(scn.cfg, plain.materialize(m), toks))
    placed.unmerge(groups[0])
    plain.unmerge(groups[0])
    assert _materialize_equal(placed, plain, scn.mids)
    assert placed.bindings == plain.bindings


def test_apply_plan_bitwise_and_bumps_only_touched_shards(scenario):
    scn = scenario["scn"]
    cloud = ParamStore.from_models(dict(scn.zoo))
    cloud.apply_plan(_plan(scenario))
    edge = ParamStore.from_models(dict(scn.zoo), placement=_placement())
    before = dict(edge.shard_epochs)
    keys = edge.apply_plan(_plan(scenario))
    touched = {edge.shard_of(k) for k in keys}
    for s in range(edge.n_shards):
        assert edge.shard_epochs.get(s, 0) - before.get(s, 0) == (1 if s in touched else 0)
    assert _materialize_equal(edge, cloud, list(edge.bindings))


def test_update_buffers_bumps_only_home_shard():
    scn, groups = _lm()
    store = _merged(scn, groups, _placement())
    priv = next(k for k in sorted(store.buffers) if ":" in k and k not in store.shared_keys())
    before = dict(store.shard_epochs)
    store.update_buffers({priv: store.buffers[priv] + 1.0})
    bumped = [s for s in range(store.n_shards)
              if store.shard_epochs.get(s, 0) != before.get(s, 0)]
    assert bumped == [store.shard_of(priv)]


def test_reshard_store_installs_placement_and_stays_bitwise():
    scn, groups = _lm()
    store = _merged(scn, groups)
    ref = {m: {p: t.clone() for p, t in _flat(store.materialize(m)).items()} for m in scn.mids}
    mp = plan_for_devices(8, model_parallel=4)
    assert mp.shape == (2, 4) and mp.axes == ("data", "model")
    epochs = dict(store.shard_epochs)
    pl = reshard_store(store, LogicalRules(make_mesh(mp.shape, mp.axes, "cpu"), {}))
    assert store.placement is pl and store.n_shards == 4
    assert store.shard_epochs == {s: epochs.get(s, 0) + 1 for s in range(4)}
    for m in scn.mids:  # re-placing buffers moves devices, never bits
        got = _flat(store.materialize(m))
        assert all(torch.equal(got[p], ref[m][p]) for p in ref[m])
    assert reshard_store(store, None) is None  # back to one device
    assert store.n_shards == 1


def _flat(tree):
    from repro_torch.utils.tree import flatten_paths

    return flatten_paths(tree)


def test_shard_bank_fn_bitwise_vs_unsharded():
    """Plain and placed bank leaves; ``bank_matmul`` dispatches once per
    shard, at the local member count."""
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    g = torch.Generator().manual_seed(0)
    w = torch.randn(8, 16, 32, generator=g)
    x = torch.randn(4, 16, generator=g)

    def bank_gemm(bank, feats):
        return torch.einsum("bk,nkm->nbm", feats, bank["w"])

    assert torch.equal(shard_bank_fn(bank_gemm, mesh, "model")({"w": w}, x),
                       bank_gemm({"w": w}, x))
    members = []

    def bank_kernel(bank, feats):
        members.append(bank["w"].shape[0])
        return ops.bank_matmul(feats, bank["w"], bank["b"])

    b = torch.randn(8, 32, generator=g)
    placed = {"w": _placement().place_bank(w), "b": _placement().place_bank(b)}
    ops.reset_dispatch_counts()
    got = shard_bank_fn(bank_kernel, mesh, "model")(placed, x)
    assert ops.dispatch_counts()["bank_matmul"] == 4 and members == [2] * 4
    assert torch.equal(got, ops.bank_matmul(x, w, b))
    with pytest.raises(ValueError):
        shard_bank_fn(bank_gemm, mesh, "model")({"w": w[:6]}, x)


def test_resident_bytes_by_shard_replicates_shared():
    scn, groups = _lm()
    store = _merged(scn, groups, _placement())
    by_shard = store.resident_bytes_by_shard()
    shared = store.shared_keys()
    live = {k for b in store.bindings.values() for k in b.values()}
    shared_bytes = sum(store.buffers[k].nbytes for k in shared)
    for s in range(store.n_shards):
        priv = sum(store.buffers[k].nbytes for k in live - shared if store.shard_of(k) == s)
        assert by_shard[s] == shared_bytes + priv
    assert max(by_shard.values()) < store.resident_bytes()
    assert ParamStore.from_models(dict(scn.zoo)).resident_bytes_by_shard() == \
        {0: ParamStore.from_models(dict(scn.zoo)).resident_bytes()}


# ---------------------------------------------------------------------------
# cross-package bookkeeping: the JAX store with a stub placement
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both_stores(scenario):
    jzoo = LM.lm_zoo(scenario["jadapter"], scenario["jcfg"])
    jstore = jax_core.ParamStore.from_models(jzoo, placement=StubPlacement())
    tstore = ParamStore.from_models(dict(scenario["scn"].zoo), placement=_placement())
    return jstore, tstore


def test_shard_bookkeeping_equals_the_reference(scenario, both_stores):
    jstore, tstore = both_stores
    assert jstore.n_shards == tstore.n_shards == 4
    assert jstore.shard_epochs == tstore.shard_epochs == {}
    jkeys = jstore.apply_plan(jax_core.MergePlan.from_json(scenario["plan_json"]))
    tkeys = tstore.apply_plan(_plan(scenario))
    assert jkeys == tkeys and jstore.bindings == tstore.bindings
    assert jstore.shard_epochs == tstore.shard_epochs and len(tstore.shard_epochs) == 4
    for k in sorted(tstore.buffers):
        assert jstore.shard_of(k) == tstore.shard_of(k)
        assert jstore.resident_shards(k) == tstore.resident_shards(k)
    assert jstore.resident_bytes_by_shard() == tstore.resident_bytes_by_shard()
    assert jstore.resident_bytes_by_shard(["lm-A", "lm-C"]) == \
        tstore.resident_bytes_by_shard(["lm-A", "lm-C"])
    priv = next(k for k in sorted(tstore.buffers) if k.startswith("lm-C:"))
    jstore.update_buffers({priv: np.asarray(jstore.buffers[priv]) * 1.0})
    tstore.update_buffers({priv: tstore.buffers[priv] * 1.0})
    assert jstore.shard_epochs == tstore.shard_epochs
    assert jstore.epoch == tstore.epoch
    jbank = jstore.materialize_bank(("lm-A", "lm-B", "lm-D", "lm-E"), {"lm_head/w"})
    tbank = tstore.materialize_bank(("lm-A", "lm-B", "lm-D", "lm-E"), {"lm_head/w"})
    assert isinstance(tbank["lm_head"]["w"], BankShards)
    assert np.array_equal(np.asarray(jbank["lm_head"]["w"]),
                          torch.cat(tbank["lm_head"]["w"].shards).numpy())


def test_sharded_admission_equals_the_reference(both_stores):
    """Per-shard loads, evictions and the order under a per-shard capacity
    that holds one member's slice but not the group's."""
    jstore, tstore = both_stores
    jinst = jax_instances(jstore, "tiny-yolo")
    tinst = instances_from_store(tstore, "tiny-yolo")
    act = int(costs_for("tiny-yolo").activation_gb(1) * 1e9)
    assert act == int(jax_costs_for("tiny-yolo").activation_gb(1) * 1e9)
    per_inst = max(max(tstore.resident_bytes_by_shard([i.instance_id]).values()) for i in tinst)
    cap = act + per_inst + 1
    assert cap - act < max(tstore.resident_bytes_by_shard().values())
    js = jax_sched.Scheduler(jinst, cap, {"tiny-yolo": jax_costs_for("tiny-yolo")},
                             shard_fn=jstore.resident_shards, n_shards=4)
    ts = Scheduler(tinst, cap, {"tiny-yolo": costs_for("tiny-yolo")},
                   shard_fn=tstore.resident_shards, n_shards=4)
    assert [i.instance_id for i in js.order] == [i.instance_id for i in ts.order]
    evictions = 0
    for _ in range(2):
        for inst in ts.order:
            a, b = js.load(inst.instance_id, 1), ts.load(inst.instance_id, 1)
            for k in ("loaded_bytes", "loaded_bytes_by_shard", "evicted", "resident_bytes"):
                assert a[k] == b[k], k
            assert sorted(a["loaded_keys"]) == sorted(b["loaded_keys"])
            assert js.resident_bytes_by_shard() == ts.resident_bytes_by_shard()
            evictions += len(b["evicted"])
    assert evictions > 0 and js.stats == ts.stats
    batches = {i.instance_id: 1 for i in tinst}
    assert js.cycle_swap_bytes(batches) == ts.cycle_swap_bytes(batches)


# ---------------------------------------------------------------------------
# the engine's sharded paths
# ---------------------------------------------------------------------------


def test_engine_serve_is_bitwise_its_unsharded_serve(scenario):
    """``MergeAwareEngine.serve``'s bank micro-batches through the
    shard-local dispatch, against the same engine on an unplaced store."""
    scn = scenario["scn"]
    out = {}
    for lane, pl in (("plain", None), ("sharded", _placement())):
        eng = TSS.engine_over(scn, ParamStore.from_models(dict(scn.zoo), placement=pl))
        eng.apply_plan(_plan(scenario))
        reqs = TLM.lm_requests(scn)
        for r in reqs:
            eng.submit(r)
        ops.reset_dispatch_counts()
        with torch.no_grad():
            stats = eng.serve(horizon_s=60.0, warmup=reqs[0].payload)
        out[lane] = ({(c.request.instance_id, c.request.deadline_s): c.result
                      for c in eng.completions}, stats, ops.dispatch_counts()["bank_matmul"], eng)
    (pr, ps, pn, _), (sr, ss, sn, seng) = out["plain"], out["sharded"]
    assert pr.keys() == sr.keys() and all(torch.equal(pr[k], sr[k]) for k in pr)
    assert ps["suffix_dispatches"] == ss["suffix_dispatches"] > 0 and sn == 4 * pn
    assert set(ss["dma_bytes_by_shard"]) == {0, 1, 2, 3} and set(ps["dma_bytes_by_shard"]) == {0}
    # replicated keys land on every shard
    assert sum(ss["dma_bytes_by_shard"].values()) > sum(ps["dma_bytes_by_shard"].values())
    assert seng._bank_sharded and seng.maybe_shard_bank(len, 3) is len


# ---------------------------------------------------------------------------
# the bench: lanes against the JAX bench, gates
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bench(scenario, tmp_path_factory):
    from repro_torch.bench import common

    mp = pytest.MonkeyPatch()
    mp.setattr(common, "ARTIFACTS", str(tmp_path_factory.mktemp("artifacts")))
    lanes = {}
    with torch.no_grad():
        out = TSS.run(scenario["scn"], plan=_plan(scenario),
                      on_lane=lambda n, e, s: lanes.setdefault(n, completion(e, s)))
    mp.undo()
    return out, lanes


def completion(eng, stats):
    return TSS.completion_map(eng.last_decoder), stats


def test_sharded_lane_matches_the_reference_unsharded_lane(scenario, bench):
    _, lanes = bench
    got, stats = lanes["sharded"]
    want, jstats = scenario["jmap"], scenario["jstats"]
    assert got.keys() == want.keys() and len(got) == 10
    for k in want:
        assert got[k][0] == want[k][0], k
        assert len(got[k][1]) == len(want[k][1]) == SS.MAX_NEW
        for x, y in zip(got[k][1], want[k][1]):
            scale = np.abs(np.asarray(y)).max()
            np.testing.assert_allclose(x / scale, np.asarray(y) / scale, **TOL)
    for k in ("completed", "steps", "tokens_decoded", "prefill_chunk_dispatches",
              "bank_dispatches", "lost_in_flight", "trunk_dispatches", "admitted"):
        assert stats[k] == jstats[k], k


def test_shard_serve_meets_every_gate(bench):
    out, lanes = bench
    d = out["derived"]
    assert all(TSS.gates(d).values()), TSS.gates(d)
    assert d["sharded"] and d["bitwise"] and d["max_logit_diff"] == 0.0
    assert d["epoch_bumps_ok"] and d["apply_plan_epoch_bumps"] == 1
    assert d["bank_sharded_over_model_axis"] and d["over_budget_served"]
    assert d["update_buffers_bumped_shards"] == 1 and d["n_shards"] == 4
    weights_budget = d["over_budget_capacity_bytes"] - d["over_budget_activation_bytes"]
    assert d["max_shard_resident_bytes"] <= weights_budget < d["group_resident_bytes"]
    assert d["over_budget_completed"] == d["over_budget_submitted"] == 10
    assert set(d["dma_bytes_by_shard"]) == {0, 1, 2, 3}
    rows = {r["lane"]: r for r in out["rows"]}
    assert {k: v for k, v in rows["sharded"].items() if k != "lane"} == \
        {k: v for k, v in rows["unsharded"].items() if k != "lane"}
    assert rows["sharded"]["bank_dispatches"] > 0
    assert rows["sharded"]["prefill_chunk_dispatches"] > 0
    assert lanes["over-budget"][1]["completed"] == 10


def test_shard_serve_gates_fail_when_a_lane_does():
    d = dict(sharded=True, bitwise=False, epoch_bumps_ok=True, apply_plan_epoch_bumps=1,
             bank_sharded_over_model_axis=True, over_budget_served=True,
             over_budget_capacity_bytes=100, over_budget_activation_bytes=10,
             group_resident_bytes=90, max_shard_resident_bytes=80)
    failed = [k for k, ok in TSS.gates(d).items() if not ok]
    assert failed == ["bitwise", "weights budget < group_resident_bytes"]
