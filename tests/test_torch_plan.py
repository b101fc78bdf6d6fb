"""The port's planning step against the JAX package: the MergePlan wire
codec, plans shipped across packages, the CKA-prefiltered staged planner
and the live hot swap.

Every zoo is made once with numpy (a base, two variants whose trunks are
perturbed by 0.005 and heads by 1.0, and a foreign member from its own
init — the pattern of ``benchmarks/lm_merging.py``) and reaches both
packages as the same numbers: JAX arrays on one side, bridged tensors on
the other.  Calibration activations are the JAX adapter's, fed to both
planners as the same numpy arrays, so the CKA arithmetic (numpy float64 in
both) sees equal inputs: plans, similarities and wire bytes must then be
EQUAL, not close.  Where the port computes activations itself (its own
adapters), they are held to the JAX package's with the cross-package
float32 tolerance 1e-4 (XLA and PyTorch sum in different orders; see
test_torch_models.py).  Planners run with a counting clock, so event times
in the provenance are equal too.
"""
import itertools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import IncrementalMerger as JaxIncrementalMerger
from repro.core import MergePlan as JaxMergePlan
from repro.core import ParamStore as JaxStore
from repro.core import StagedPlanner as JaxStagedPlanner
from repro.core import enumerate_groups as jax_enumerate_groups
from repro.core.policy import CoherenceSurrogateTrainer as JaxSurrogate
from repro.core.policy import RepresentationSimilarityScorer as JaxSimScorer
from repro.core.signatures import decode_weight_entry as jax_decode
from repro.core.signatures import encode_weight_entry as jax_encode
from repro.core.validation import RegisteredModel as JaxRegistered
from repro.distributed.compression import quantize_int8 as jax_quantize_int8
from repro.models.registry import get_adapter as jax_get_adapter
from repro.serving.costs import costs_for as jax_costs_for
from repro.serving.executor import MergeAwareEngine as JaxEngine
from repro.serving.executor import ModelProgram as JaxProgram
from repro.serving.executor import Request as JaxRequest
from repro.serving.workload import instances_from_store as jax_instances
from repro.utils.tree import flatten_paths, unflatten_paths
from repro_torch import bridge
from repro_torch.core import (
    IncrementalMerger, MergePlan, ParamStore, RegisteredModel,
    RepresentationSimilarityScorer, StagedPlanner, enumerate_groups,
)
from repro_torch.core.policy import CoherenceSurrogateTrainer, linear_cka
from repro_torch.core.signatures import decode_weight_entry, encode_weight_entry
from repro_torch.distributed.compression import quantize_int8
from repro_torch.models.registry import get_adapter
from repro_torch.serving.costs import costs_for
from repro_torch.serving.executor import (
    MergeAwareEngine, ModelProgram, PlanApplyError, Request,
)
from repro_torch.serving.workload import deadline_microbatches, pad_stack

XTOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
MIDS = ("lm-A", "lm-B", "lm-C", "lm-D")  # lm-C is the foreign member
BUCKETS = (1, 2, 4)
# the scorer's and surrogate's min_similarity: the LM benchmark's 0.5 for
# dense; untrained convolutions of one image batch agree far above 0.5 (the
# foreign small_cnn's columns score 0.986-0.997), so the vision zoo's
# foreign member separates only at 0.99
MIN_SIM = {"small_cnn": 0.99, "dense": 0.5}


def _cfgs(name):
    jadapter, tadapter = jax_get_adapter(name), get_adapter(name)
    return jadapter, tadapter, jadapter.default_config(), tadapter.default_config()


def _is_head(path):
    return path.startswith(("final_norm/", "lm_head/", "head/"))


def _zoo(name):
    """{model_id: numpy param tree}: lm-A the base, lm-B / lm-D variants of
    it (trunk + 0.005 N(0,1), head + 1.0 N(0,1)), lm-C a foreign init."""
    jadapter, _, jcfg, _ = _cfgs(name)
    base = flatten_paths(jadapter.init(jcfg, jax.random.PRNGKey(0)))
    foreign = flatten_paths(jadapter.init(jcfg, jax.random.PRNGKey(42)))
    rng = np.random.default_rng(1)
    zoo = {"lm-A": {p: np.asarray(v) for p, v in base.items()},
           "lm-C": {p: np.asarray(v) for p, v in foreign.items()}}
    for mid in ("lm-B", "lm-D"):
        zoo[mid] = {p: (np.asarray(v) + (1.0 if _is_head(p) else 0.005)
                        * rng.standard_normal(v.shape)).astype(np.asarray(v).dtype)
                    for p, v in sorted(base.items())}
    return {m: unflatten_paths(zoo[m]) for m in MIDS}


def _stores(name, zoo=None):
    zoo = _zoo(name) if zoo is None else zoo
    js = JaxStore.from_models({m: jax.tree_util.tree_map(jnp.asarray, p)
                               for m, p in zoo.items()})
    ts = ParamStore.from_models({m: bridge.to_torch(p, device=CPU) for m, p in zoo.items()})
    return js, ts


def _calibration_batch(name, cfg, n=16):
    rng = np.random.default_rng(7)
    if name == "small_cnn":
        return {"images": rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
                "labels": rng.integers(0, cfg.n_classes, n).astype(np.int32)}
    toks = rng.integers(0, cfg.vocab_size, (n, 9)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _trunk_records(adapter, cfg, store):
    trunk = adapter.split(cfg).prefix_paths
    return [r for m in MIDS for r in adapter.records(cfg, store.materialize(m), m)
            if r.path in trunk]


def _assert_same_store(js, ts):
    assert ts.bindings == js.bindings
    assert set(ts.buffers) == set(js.buffers)
    assert ts.epoch == js.epoch
    assert ts.resident_bytes() == js.resident_bytes()
    for k in js.buffers:
        np.testing.assert_array_equal(bridge.tensor_to_array(ts.buffers[k]),
                                      np.asarray(js.buffers[k]))


# ---------------------------------------------------------------------------
# the wire codec
# ---------------------------------------------------------------------------


def _wire_cases():
    rng = np.random.default_rng(3)
    f32 = rng.standard_normal((5, 7)).astype(np.float32)
    f32_new = f32 + 0.01 * rng.standard_normal((5, 7)).astype(np.float32)
    bf16 = rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16)
    bf16_new = (bf16.astype(np.float32) + 0.5).astype(ml_dtypes.bfloat16)
    # (case, value, base, quantize, kind the JAX package picks)
    return [("f32-full", f32, None, False, "full"),
            ("bf16-full", bf16, None, False, "full"),
            ("f32-same", f32, f32.copy(), True, "same"),
            ("bf16-same", bf16, bf16.copy(), True, "same"),
            ("f32-delta_q8", f32_new, f32, True, "delta_q8"),
            # numpy's bfloat16 is not a float kind to the JAX package: a
            # changed bf16 buffer ships in full even when quantizing
            ("bf16-changed", bf16_new, bf16, True, "full"),
            ("f32-changed-unquantized", f32_new, f32, False, "full")]


@pytest.mark.parametrize("case,value,base,quantize,kind", _wire_cases(),
                         ids=[c[0] for c in _wire_cases()])
def test_wire_entries_are_byte_equal_and_decode_across(case, value, base, quantize, kind):
    ref = jax_encode(value, base=base, quantize=quantize)
    tval = bridge.array_to_tensor(value, CPU)
    tbase = None if base is None else bridge.array_to_tensor(base, CPU)
    port = encode_weight_entry(tval, base=tbase, quantize=quantize)
    assert ref["kind"] == kind
    assert json.dumps(port) == json.dumps(ref)
    # each package decodes the other's entry to the same bits
    from_ref = decode_weight_entry(ref, base=tbase)
    from_port = jax_decode(port, base=base)
    want = jax_decode(ref, base=base)
    assert str(from_port.dtype) == str(want.dtype)
    np.testing.assert_array_equal(bridge.tensor_to_array(from_ref), want)
    np.testing.assert_array_equal(from_port, want)


def test_quantize_int8_twin_gives_the_same_bytes_and_scale():
    x = np.random.default_rng(4).standard_normal((33, 9)).astype(np.float32)
    (q, s), (jq, js) = quantize_int8(x), jax_quantize_int8(x)
    assert q.tobytes() == jq.tobytes() and s == js


def test_wire_entry_from_a_delta_needs_its_base():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    entry = encode_weight_entry(t + 1, base=t, quantize=True)
    with pytest.raises(ValueError, match="needs the previously deployed"):
        decode_weight_entry(entry)
    with pytest.raises(ValueError, match="base mismatch"):
        decode_weight_entry(entry, base=t.double())


# ---------------------------------------------------------------------------
# plans shipped across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["small_cnn", "dense"])
def test_plan_exported_by_either_package_applies_in_the_other(name):
    jadapter, tadapter, jcfg, tcfg = _cfgs(name)
    zoo = _zoo(name)
    js, ts = _stores(name, zoo)
    jgroups = jax_enumerate_groups(_trunk_records(jadapter, jcfg, js))
    tgroups = enumerate_groups(_trunk_records(tadapter, tcfg, ts))
    for jg, tg in zip(jgroups, tgroups):
        assert ts.merge_group(tg) == js.merge_group(jg)
    _assert_same_store(js, ts)
    jpayload = js.export_plan(jgroups, provenance={"by": "cloud"},
                              include_weights=True).to_json()
    tpayload = ts.export_plan(tgroups, provenance={"by": "cloud"},
                              include_weights=True).to_json()
    assert tpayload == jpayload
    # the JAX package's plan on a fresh port store, and the reverse
    js2, ts2 = _stores(name, zoo)
    assert ts2.apply_plan(MergePlan.from_json(jpayload)) == \
        js2.apply_plan(JaxMergePlan.from_json(tpayload))
    assert ts2.bindings == js.bindings and js2.bindings == js.bindings
    assert js2.epoch == ts2.epoch == 1
    for k in js.buffers:
        np.testing.assert_array_equal(bridge.tensor_to_array(ts2.buffers[k]),
                                      np.asarray(js.buffers[k]))
        np.testing.assert_array_equal(np.asarray(js2.buffers[k]), np.asarray(js.buffers[k]))


def test_delta_plan_updates_the_deployed_buffers_alike():
    """A retrained buffer ships as an int8 residual against the deployed
    plan, an untouched one as ``same``: both packages encode the same
    entries and reconstruct the same bits."""
    jadapter, tadapter, jcfg, tcfg = _cfgs("dense")
    zoo = _zoo("dense")
    js, ts = _stores("dense", zoo)
    jg = jax_enumerate_groups(_trunk_records(jadapter, jcfg, js))[:2]
    tg = enumerate_groups(_trunk_records(tadapter, tcfg, ts))[:2]
    for a, b in zip(jg, tg):
        js.merge_group(a)
        ts.merge_group(b)
    deployed_plan = js.export_plan(jg, include_weights=True).to_json()
    deployed = {k: np.asarray(js.buffers[k]) for k in js.shared_keys()}
    key = sorted(deployed)[0]
    bump = np.random.default_rng(9).standard_normal(deployed[key].shape).astype(np.float32)
    js.update_buffers({key: jnp.asarray(deployed[key] + 0.01 * bump)})
    ts.update_buffers({key: torch.from_numpy(deployed[key] + 0.01 * bump)})
    assert ts.epoch == js.epoch
    jplan = js.export_plan(jg, include_weights=True, delta_base=deployed, quantize=True)
    tplan = ts.export_plan(tg, include_weights=True, quantize=True,
                           delta_base={k: torch.from_numpy(v.copy()) for k, v in deployed.items()})
    assert tplan.to_json() == jplan.to_json()
    assert jplan.shared_weights[key]["kind"] == "delta_q8"
    assert {e["kind"] for k, e in jplan.shared_weights.items() if k != key} == {"same"}
    # edges that hold the deployed plan take the delta from the other package
    js_edge, ts_edge = _stores("dense", zoo)
    js_edge.apply_plan(JaxMergePlan.from_json(deployed_plan))
    ts_edge.apply_plan(MergePlan.from_json(deployed_plan))
    js_edge.apply_plan(JaxMergePlan.from_json(tplan.to_json()))
    ts_edge.apply_plan(MergePlan.from_json(jplan.to_json()))
    assert ts_edge.bindings == js_edge.bindings
    for k in deployed:
        np.testing.assert_array_equal(bridge.tensor_to_array(ts_edge.buffers[k]),
                                      np.asarray(js_edge.buffers[k]))
    assert not np.array_equal(np.asarray(js_edge.buffers[key]), deployed[key])


# ---------------------------------------------------------------------------
# the staged planner
# ---------------------------------------------------------------------------


def _activations(name, zoo):
    """The JAX adapter's calibration activations, as numpy, for both."""
    jadapter, _, jcfg, _ = _cfgs(name)
    batch = {k: jnp.asarray(v) for k, v in _calibration_batch(name, jcfg).items()}
    return {m: jadapter.layer_activations(jcfg, jax.tree_util.tree_map(jnp.asarray, p), batch)
            for m, p in zoo.items()}


def _counting_clock():
    c = itertools.count()
    return lambda: float(next(c))


def _registered(cls, mids):
    """Trainer-free registrations (the surrogate reads no loss or data)."""
    return [cls(m, None, None, lambda e: [], None) for m in mids]


PLANNERS = {
    "staged-cka": (StagedPlanner, JaxStagedPlanner, True),
    "staged-memory": (StagedPlanner, JaxStagedPlanner, False),
    "incremental": (IncrementalMerger, JaxIncrementalMerger, False),
}


@pytest.mark.parametrize("name", ["small_cnn", "dense"])
@pytest.mark.parametrize("planner", sorted(PLANNERS))
def test_planner_plan_json_equals_the_reference_byte_for_byte(name, planner):
    """Same numpy activations, a counting clock: the port's plan JSON (with
    weights) is the JAX package's, for the CKA scorer and for the
    memory-forward order (where the surrogate's rejections drive the AIMD
    retries instead of the prefilter)."""
    tcls, jcls, cka = PLANNERS[planner]
    jadapter, tadapter, jcfg, tcfg = _cfgs(name)
    zoo = _zoo(name)
    acts = _activations(name, zoo)
    js, ts = _stores(name, zoo)
    ms = MIN_SIM[name]
    jkw = dict(trainer=JaxSurrogate(acts, ms), clock=_counting_clock())
    tkw = dict(trainer=CoherenceSurrogateTrainer(acts, ms), clock=_counting_clock())
    if cka:
        jkw["scorer"] = JaxSimScorer(acts, ms)
        tkw["scorer"] = RepresentationSimilarityScorer(acts, ms)
    jres = jcls(js, _registered(JaxRegistered, MIDS), _trunk_records(jadapter, jcfg, js),
                **jkw).run()
    tres = tcls(ts, _registered(RegisteredModel, MIDS), _trunk_records(tadapter, tcfg, ts),
                **tkw).run()
    payload = tres.plan.to_json()
    assert payload == jres.plan.to_json()
    assert (tres.attempted, tres.committed, tres.discarded, tres.pruned, tres.final_bytes) == \
        (jres.attempted, jres.committed, jres.discarded, jres.pruned, jres.final_bytes)
    assert tkw["trainer"].calls == jkw["trainer"].calls
    plan = MergePlan.from_json(payload)
    assert plan.groups and tres.final_bytes < tres.baseline_bytes
    if cka:
        # the prefilter keeps the variants' whole trunk, and the foreign
        # member only in part
        assert tkw["scorer"].pruned_members == jkw["scorer"].pruned_members > 0
        trunk = tadapter.split(tcfg).prefix_paths
        shared = plan.binding_deltas()
        for m in ("lm-A", "lm-B", "lm-D"):
            assert all((m, p) in shared for p in trunk), m
        assert not all(("lm-C", p) in shared for p in trunk)
    else:  # the surrogate's rejections drove AIMD retries
        assert tres.discarded > 0 or tres.attempted > tres.committed


@pytest.mark.parametrize("name", ["small_cnn", "dense"])
def test_similarities_equal_the_reference(name):
    jadapter, tadapter, jcfg, tcfg = _cfgs(name)
    zoo = _zoo(name)
    acts = _activations(name, zoo)
    js, ts = _stores(name, zoo)
    jsc = JaxSimScorer(acts, MIN_SIM[name])
    tsc = RepresentationSimilarityScorer(acts, MIN_SIM[name])
    jgroups = jax_enumerate_groups(_trunk_records(jadapter, jcfg, js))
    tgroups = enumerate_groups(_trunk_records(tadapter, tcfg, ts))
    for jg, tg in zip(jgroups, tgroups):
        assert tsc.similarity(tg) == jsc.similarity(jg)
        for jcol, tcol in zip(jg.columns(), tg.columns()):
            assert tsc.column_similarities(tcol) == jsc.column_similarities(jcol)
            keep_t, obs_t = tsc.column_cluster(tcol)
            keep_j, obs_j = jsc.column_cluster(jcol)
            assert [r.key for r in keep_t] == [r.key for r in keep_j] and obs_t == obs_j
    kept_t, pruned_t = tsc.prefilter(tgroups)
    kept_j, pruned_j = jsc.prefilter(jgroups)
    assert [[r.key for r in g.records] for g in kept_t] == \
        [[r.key for r in g.records] for g in kept_j]
    assert len(pruned_t) == len(pruned_j)


@pytest.mark.parametrize("name", ["small_cnn", "dense"])
def test_calibration_activations_match_the_reference(name):
    jadapter, tadapter, jcfg, tcfg = _cfgs(name)
    zoo = _zoo(name)
    batch = _calibration_batch(name, jcfg)
    for m in ("lm-A", "lm-C"):
        want = jadapter.layer_activations(jcfg, jax.tree_util.tree_map(jnp.asarray, zoo[m]),
                                          {k: jnp.asarray(v) for k, v in batch.items()})
        got = tadapter.layer_activations(tcfg, bridge.to_torch(zoo[m], device=CPU),
                                         {k: torch.from_numpy(v) for k, v in batch.items()})
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], **XTOL, err_msg=k)
    # every trunk record of the adapter has a probe under its layer key
    from repro_torch.core.policy import default_layer_key

    trunk = tadapter.split(tcfg).prefix_paths
    assert {default_layer_key(p) for p in trunk} <= set(got)
    assert linear_cka(got["embed" if name == "dense" else "stem"],
                      got["embed" if name == "dense" else "stem"]) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# the live hot swap
# ---------------------------------------------------------------------------


def _engines(name, zoo, suffix_bank=True):
    jadapter, tadapter, jcfg, tcfg = _cfgs(name)
    js, ts = _stores(name, zoo)
    jeng = JaxEngine(js, jax_instances(js, "tiny-yolo", model_ids=list(MIDS)),
                     [JaxProgram.from_adapter(jadapter, m, cfg=jcfg) for m in MIDS],
                     capacity_bytes=10 ** 9, costs={"tiny-yolo": jax_costs_for("tiny-yolo")},
                     buckets=BUCKETS, simulate_dma=False, suffix_bank=suffix_bank)
    from repro_torch.serving.workload import instances_from_store

    teng = MergeAwareEngine(ts, instances_from_store(ts, "tiny-yolo", model_ids=list(MIDS)),
                            [ModelProgram.from_adapter(tadapter, m, cfg=tcfg) for m in MIDS],
                            capacity_bytes=10 ** 9, costs={"tiny-yolo": costs_for("tiny-yolo")},
                            buckets=BUCKETS, simulate_dma=False, suffix_bank=suffix_bank)
    return jeng, teng


def _plan_payload(name, zoo):
    """The CKA-prefiltered staged plan over ``zoo`` (JAX package), as JSON."""
    jadapter, _, jcfg, _ = _cfgs(name)
    acts = _activations(name, zoo)
    js, _ = _stores(name, zoo)
    res = JaxStagedPlanner(js, _registered(JaxRegistered, MIDS),
                           _trunk_records(jadapter, jcfg, js), JaxSurrogate(acts, MIN_SIM[name]),
                           scorer=JaxSimScorer(acts, MIN_SIM[name]),
                           clock=_counting_clock()).run()
    return res.plan.to_json()


def _payloads(name, cfg, n):
    rng = np.random.default_rng(5)
    if name == "small_cnn":
        return [rng.standard_normal((1, 32, 32, 3)).astype(np.float32) for _ in range(n)]
    return [rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("name", ["small_cnn", "dense"])
def test_live_swap_keeps_queued_requests_and_serves_direct_forwards(name):
    """Requests queued on the unmerged engine survive the swap (one epoch
    bump, the same swap report as the JAX engine's) and are served on the
    plan's bindings: every row equals the member's direct forward on the
    same padded batch bitwise, through the suffix bank where a shared
    micro-batch mixes members, and the JAX engine's rows within 1e-4."""
    _, tadapter, _, tcfg = _cfgs(name)
    zoo = _zoo(name)
    payload = _plan_payload(name, zoo)
    jeng, teng = _engines(name, zoo)
    payloads = _payloads(name, tcfg, 4 * len(MIDS))
    treqs = []
    for j, x in enumerate(payloads):
        mid, dl = MIDS[j % len(MIDS)], 10.0 + j * 1e-3
        treqs.append(Request(mid, torch.from_numpy(x), 0.0, dl))
        teng.submit(treqs[-1])
        jeng.submit(JaxRequest(mid, jnp.asarray(x), 0.0, dl))
    epoch0 = teng.store.epoch
    swap = teng.apply_plan(MergePlan.from_json(payload))
    jswap = jeng.apply_plan(JaxMergePlan.from_json(payload))
    assert swap == jswap
    assert swap["epoch_bumps"] == 1 and teng.store.epoch == epoch0 + 1
    assert swap["pending_requests"] == len(treqs)
    groups = teng.prefix_groups()
    assert groups == jeng.prefix_groups()
    assert sorted(map(len, groups)) == [1, 3]  # lm-C keeps a private trunk
    stats = teng.serve(horizon_s=60.0)
    jstats = jeng.serve(horizon_s=60.0)
    assert stats["completed"] == jstats["completed"] == len(treqs)
    for k in ("prefix_runs", "suffix_dispatches", "forward_runs", "microbatches"):
        assert stats[k] == jstats[k], k
    shared = stats["microbatches"] - stats["forward_runs"]
    assert stats["suffix_dispatches"] == shared > 0
    res = {id(c.request): c.result for c in teng.completions}
    for group in groups:
        greqs = [r for r in treqs if r.instance_id in group]
        for mb in deadline_microbatches(greqs, BUCKETS):
            batch, _ = pad_stack([r.payload for r in mb.requests], mb.bucket)
            for j, r in enumerate(mb.requests):
                direct = tadapter.forward(tcfg, teng.store.materialize(r.instance_id), batch)
                assert torch.equal(res[id(r)], direct[j])
    jres = sorted((c.request.deadline_s, np.asarray(c.result)) for c in jeng.completions)
    tres = sorted((c.request.deadline_s, c.result.numpy()) for c in teng.completions)
    for (dj, a), (dt, b) in zip(jres, tres):
        assert dj == dt
        np.testing.assert_allclose(b, a, **XTOL)


def test_poisoned_plan_rolls_back_with_one_epoch_bump():
    _, _, _, tcfg = _cfgs("dense")
    zoo = _zoo("dense")
    obj = json.loads(_plan_payload("dense", zoo))
    key = sorted(obj["shared_weights"])[-1]
    obj["shared_weights"][key]["shape"] = [3, 5, 7]  # the bytes no longer fit
    _, teng = _engines("dense", zoo)
    for j, x in enumerate(_payloads("dense", tcfg, 6)):
        teng.submit(Request(MIDS[j % len(MIDS)], torch.from_numpy(x), 0.0, 10.0 + j))
    bindings0 = {m: dict(b) for m, b in teng.store.bindings.items()}
    buffers0 = dict(teng.store.buffers)
    epoch0, order0 = teng.store.epoch, [i.instance_id for i in teng.scheduler.order]
    with pytest.raises(PlanApplyError, match="rolled back"):
        teng.apply_plan(MergePlan.from_json(json.dumps(obj)))
    assert teng.store.bindings == bindings0
    assert teng.store.buffers.keys() == buffers0.keys()
    assert all(teng.store.buffers[k] is v for k, v in buffers0.items())
    assert teng.store.epoch == epoch0 + 1
    assert sum(len(q) for q in teng.queues.values()) == 6
    assert [i.instance_id for i in teng.scheduler.order] == order0
    assert teng.serve(horizon_s=60.0)["completed"] == 6
