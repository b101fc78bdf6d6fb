"""The port's workload simulator against the JAX package: the paper's
layer-spec zoo, its Appendix-A workloads, the Table 1/2 cost model with its
interpolation, the scheduler's swap accounting, the
batch-size profiler, the discrete-event simulator and the planner's
simulator-in-the-loop ``objective=``.

Every quantity here is Python or numpy arithmetic done in the same order in
both packages, so every comparison is EXACT: equal dataclasses, equal
floats, equal plan JSON.  The reference's own behavioural properties
(tests/test_serving.py) are run on the port as well.
"""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.configs import vision_workloads as JV
from repro.core import MergePlan as JaxMergePlan
from repro.core import ParamStore as JaxStore
from repro.core import StagedPlanner as JaxStagedPlanner
from repro.core import enumerate_groups as jax_enumerate_groups
from repro.core.merging import MergeResult as JaxMergeResult
from repro.core.signatures import records_from_params as jax_records_from_params
from repro.core.signatures import records_from_spec as jax_records_from_spec
from repro.core.validation import RegisteredModel as JaxRegistered
from repro.models import vision as JVI
from repro.serving import costs as JC
from repro.serving import profiler as JP
from repro.serving import scheduler as JS
from repro.serving import simulator as JSIM
from repro.serving import workload as JW
from repro_torch.configs import vision_workloads as TV
from repro_torch.core import MergePlan, MergeResult, ParamStore, RegisteredModel, StagedPlanner
from repro_torch.core import enumerate_groups
from repro_torch.core.signatures import records_from_params, records_from_spec
from repro_torch.models import vision as TVI
from repro_torch.serving import costs as TC
from repro_torch.serving import profiler as TP
from repro_torch.serving import scheduler as TS
from repro_torch.serving import simulator as TSIM
from repro_torch.serving import workload as TW
from repro_torch.utils.tree import leaf_bytes

SPEC_IDS = sorted(JVI.SPEC_BUILDERS)
SIM_WORKLOADS = ("LP2", "MP2", "HP4")
SETTINGS = ("min", "50%", "75%", "max")


@pytest.fixture(scope="module")
def workloads():
    """Both packages' 15 workloads (the six constructed ones drawn once)."""
    return JV.all_workloads(), TV.all_workloads()


def _insts(insts):
    return [dataclasses.asdict(i) for i in insts]


# ---------------------------------------------------------------------------
# descriptors, records, workloads, costs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model_id", SPEC_IDS)
def test_spec_descriptors_and_records_equal_the_reference(model_id):
    assert sorted(TVI.SPEC_BUILDERS) == SPEC_IDS
    js, ts = JVI.get_spec(model_id), TVI.get_spec(model_id)
    assert (ts.name, ts.family, ts.task, ts.params, ts.bytes) == \
        (js.name, js.family, js.task, js.params, js.bytes)
    assert [(l.name, l.kind, l.shape, l.stride, l.params, l.bytes, l.signature)
            for l in ts.layers] == \
        [(l.name, l.kind, l.shape, l.stride, l.params, l.bytes, l.signature)
         for l in js.layers]
    assert [dataclasses.astuple(r) for r in records_from_spec(ts)] == \
        [dataclasses.astuple(r) for r in jax_records_from_spec(js)]
    assert [dataclasses.astuple(r) for r in records_from_spec(ts, "x#3")] == \
        [dataclasses.astuple(r) for r in jax_records_from_spec(js, "x#3")]
    assert dataclasses.asdict(TC.costs_for(model_id)) == dataclasses.asdict(JC.costs_for(model_id))


def test_costs_interpolate_outside_the_paper_tables():
    outside = [m for m in SPEC_IDS if m not in TC._TABLES]
    assert outside == sorted(m for m in SPEC_IDS if m not in JC._TABLES) and outside
    for m in outside:
        tc, jc = TC.costs_for(m), JC.costs_for(m)
        for b in (1, 2, 3, 4, 8):
            assert (tc.run_time(b), tc.run_mem(b), tc.activation_gb(b)) == \
                (jc.run_time(b), jc.run_mem(b), jc.activation_gb(b))


def test_workloads_records_and_ids_equal_the_reference(workloads):
    jw, tw = workloads
    assert list(tw) == list(jw) and len(tw) == 15
    assert tw == jw  # construct_missing's draws included
    assert TV.all_workloads(include_constructed=False) == JV.all_workloads(False) == \
        {k: jw[k] for k in JV.WORKLOADS}
    for name in TV.WORKLOADS:
        assert TV.instance_ids(name) == JV.instance_ids(name)
        assert [dataclasses.astuple(r) for r in TV.workload_records(name)] == \
            [dataclasses.astuple(r) for r in JV.workload_records(name)]
        assert TV.workload_class(name) == JV.workload_class(name)


@pytest.mark.parametrize("merged", ["none", "optimal", "groups", "plan"])
def test_build_instances_equal_the_reference(workloads, merged):
    jw, tw = workloads
    for name in ("LP1", "MP2", "HP1"):
        kw_j, kw_t = dict(workloads=jw), dict(workloads=tw)
        if merged in ("groups", "plan"):
            # the three heaviest groups of the workload's records
            jrecs = [dataclasses.replace(r, model_id=f"{m}#{k}")
                     for k, (m, _, _) in enumerate(jw[name])
                     for r in jax_records_from_spec(JVI.get_spec(m))]
            trecs = [dataclasses.replace(r, model_id=f"{m}#{k}")
                     for k, (m, _, _) in enumerate(tw[name])
                     for r in records_from_spec(TVI.get_spec(m))]
            jg = sorted(jax_enumerate_groups(jrecs), key=lambda g: -g.savings)[:3]
            tg = sorted(enumerate_groups(trecs), key=lambda g: -g.savings)[:3]
            assert [g.signature for g in tg] == [g.signature for g in jg]
            if merged == "groups":
                kw_j["shared_groups"], kw_t["shared_groups"] = jg, tg
            else:
                jplan = JaxMergePlan.from_groups(jg)
                kw_j["plan"] = jplan
                kw_t["plan"] = MergePlan.from_json(jplan.to_json())
        acc = {f"{m}#{k}": 0.5 + 0.01 * k for k, (m, _, _) in enumerate(jw[name])}
        j = JW.build_instances(name, merged=merged, accuracies=acc, **kw_j)
        t = TW.build_instances(name, merged=merged, accuracies=acc, **kw_t)
        assert _insts(t) == _insts(j)
        if merged != "none":  # some keys are shared across instances
            assert len({k for i in t for k in i.keys}) < sum(len(i.keys) for i in t)
    with pytest.raises(ValueError):
        TW.build_instances("MP2", merged="plan")


def test_memory_settings_and_workload_costs_equal_the_reference(workloads):
    jw, tw = workloads
    for name in jw:
        assert TW.memory_settings(name, tw) == JW.memory_settings(name, jw)
        jc, tc = JW.workload_costs(name, jw), TW.workload_costs(name, tw)
        assert {m: dataclasses.asdict(c) for m, c in tc.items()} == \
            {m: dataclasses.asdict(c) for m, c in jc.items()}


# ---------------------------------------------------------------------------
# scheduler, profiler, simulator
# ---------------------------------------------------------------------------


def _schedulers(name, merged, setting="min", jw=None, tw=None):
    cap = JW.memory_settings(name, jw)[setting]
    jc, tc = JW.workload_costs(name, jw), TW.workload_costs(name, tw)
    ji = JW.build_instances(name, merged=merged, workloads=jw)
    ti = TW.build_instances(name, merged=merged, workloads=tw)
    on = merged != "none"
    return (JS.Scheduler(ji, cap, jc, merged=on), TS.Scheduler(ti, cap, tc, merged=on),
            jc, tc)


@pytest.mark.parametrize("name", SIM_WORKLOADS)
@pytest.mark.parametrize("merged", ["none", "optimal"])
def test_scheduler_order_swap_accounting_and_profile_equal_the_reference(name, merged):
    js, ts, jc, tc = _schedulers(name, merged)
    order = [i.instance_id for i in ts.order]
    assert order == [i.instance_id for i in js.order]
    if merged == "none":
        assert order == sorted(order)
    batches = {iid: 1 + k % 3 for k, iid in enumerate(order)}
    tswap, jswap = ts.cycle_swap_bytes(batches), js.cycle_swap_bytes(batches)
    assert tswap == jswap
    for iid in order:
        for b in (1, 2, 3, 4, 8):
            assert ts.run_time_ms(iid, b) == js.run_time_ms(iid, b)
    # the profile walks the same loads: a load sequence moves both alike
    for iid in order[::-1] + order:
        assert ts.load(iid, batches[iid]) == js.load(iid, batches[iid])
    assert ts.stats == js.stats
    tcb = {i.instance_id: tc[i.model_id] for i in ts.order}
    jcb = {i.instance_id: jc[i.model_id] for i in js.order}
    assert TP.cycle_time_ms(order, batches, tcb, tswap) == \
        JP.cycle_time_ms(order, batches, jcb, jswap)
    for sla_ms in (100.0, 30.0):
        tp = TP.profile_workload(order, tcb, tswap, sla_ms=sla_ms)
        jp = JP.profile_workload(order, jcb, jswap, sla_ms=sla_ms)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


@pytest.mark.parametrize("name", SIM_WORKLOADS)
def test_simulate_equals_the_reference_at_every_memory_setting(name):
    for setting, merged in itertools.product(SETTINGS, ("none", "optimal")):
        js, ts, _, _ = _schedulers(name, merged, setting)
        batches = {i.instance_id: 1 for i in ts.order}
        tres = TSIM.simulate(ts, batches, horizon_ms=10_000)
        jres = JSIM.simulate(js, batches, horizon_ms=10_000)
        assert dataclasses.asdict(tres) == dataclasses.asdict(jres), (setting, merged)
        assert (tres.overall_accuracy, tres.processed_fraction) == \
            (jres.overall_accuracy, jres.processed_fraction)
        assert ts.stats == js.stats


def test_simulate_with_drift_events_and_cascade_equals_the_reference():
    for merged in ("none", "optimal"):
        js, ts, _, _ = _schedulers("MP2", merged)
        order = [i.instance_id for i in ts.order]
        batches = {iid: 2 for iid in order}
        events = [(1500.0, order[0], 0.4), (4000.0, order[0], 0.9), (2500.0, order[-1], 0.1),
                  (3000.0, "not-an-instance", 0.0)]
        tres = TSIM.simulate(ts, batches, horizon_ms=8_000,
                             drift_events=[TSIM.DriftEvent(*e) for e in events])
        jres = JSIM.simulate(js, batches, horizon_ms=8_000,
                             drift_events=[JSIM.DriftEvent(*e) for e in events])
        assert dataclasses.asdict(tres) == dataclasses.asdict(jres)
        js, ts, _, _ = _schedulers("MP2", merged)
        cascade = {order[0]: (0.25, 0.6), order[2]: (0.5, 0.8), order[3]: (1.0, 0.0)}
        kw = dict(horizon_ms=8_000, fps=25.0, sla_ms=120.0, cascade=cascade)
        tres = TSIM.simulate(ts, batches, **kw)
        jres = JSIM.simulate(js, batches, **kw)
        assert dataclasses.asdict(tres) == dataclasses.asdict(jres)
        assert tres.gated[order[0]] > 0 and tres.gated[order[3]] == 0
        assert tres.processed_fraction == jres.processed_fraction


# the reference's own properties (tests/test_serving.py), run on the port


def test_profiler_respects_sla():
    name = "MP2"
    costs = TW.workload_costs(name)
    sched = TS.Scheduler(TW.build_instances(name), TW.memory_settings(name)["min"], costs)
    order = [i.instance_id for i in sched.order]
    cost_by_inst = {i.instance_id: costs[i.model_id] for i in sched.order}
    swap = sched.cycle_swap_bytes({i: 1 for i in order})
    prof = TP.profile_workload(order, cost_by_inst, swap, sla_ms=100.0)
    assert prof.cycle_ms <= 100.0 or all(b == 1 for b in prof.batch_sizes.values())


@pytest.mark.parametrize("name", ["LP2", "MP2"])
def test_merging_never_hurts(name):
    """Merged workload: accuracy >= unmerged, swap bytes <= unmerged."""
    cap = TW.memory_settings(name)["min"]
    costs = TW.workload_costs(name)
    out = {}
    for merged in ["none", "optimal"]:
        insts = TW.build_instances(name, merged=merged)
        sched = TS.Scheduler(insts, cap, costs, merged=(merged != "none"))
        out[merged] = TSIM.simulate(sched, {i.instance_id: 1 for i in insts},
                                    horizon_ms=10_000)
    assert out["optimal"].swap_ms_total <= out["none"].swap_ms_total
    assert out["optimal"].overall_accuracy >= out["none"].overall_accuracy - 1e-9


def test_more_memory_less_swap():
    name = "HP4"
    costs = TW.workload_costs(name)
    ms = TW.memory_settings(name)
    swaps = []
    for setting in SETTINGS:
        insts = TW.build_instances(name)
        res = TSIM.simulate(TS.Scheduler(insts, ms[setting], costs),
                            {i.instance_id: 1 for i in insts}, horizon_ms=10_000)
        swaps.append(res.swap_ms_total)
    assert swaps[-1] <= swaps[0]


# ---------------------------------------------------------------------------
# the planner's simulator-in-the-loop objective
# ---------------------------------------------------------------------------


CNN_MIDS = ("A", "B", "C", "D")
MODEL_GB = 1.0  # what each small CNN "weighs": a load costs 62.5 ms at 16 GB/s


def _cnn_zoo():
    """{model_id: numpy param tree}: A the base, B and D near-copies (0.005
    N(0,1)), C its own init (drawn with numpy for both packages)."""
    import jax

    from repro.utils.tree import flatten_paths, unflatten_paths

    rng = np.random.default_rng(3)
    shapes = {p: v.shape for p, v in flatten_paths(jax.eval_shape(
        lambda key: JVI.init_small_cnn(JVI.SmallCNNConfig(), key),
        jax.random.PRNGKey(0))).items()}
    base = {p: rng.standard_normal(s).astype(np.float32) for p, s in sorted(shapes.items())}
    zoo = {"A": base, "C": {p: rng.standard_normal(s).astype(np.float32)
                            for p, s in sorted(shapes.items())}}
    for m in ("B", "D"):
        zoo[m] = {p: (v + 0.005 * rng.standard_normal(v.shape)).astype(np.float32)
                  for p, v in sorted(base.items())}
    return {m: unflatten_paths(zoo[m]) for m in CNN_MIDS}


def _scaled_instances(inst_cls, bytes_fn):
    """instances_fn for the objective: each model's current bindings, with
    key bytes scaled so a model weighs MODEL_GB (swaps cost modelled time,
    as in benchmarks/serve_throughput.py)."""
    def fn(store, committed_groups):
        scale = MODEL_GB * 1e9 / store.model_bytes("A")
        out = []
        for m in CNN_MIDS:
            kb = {k: max(int(bytes_fn(store.buffers[k]) * scale), 1) for k in store.keys_for(m)}
            out.append(inst_cls(m, "tiny-yolo", frozenset(kb), kb))
        return out
    return fn


class _AlwaysSucceed:
    def __init__(self, result_cls):
        self.result_cls, self.calls = result_cls, 0

    def train(self, store, models):
        self.calls += 1
        return self.result_cls(True, {m.model_id: 1.0 for m in models}, set(), 1, 0.0, [])


def _counting_clock():
    c = itertools.count()
    return lambda: float(next(c))


def _planner_pair(objective_pair):
    """Both packages' StagedPlanner over the same small_cnn zoo (numpy
    params), an always-succeeding trainer and a counting clock."""
    import jax
    import jax.numpy as jnp

    from repro_torch import bridge

    zoo = _cnn_zoo()
    js = JaxStore.from_models({m: jax.tree_util.tree_map(jnp.asarray, p) for m, p in zoo.items()})
    ts = ParamStore.from_models({m: bridge.to_torch(p, device="cpu") for m, p in zoo.items()})
    jrecs = sum((jax_records_from_params(js.materialize(m), m) for m in CNN_MIDS), [])
    trecs = sum((records_from_params(ts.materialize(m), m) for m in CNN_MIDS), [])
    jreg = [JaxRegistered(m, lambda p, b: 0.0, lambda p, b: 1.0, lambda e: [], None, 0.9, 1.0)
            for m in CNN_MIDS]
    treg = [RegisteredModel(m, lambda p, b: 0.0, lambda p, b: 1.0, lambda e: [], None, 0.9, 1.0)
            for m in CNN_MIDS]
    jobj, tobj = objective_pair
    jres = JaxStagedPlanner(js, jreg, jrecs, _AlwaysSucceed(JaxMergeResult), objective=jobj,
                            clock=_counting_clock()).run()
    tres = StagedPlanner(ts, treg, trecs, _AlwaysSucceed(MergeResult), objective=tobj,
                         clock=_counting_clock()).run()
    assert tres.plan.to_json() == jres.plan.to_json()
    assert (tres.attempted, tres.committed, tres.discarded, tres.final_bytes) == \
        (jres.attempted, jres.committed, jres.discarded, jres.final_bytes)
    assert [e.objective for e in tres.events] == [e.objective for e in jres.events]
    return jres, tres, js, ts


def test_planner_objective_that_every_commit_hurts_rolls_everything_back():
    def hurts(st, committed_groups):
        return 1.0 if not committed_groups else 0.25

    _, tres, _, ts = _planner_pair((hurts, hurts))
    assert tres.committed == 0 and tres.discarded > 0
    assert not ts.shared_keys()  # rollbacks restored private bindings
    assert tres.plan.groups == ()
    assert tres.plan.provenance["objective_final"] == 1.0


def test_planner_constant_objective_is_carried_on_every_event():
    _, tres, _, _ = _planner_pair((lambda st, gs: 0.9, lambda st, gs: 0.9))
    assert tres.committed > 0
    assert all(e.objective == 0.9 for e in tres.events)
    assert [e["objective"] for e in tres.plan.provenance["events"]] == [0.9] * tres.committed


def test_planner_with_the_simulator_objective_equals_the_reference():
    """``effective_accuracy_objective`` over a four-member small_cnn zoo
    whose members each weigh 1 GB, at a capacity that holds one and a half
    members and an activation: unmerged, the round robin's swaps push
    frames past the SLA, and each commit cuts them, so the score rises;
    the planners agree on every score and every commit."""
    cost = {"tiny-yolo": JC.costs_for("tiny-yolo")}
    tcost = {"tiny-yolo": TC.costs_for("tiny-yolo")}
    cap = int(1.5 * MODEL_GB * 1e9) + int(cost["tiny-yolo"].activation_gb(1) * 1e9)
    kw = dict(capacity_bytes=cap, horizon_ms=4_000.0, sla_ms=100.0)
    from repro.utils.tree import leaf_bytes as jax_leaf_bytes

    jobj = JSIM.effective_accuracy_objective(_scaled_instances(JS.Instance, jax_leaf_bytes),
                                             cost, **kw)
    tobj = TSIM.effective_accuracy_objective(_scaled_instances(TS.Instance, leaf_bytes),
                                             tcost, **kw)
    jres, tres, js, ts = _planner_pair((jobj, tobj))
    final = tres.plan.provenance["objective_final"]
    assert final == jres.plan.provenance["objective_final"] == tobj(ts, []) == jobj(js, [])
    from repro_torch import bridge

    unmerged = ParamStore.from_models({m: bridge.to_torch(p, device="cpu")
                                       for m, p in _cnn_zoo().items()})
    objs = [e.objective for e in tres.events]
    assert tres.committed > 0 and tobj(unmerged, []) < objs[0] < final
    assert objs == sorted(objs)  # a commit that lowered the score was rolled back
