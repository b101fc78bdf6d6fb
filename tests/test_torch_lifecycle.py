"""The port's drift-adapt lifecycle (breach → revert → warm-start re-plan →
hot swap) against the JAX package.

The shared scenario is ``tests/test_lifecycle.py``'s fixture — four
small-CNN members, six sampling periods, the drift at period 2 — run once
per package from the same inputs: the zoo, the drifted original
(``PRNGKey(999)``), the calibration batch, every request payload and every
probe batch are the JAX package's draws, handed to the port as numpy.
Both packages' planners get a counting clock (the reference's through its
bench module's ``StagedPlanner`` name), so plan provenance is equal too.

Equal exactly: every ``LifecycleEvent``, the deployed plan's JSON, the
``ResumeState`` JSON, each row's resident bytes and agreements.  Served
rows: allclose at rtol = atol = 1e-5 (float32; XLA and torch sum in
different orders).
"""
import functools
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import ParamStore as JaxStore
from repro.core import RegisteredModel as JaxRegistered
from repro.core import StagedPlanner as JaxStagedPlanner
from repro.core import enumerate_groups as jax_enumerate_groups
from repro.core import records_from_params as jax_records_from_params
from repro.core.drift import DriftMonitor as JaxDriftMonitor
from repro.core.drift import DriftReport as JaxDriftReport
from repro.core.merging import MergeResult as JaxMergeResult
from repro.models import vision as JVI
from repro.models.registry import get_adapter as jax_get_adapter
from repro.runtime.monitors import SampleCadence as JaxSampleCadence
from repro.serving.executor import Request as JaxRequest
from repro.serving.lifecycle import RevertHysteresis as JaxRevertHysteresis
from repro_torch import bridge
from repro_torch.bench import drift_adapt as TDA
from repro_torch.core import (
    ParamStore, RegisteredModel, StagedPlanner, enumerate_groups, records_from_params,
)
from repro_torch.core.drift import DriftMonitor, DriftReport, ResumeState
from repro_torch.core.merging import MergeResult
from repro_torch.models.registry import get_adapter
from repro_torch.runtime.monitors import SampleCadence
from repro_torch.bench.lm_merging import verify_bitwise
from repro_torch.serving.costs import costs_for
from repro_torch.serving.executor import MergeAwareEngine, ModelProgram, Request
from repro_torch.serving.workload import instances_from_store
from repro_torch.utils.tree import flatten_paths, unflatten_paths
from repro_torch.serving.lifecycle import (
    BREACHED, REPLANNING, REVERTED, SWAPPED, LifecycleController, RevertHysteresis,
)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from benchmarks import drift_adapt as DA  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
MIDS4 = ("cam-A", "cam-B", "cam-C", "cam-D")
N_PERIODS, DRIFT_PERIOD = 6, 2


class Ticks:
    """A planner clock that advances one second a read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_scenario(mids=MIDS4):
    """The JAX bench's scenario inputs as a port ``DriftScenario``."""
    jadapter = jax_get_adapter("small_cnn")
    jcfg = jadapter.default_config()
    tadapter = get_adapter("small_cnn")
    zoo = DA.cnn_zoo(jadapter, jcfg, mids)
    drifted = jadapter.init(jcfg, jax.random.PRNGKey(999))
    cal = jadapter.calibration_batch(jcfg, jax.random.PRNGKey(7), 32)["images"]

    @functools.lru_cache(maxsize=None)
    def period_payloads(period):
        return [_np(r.payload) for r in DA.period_requests(mids, period, 0.0)]

    return TDA.DriftScenario(
        tadapter, tadapter.default_config(),
        {m: bridge.to_torch(zoo[m], device=CPU) for m in mids},
        drifted_original=bridge.to_torch(drifted, device=CPU),
        calibration={"images": _t(cal)},
        payload=lambda period, i, j: _t(period_payloads(period)[i * DA.REQS_PER_MODEL + j]),
        probe=lambda period: _t(DA.probe_batch(period)["images"]),
        planner_clock=Ticks)


def _snapshot(rows, info, plan0):
    ctl, eng = info["controller"], info["engine"]
    return dict(rows=rows, info=info, events=list(ctl.events),
                plan0=plan0.to_json(), deployed=ctl.deployed_plan.to_json(),
                resume=ctl.resume_state().to_json(), n_done=len(eng.completions),
                served={(c.request.instance_id, c.request.arrival_s, c.request.deadline_s):
                        _np(c.result) for c in eng.completions})


@pytest.fixture(scope="module")
def timelines():
    seeds = []  # the plans the JAX planners were seeded with: the deployed plan0

    def planner(*a, **kw):
        seeds.append(kw.get("seed_plan"))
        return JaxStagedPlanner(*a, clock=Ticks(), **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DA, "StagedPlanner", planner)
        jrows, jinfo = DA.run_timeline(with_loop=True, mids=MIDS4, n_periods=N_PERIODS,
                                       drift_period=DRIFT_PERIOD)
    rows, info = TDA.run_timeline(_port_scenario(), True, N_PERIODS, DRIFT_PERIOD)
    assert seeds[0] is None and seeds[1] is not None
    return _snapshot(jrows, jinfo, seeds[1]), _snapshot(rows, info, info["plan0"])


# ---------------------------------------------------------------------------
# the shared scenario, both packages
# ---------------------------------------------------------------------------


def test_lifecycle_events_are_equal(timelines):
    ref, port = timelines
    assert [e.state for e in port["events"]] == [BREACHED, REVERTED, REPLANNING, SWAPPED]
    assert len(port["events"]) == len(ref["events"])
    for je, te in zip(ref["events"], port["events"]):
        assert (te.time, te.state) == (je.time, je.state)
        assert te.detail == je.detail, te.state
    breach, revert = port["events"][0], port["events"][1]
    assert breach.detail["breached"] == [DA.DRIFTED]
    assert revert.detail["reverted"] == [DA.DRIFTED]
    assert revert.detail["epoch_bumps"] == 1 and revert.detail["pending_requests"] > 0
    assert port["events"][2].detail["excluded"] == [DA.DRIFTED]


def test_plans_and_resume_state_are_byte_equal(timelines):
    ref, port = timelines
    assert port["plan0"] == ref["plan0"]
    assert port["deployed"] == ref["deployed"]
    assert port["resume"] == ref["resume"]
    rp = port["info"]["replans"][0]
    assert rp.plan.provenance["warm_start"] is True
    assert rp.plan.provenance["excluded"] == [DA.DRIFTED]
    assert port["info"]["controller"].last_recover_s == 2 * DA.PERIOD_S


def test_rows_resident_bytes_and_agreements_are_equal(timelines):
    ref, port = timelines
    assert len(port["rows"]) == len(ref["rows"]) == N_PERIODS
    for jr, tr in zip(ref["rows"], port["rows"]):
        assert {k: tr[k] for k in jr} == jr
    assert port["info"]["completed"] == port["info"]["submitted"] == ref["info"]["submitted"]
    assert port["info"]["engine"].skipped == 0


def test_served_rows_agree(timelines):
    ref, port = timelines
    assert set(port["served"]) == set(ref["served"])
    for key, want in ref["served"].items():
        np.testing.assert_allclose(port["served"][key], want, **TOL)


def test_resume_state_roundtrip_preserves_exclusions(timelines):
    _, port = timelines
    ctl = port["info"]["controller"]
    state = ctl.resume_state()
    back = ResumeState.from_json(state.to_json())
    assert back == state and DA.DRIFTED in back.excluded
    clone = LifecycleController(
        port["info"]["engine"], ctl.monitor, ctl.sample_fn, ctl.replan_fn,
        sample_period_s=DA.PERIOD_S, clock=ctl.clock,
        hysteresis=RevertHysteresis(cooldown_s=ctl.hysteresis.cooldown_s, clock=ctl.clock))
    clone.restore(back)
    assert clone.deployed_plan == ctl.deployed_plan
    assert DA.DRIFTED in clone.hysteresis.excluded()


def test_reverted_model_serves_its_new_original(timelines):
    """The reverted member's served row against the direct forward at 1e-5,
    and against the JAX engine's actual row at 1e-5.  The JAX package's own
    test asks its served row to equal its direct forward bitwise and fails
    by about one ulp: its split serve path and its direct forward differ by
    ~1.2e-7 in float32 (served [0.20166802, 0.79322755, 1.0108875,
    0.24844612] against direct [0.20166792, 0.79322743, 1.0108873,
    0.2484461]).  So the port is held to what the reference computes."""
    ref, port = timelines
    jeng, teng = ref["info"]["engine"], port["info"]["engine"]
    groups = teng.prefix_groups()
    assert [sorted(g) for g in groups if len(g) > 1] == [sorted(set(MIDS4) - {DA.DRIFTED})]
    assert sorted(map(tuple, groups)) == sorted(map(tuple, jeng.prefix_groups()))
    img = jax.random.normal(jax.random.PRNGKey(123), (1, 32, 32, 3))
    jeng.submit(JaxRequest(DA.DRIFTED, img, 0.0, 1e6))
    jeng.serve(horizon_s=30.0)
    teng.submit(Request(DA.DRIFTED, _t(img), 0.0, 1e6))
    teng.serve(horizon_s=30.0)
    out = teng.completions[-1].result
    tadapter = get_adapter("small_cnn")
    direct = tadapter.forward(tadapter.default_config(), port["info"]["originals"][DA.DRIFTED],
                              _t(img))[0]
    np.testing.assert_allclose(out.numpy(), direct.numpy(), **TOL)
    np.testing.assert_allclose(out.numpy(), _np(jeng.completions[-1].result), **TOL)
    assert port["rows"][-1]["breached_query_agreement"] == 1.0


# ---------------------------------------------------------------------------
# revert correctness, both packages on one merged trio
# ---------------------------------------------------------------------------


def _merged_trios():
    jadapter = jax_get_adapter("small_cnn")
    jcfg = jadapter.default_config()
    zoo = DA.cnn_zoo(jadapter, jcfg, mids=("A", "B", "C"))
    tzoo = {m: bridge.to_torch(p, device=CPU) for m, p in zoo.items()}
    tadapter = get_adapter("small_cnn")
    tcfg = tadapter.default_config()
    out = []
    for adapter, cfg, params, Store, groups_fn, Reg, Mon in (
            (jadapter, jcfg, zoo, JaxStore, jax_enumerate_groups, JaxRegistered,
             JaxDriftMonitor),
            (tadapter, tcfg, tzoo, ParamStore, enumerate_groups, RegisteredModel,
             DriftMonitor)):
        store = Store.from_models(dict(params))
        recs = sum((adapter.records(cfg, p, m) for m, p in params.items()), [])
        for g in groups_fn(recs):
            if not any(r.path.startswith("head/") for r in g.records):
                store.merge_group(g)
        regs = [Reg(m, lambda p, b: 0.0, lambda p, b: 1.0, lambda e: [], None, 0.9, 1.0)
                for m in params]
        out.append((adapter, cfg, params, store, Mon(store, dict(params), regs), recs))
    return out


def test_revert_keeps_survivors_shared_buffers_and_gcs_only_orphans():
    (_, _, _, js, jmon, _), (_, _, zoo, ts, tmon, _) = _merged_trios()
    shared_before = {k: ts.buffers[k] for k in ts.shared_keys()}
    assert shared_before and ts.shared_keys() == js.shared_keys()
    epoch0 = ts.epoch
    report = tmon.revert(DriftReport({}, {"B"}, set()))
    jmon.revert(JaxDriftReport({}, {"B"}, set()))
    assert report.reverted == {"B"}
    assert ts.epoch == epoch0 + 1 == js.epoch
    assert ts.bindings == js.bindings and set(ts.buffers) == set(js.buffers)
    for k, buf in shared_before.items():
        assert ts.buffers[k] is buf
        assert all(k in set(ts.bindings[m].values()) for m in ("A", "C"))
        assert k not in set(ts.bindings["B"].values())
    assert all(key == f"B:{path}" for path, key in ts.bindings["B"].items())
    assert torch.equal(ts.materialize("B")["stem"]["w"], zoo["B"]["stem"]["w"])
    assert set(ts.buffers) == {k for b in ts.bindings.values() for k in b.values()}


def test_revert_of_all_members_gcs_shared_buffers():
    (_, _, _, js, jmon, _), (_, _, _, ts, tmon, _) = _merged_trios()
    tmon.revert(DriftReport({}, {"A", "B", "C"}, set()))
    jmon.revert(JaxDriftReport({}, {"A", "B", "C"}, set()))
    assert not ts.shared_keys() and ts.bindings == js.bindings
    assert set(ts.buffers) == {k for b in ts.bindings.values() for k in b.values()}
    assert set(ts.buffers) == set(js.buffers)


def test_drift_check_stays_epoch_neutral_after_revert():
    trio = _merged_trios()[1]
    adapter, cfg, zoo, store, monitor, _ = trio
    monitor.revert(DriftReport({}, {"B"}, set()))
    for m in zoo:
        store.materialize_cached(m)
    epoch0, mats0 = store.epoch, dict(store.materializations)
    batch = {"images": _t(jax.random.normal(jax.random.PRNGKey(0), (4, 32, 32, 3)))}
    report = monitor.check({m: batch for m in zoo})
    assert set(report.checked) == set(zoo)
    assert store.epoch == epoch0 and store.materializations == mats0


def test_revert_delta_mirrors_binding_deltas_and_the_reference():
    (_, _, _, js, jmon, _), (_, _, _, ts, tmon, _) = _merged_trios()
    before = dict(ts.bindings["B"])
    delta = tmon.revert_delta(DriftReport({}, {"B"}, set()))
    assert delta == jmon.revert_delta(JaxDriftReport({}, {"B"}, set()))
    assert dict(ts.bindings["B"]) == before  # pure query
    assert {p for (_, p) in delta} == set(before)
    for (m, p), (old, new) in delta.items():
        assert old == before[p] and new == f"B:{p}"
    tmon.revert(DriftReport({}, {"B"}, set()))
    assert all(ts.bindings[m][p] == new for (m, p), (_, new) in delta.items())


def test_revert_invalidates_suffix_bank_in_the_same_epoch_bump():
    adapter, cfg, _, store, monitor, _ = _merged_trios()[1]
    sp = adapter.split(cfg)
    bid = ParamStore.bank_id(("A", "C"))
    store.materialize_bank(("A", "C"), sp.suffix_paths)
    store.materialize_bank(("A", "C"), sp.suffix_paths)  # cache hit
    assert store.materializations[bid] == 1
    monitor.revert(DriftReport({}, {"B"}, set()))
    store.materialize_bank(("A", "C"), sp.suffix_paths)
    assert store.materializations[bid] == 2  # exactly one rebuild post-revert


def _served_trio(wrong_slots=False):
    """The port's merged trio behind an engine, 12 requests with
    interleaved deadlines served (so micro-batches mix members and take
    the suffix bank).  ``wrong_slots`` makes the store's bank hand the
    members' heads out in reverse order — a faulty bank."""
    adapter, cfg, _, store, _, _ = _merged_trios()[1]
    if wrong_slots:
        bank = store.materialize_bank

        def reversed_bank(model_ids, paths=None):
            return unflatten_paths({p: w.flip(0) for p, w in
                                    flatten_paths(bank(model_ids, paths)).items()})

        store.materialize_bank = reversed_bank
    mids = ("A", "B", "C")
    eng = MergeAwareEngine(
        store, instances_from_store(store, "tiny-yolo", model_ids=list(mids)),
        [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in mids],
        capacity_bytes=10 ** 9, costs={"tiny-yolo": costs_for("tiny-yolo")},
        buckets=TDA.BUCKETS)
    gen = torch.Generator().manual_seed(5)
    for j in range(4):
        for i, m in enumerate(mids):
            eng.submit(Request(m, torch.randn((1, 32, 32, 3), generator=gen), 0.0,
                               1e6 + (j * 3 + i) * 1e-3))
    stats = eng.serve(horizon_s=30.0)
    assert stats["completed"] == 12 and stats["suffix_dispatches"] >= 1
    return adapter, cfg, store, eng


@pytest.mark.parametrize("wrong_slots", [False, True], ids=["bank", "faulty-bank"])
def test_verify_bitwise_holds_the_bank_against_each_members_suffix(wrong_slots):
    """The replay repeats the engine's dispatch, so it is bitwise even
    through a faulty bank; the second check, each banked row against the
    member's own suffix over the batch (the JAX package's check), is exact
    on the CPU and catches the faulty bank."""
    _, _, store, eng = _served_trio(wrong_slots)
    gaps = []
    bitwise, bank_gap, bank_rel = verify_bitwise(eng, store, buckets=TDA.BUCKETS, gaps=gaps)
    assert bitwise and gaps == []
    if wrong_slots:
        assert bank_gap > 1e-3 and bank_rel > 0.0
    else:
        assert bank_gap == bank_rel == 0.0


# ---------------------------------------------------------------------------
# warm-start planning from a deployed plan
# ---------------------------------------------------------------------------


class _CountingTrainer:
    def __init__(self, result_cls):
        self.calls, self.result_cls = 0, result_cls

    def train(self, store, models):
        self.calls += 1
        return self.result_cls(True, {m.model_id: 1.0 for m in models}, set(), 1, 0.0, [])


def _warm_planners(seeded: bool):
    """Both packages' planners over a fresh store of the trio, seeded (or
    not) with the trio's trunk plan, B excluded."""
    out = []
    for (adapter, cfg, zoo, store, _, recs), (Store, Planner, Reg, Res) in zip(
            _merged_trios(),
            ((JaxStore, JaxStagedPlanner, JaxRegistered, JaxMergeResult),
             (ParamStore, StagedPlanner, RegisteredModel, MergeResult))):
        trunk = [r for r in recs if not r.path.startswith("head/")]
        groups = [g for g in (jax_enumerate_groups if Store is JaxStore
                              else enumerate_groups)(trunk)]
        deployed = store.export_plan(groups) if seeded else None
        regs = [Reg(m, lambda p, b: 0.0, lambda p, b: 1.0, lambda e: [], None, 0.9, 1.0)
                for m in zoo]
        trainer = _CountingTrainer(Res)
        out.append((Planner(Store.from_models(dict(zoo)), regs, recs, trainer,
                            exclude_models={"B"}, seed_plan=deployed, clock=Ticks()),
                    trainer, deployed))
    return out


def test_seed_plan_candidates_lead_and_exclude_the_breached_member():
    (jp, _, jdeployed), (tp, _, deployed) = _warm_planners(seeded=True)
    queue = tp.candidates()
    assert [g.signature for g in queue] == [g.signature for g in jp.candidates()]
    seed_sigs = [pg.signature for pg in deployed.groups]
    assert [g.signature for g in queue[:len(seed_sigs)]] == seed_sigs
    assert all("B" not in g.models for g in queue)
    assert len([g for g in queue if g.signature in set(seed_sigs)]) == len(seed_sigs)
    res, jres = tp.run(), jp.run()
    assert res.committed >= 1 and res.plan.models() == {"A", "C"}
    assert res.plan.provenance["warm_start"] is True
    assert res.plan.provenance["excluded"] == ["B"]
    assert res.plan.to_json() == jres.plan.to_json()


def test_warm_start_attempts_no_more_than_cold():
    (_, _, _), (warm_p, warm_t, _) = _warm_planners(seeded=True)
    (jcold_p, jcold_t, _), (cold_p, cold_t, _) = _warm_planners(seeded=False)
    warm, cold, jcold = warm_p.run(), cold_p.run(), jcold_p.run()
    assert warm_t.calls <= cold_t.calls == jcold_t.calls
    assert warm.fraction_saved >= cold.fraction_saved
    assert cold.plan.to_json() == jcold.plan.to_json()


# ---------------------------------------------------------------------------
# the planner on tests/test_policy.py's zoo, committing and rolling back
# ---------------------------------------------------------------------------


JCFG = JVI.SmallCNNConfig(task="classification", n_classes=4, depth=1, width=8, n_stages=2)


def _policy_zoo():
    """tests/test_policy.py's zoo: A, B near-identical, C an independent
    init; numpy trees for both packages."""
    base = JVI.init_small_cnn(JCFG, jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(base)
    ks = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    b = jax.tree_util.tree_unflatten(
        treedef, [leaf + 0.01 * jax.random.normal(k, leaf.shape) for leaf, k in zip(leaves, ks)])
    return {"A": base, "B": b, "C": JVI.init_small_cnn(JCFG, jax.random.PRNGKey(42))}


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _SlowTrainer:
    """Burns ``cost`` seconds of injected-clock time per attempt and
    succeeds or fails every attempt."""

    def __init__(self, clk, result_cls, cost=100.0, succeed=True):
        self.clk, self.result_cls, self.cost, self.succeed = clk, result_cls, cost, succeed
        self.calls = 0

    def train(self, store, models):
        self.calls += 1
        self.clk.t += self.cost
        return self.result_cls(self.succeed, {m.model_id: 1.0 for m in models}, set(), 1,
                               0.0, [])


@pytest.mark.parametrize("succeed", [True, False], ids=["commit", "rollback"])
def test_planner_matches_on_the_policy_zoo(succeed):
    """Every attempt committing, or every attempt failing (rollback, then
    the AIMD halving until the group no longer out-ranks the next): the
    same attempts, commits, discards and event times, and byte-equal plan
    JSON, in both packages."""
    zoo = _policy_zoo()
    out = []
    for Store, Planner, Reg, Res, records, tree in (
            (JaxStore, JaxStagedPlanner, JaxRegistered, JaxMergeResult,
             jax_records_from_params, lambda p: p),
            (ParamStore, StagedPlanner, RegisteredModel, MergeResult, records_from_params,
             lambda p: bridge.to_torch(p, device=CPU))):
        params = {m: tree(p) for m, p in zoo.items()}
        clk = ManualClock()
        trainer = _SlowTrainer(clk, Res, succeed=succeed)
        res = Planner(Store.from_models(params),
                      [Reg(m, lambda p, b: 0.0, lambda p, b: 1.0, lambda e: [], None, 0.9, 1.0)
                       for m in params],
                      sum((records(p, m) for m, p in params.items()), []), trainer,
                      clock=clk).run()
        out.append((res, trainer.calls))
    (jres, jcalls), (res, calls) = out
    assert (res.committed, res.discarded, res.attempted, calls) == \
        (jres.committed, jres.discarded, jres.attempted, jcalls)
    assert [e.time for e in res.events] == [e.time for e in jres.events]
    assert res.plan.to_json() == jres.plan.to_json()
    assert res.plan.provenance["replan_timed_out"] is False
    assert (res.committed > 0) == succeed and bool(res.store.shared_keys()) == succeed
    assert res.discarded >= 1 or succeed


# ---------------------------------------------------------------------------
# hysteresis and cadence, both packages on one script
# ---------------------------------------------------------------------------


def test_hysteresis_cooldown_and_storm_escalation():
    seen = []
    for cls in (JaxRevertHysteresis, RevertHysteresis):
        clk = ManualClock()
        h = cls(cooldown_s=10.0, clock=clk)
        log = [h.record("B"), h.excluded()]
        clk.t = 11.0
        log += [h.excluded(), h.record("B")]
        for t in (30.0, 52.0):
            clk.t = t
            log.append(h.excluded())
        h2 = cls(cooldown_s=10.0, clock=clk)
        h2.restore({"B": [0.0, 11.0]})
        seen.append(log + [h2._until, h.history])
    assert seen[1] == seen[0]
    assert seen[1][:6] == [10.0, {"B"}, set(), 40.0, {"B"}, set()]
    assert seen[1][6]["B"] == pytest.approx(51.0)


def test_sample_cadence_is_clock_injected_and_phase_stable():
    seen = []
    for cls in (JaxSampleCadence, SampleCadence):
        clk = ManualClock()
        c = cls(10.0, clock=clk)
        log = [c.due()]
        for t, mark in ((10.0, True), (10.0, False), (20.5, True), (30.0, True), (75.0, True),
                        (75.0, False), (84.9, False), (85.0, False)):
            clk.t = t
            log.append(c.due())
            if mark:
                c.mark()
        seen.append(log)
    assert seen[1] == seen[0] == [False, True, False, True, True, True, False, False, True]
