"""The port's overload-hardened ingestion front end, fault injection and
monitors against the JAX package.

Pure-policy pieces (sources, queues, gate, pump, monitors) run one script
in both packages against a trivial fake engine, whose outcomes must be
equal.  The overload bench runs in both packages from the same inputs —
the JAX package's zoo, calibration batch, camera frame banks and gate
fitting frames, handed to the port as numpy — and every lane's per-step
accounting rows and report must be EQUAL (counts, depths, gate decisions,
fault event logs, the swap-failure rollback), with ``lost == 0`` in each.
The fitted gate's probe ``w`` and threshold ``tau`` are allclose at
rtol = atol = 1e-5 (float32 features; XLA and torch sum in different
orders), its decisions equal away from the threshold.
"""
import inspect
import json
import pathlib
import sys
from collections import deque

import jax
import numpy as np
import pytest
import torch

from repro.core import MergePlan as JaxMergePlan
from repro.core import ParamStore as JaxStore
from repro.core.drift import ResumeState as JaxResumeState
from repro.core.policy import CascadeProfile as JaxCascadeProfile
from repro.models.registry import get_adapter as jax_get_adapter
from repro.runtime.monitors import QueueDepthMonitor as JaxQueueDepthMonitor
from repro.runtime.monitors import ShedRateMonitor as JaxShedRateMonitor
from repro.serving import faults as JF
from repro.serving import ingestion as JI
from repro.serving.executor import Completion as JaxCompletion
from repro_torch import bridge
from repro_torch.bench import overload as TOV
from repro_torch.core import MergePlan, ParamStore, RegisteredModel, enumerate_groups
from repro_torch.core.drift import DriftMonitor, DriftReport, ResumeState
from repro_torch.core.policy import CascadeProfile
from repro_torch.models.registry import get_adapter
from repro_torch.runtime.monitors import QueueDepthMonitor, ShedRateMonitor
from repro_torch.serving import faults as TF
from repro_torch.serving import ingestion as TI
from repro_torch.serving.costs import costs_for
from repro_torch.serving.executor import (
    Completion, EdgeExecutor, MergeAwareEngine, ModelProgram, PlanApplyError, Request,
)
from repro_torch.serving.lifecycle import REPLANNING, REVERTED, SERVING, LifecycleController
from repro_torch.serving.workload import instances_from_store
from repro_torch.utils.tree import flatten_paths, unflatten_paths

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from benchmarks import drift_adapt as DA  # noqa: E402
from benchmarks import overload as OV  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
PKGS = {"jax": (JI, JF, JaxCompletion, JaxQueueDepthMonitor, JaxShedRateMonitor, np),
        "torch": (TI, TF, Completion, QueueDepthMonitor, ShedRateMonitor, torch)}


# ---------------------------------------------------------------------------
# pure policy, one script through both packages
# ---------------------------------------------------------------------------


class FakeEngine:
    """Completes every dispatched request instantly."""

    def __init__(self, mids, completion_cls):
        self.queues = {m: deque() for m in mids}
        self.completions = []
        self.skipped = 0
        self.serves = 0
        self.completion_cls = completion_cls

    def submit(self, req):
        self.queues[req.instance_id].append(req)

    def serve(self, horizon_s=30.0, warmup=None, drain=True):
        done = 0
        for q in self.queues.values():
            while q:
                self.completions.append(self.completion_cls(q.popleft(), None, 0.0))
                done += 1
        self.serves += 1
        return {"completed": done, "skipped": 0, "dropped_expired": 0}


def _frontend(pkg, policy="drop-oldest", fps=6.0, budget=4, cap=3, mids=("c0", "c1"),
              frame_fn=None, **kw):
    I, _, completion, _, _, lib = PKGS[pkg]
    eng = FakeEngine(mids, completion)
    fn = frame_fn or (lambda k: lib.zeros((1, 2)))
    sources = [I.CameraSource(m, fps=fps, frame_fn=fn, sla_s=100.0) for m in mids]
    return I.IngestionFrontEnd(eng, sources, policy=policy, queue_capacity=cap,
                               service_budget=budget, **kw), eng


def _both(script):
    """``script(pkg)`` in both packages; its results must be equal."""
    ref, port = script("jax"), script("torch")
    assert port == ref
    return port


def _identity(rep):
    accounted = (rep["completed"] + rep["gate_completed"] + rep["shed_oldest"]
                 + rep["shed_newest"] + rep["shed_expired"] + rep["dropped_expired"]
                 + rep["pending_admission"] + rep["pending_engine"])
    assert rep["offered"] == accounted and rep["lost"] == 0


def test_camera_source_cadence_and_reconnect():
    def script(pkg):
        I = PKGS[pkg][0]
        src = I.CameraSource("cam", fps=2.0, frame_fn=lambda k: k, sla_s=10.0)
        first, second = src.poll(1.0), src.poll(2.0)
        flap = I.CameraSource("cam", fps=1.0, frame_fn=lambda k: k)
        log = [len(flap.poll(2.0))]
        flap.disconnect()
        log += [flap.poll(4.0), flap.disconnects]
        flap.reconnect(5.0)
        log += [[r.arrival_s for r in flap.poll(6.0)], flap.emitted]
        return ([(r.arrival_s, r.deadline_s, r.meta, r.payload) for r in first + second],
                src.emitted, log)

    out = _both(script)
    assert out[0][:3] == [(0.0, 10.0, ("cam", 0), 0), (0.5, 10.5, ("cam", 1), 1),
                          (1.0, 11.0, ("cam", 2), 2)]
    assert out[2] == [3, [], 1, [5.0, 6.0], 5]


@pytest.mark.parametrize("policy", ["drop-oldest", "drop-newest"])
def test_admission_queue_policies(policy):
    def script(pkg):
        I = PKGS[pkg][0]
        q = I.AdmissionQueue("c", capacity=2, policy=policy)
        disp = [q.offer(Request("c", None, t, t + 10.0)) for t in (0.0, 1.0, 2.0)]
        q.offer(Request("c", None, 0.0, 1.0))
        return (disp, [r.arrival_s for r in q.q], q.shed_oldest, q.shed_newest, q.offered,
                q.admitted, q.max_depth, q.expire(2.0), q.shed_total)

    out = _both(script)
    assert out[0] == (["admitted"] * 3 if policy == "drop-oldest"
                      else ["admitted", "admitted", "shed"])
    with pytest.raises(ValueError):
        TI.AdmissionQueue("c", capacity=2, policy="drop-random")


def test_admission_queue_expire_counts_stale_heads():
    q = TI.AdmissionQueue("c", capacity=4)
    q.offer(Request("c", None, 0.0, 1.0))
    q.offer(Request("c", None, 0.0, 9.0))
    assert q.expire(2.0) == 1 and q.shed_expired == 1 and q.depth == 1
    assert q.q[0].deadline_s == 9.0


def _lane(pkg, steps, monitors=False, **kw):
    _, _, _, Depth, Shed, _ = PKGS[pkg]
    mons = (Depth(bound=3), Shed(window=6)) if monitors else ()
    fe, eng = _frontend(pkg, monitors=mons, **kw)
    rows = [fe.step(1.0) for _ in range(steps)]
    rep = fe.report()
    _identity(rep)
    extra = ((mons[0].bounded, mons[0].max_depth, sorted(mons[1].overloaded),
              mons[1].events) if monitors else ())
    return rows, rep, eng.serves, extra


@pytest.mark.parametrize("policy", ["drop-oldest", "drop-newest"])
def test_overload_accounting_identity(policy):
    rows, rep, _, mons = _both(lambda pkg: _lane(pkg, 6, monitors=True, policy=policy))
    assert rep["offered"] > 70 and rep["max_depth"] <= 3
    assert (rep["shed_oldest"] > 0) == (policy == "drop-oldest")
    assert (rep["shed_newest"] > 0) == (policy == "drop-newest")
    assert mons[0] and mons[1] <= 3 and mons[2] == ["c0", "c1"]


def test_degrade_sheds_to_the_gate_above_high_water():
    def script(pkg):
        lib = PKGS[pkg][5]
        gate = PKGS[pkg][0].CascadeGate(lambda b: -lib.ones(b.shape[0]))
        # capacity 1: the high-water mark (half the capacity) is 0
        rows, rep, _, _ = _lane(pkg, 4, policy="degrade", gate=gate, cap=1)
        return rows, rep

    _, rep = _both(script)
    assert rep["gate_completed"] == rep["offered"] > 0 and rep["completed"] == 0
    assert rep["hit_rate"] == 0.0


def test_degrade_below_high_water_never_gates():
    def script(pkg):
        lib = PKGS[pkg][5]
        gate = PKGS[pkg][0].CascadeGate(lambda b: -lib.ones(b.shape[0]))
        return _lane(pkg, 4, policy="degrade", gate=gate, fps=1.0, budget=4, cap=8)[1]

    rep = _both(script)
    assert rep["gate_completed"] == 0
    assert rep["completed"] == rep["offered"] - rep["pending_engine"]
    with pytest.raises(ValueError):
        _frontend("torch", policy="degrade")
    with pytest.raises(ValueError):
        _frontend("torch", cascade_always=True)


def test_cascade_always_hit_rate_feeds_a_byte_equal_profile():
    def script(pkg):
        lib = PKGS[pkg][5]
        I = PKGS[pkg][0]
        gate = I.CascadeGate(lambda b: b[:, 0])
        frame_fn = lambda k: lib.full((1, 2), 1.0 if k % 2 == 0 else -1.0)  # noqa: E731
        fe, _ = _frontend(pkg, fps=2.0, budget=8, cap=8, frame_fn=frame_fn, gate=gate,
                          cascade_always=True)
        for _ in range(4):
            fe.step(1.0)
        rep = fe.report()
        _identity(rep)
        # the profile as the overload bench builds it from the observed rates
        Profile = JaxCascadeProfile if pkg == "jax" else CascadeProfile
        rates = {c: gate.observed_hit_rate(c) for c in ("c0", "c1")}
        return (rep, Profile(rates, {c: 0.8 for c in rates}).to_json(),
                Profile(rates, {"c0": 0.7, "c1": 0.9}))

    rep, payload, prof = script("torch")
    jrep, jpayload, jprof = script("jax")
    assert rep == jrep and payload == jpayload
    assert prof.to_json() == jprof.to_json()
    assert 0.0 < rep["hit_rate"] < 1.0
    back = CascadeProfile.from_json(payload)
    assert back.to_json() == JaxCascadeProfile.from_json(payload).to_json()
    assert back.simulator_arg() == JaxCascadeProfile.from_json(payload).simulator_arg()
    assert back.gate_accuracy == {"c0": 0.8, "c1": 0.8}


@pytest.mark.parametrize("kind", ["stall", "slow_kernel", "camera_disconnect"])
def test_fault_lanes_log_equal_events(kind):
    def script(pkg):
        F = PKGS[pkg][1]
        if kind == "camera_disconnect":
            inj = F.FaultInjector([F.Fault(kind, camera="c1", at_step=1, duration_steps=2)])
            rows, rep, serves, _ = _lane(pkg, 6, fps=1.0, budget=8, cap=8, fault_injector=inj)
        else:
            inj = F.FaultInjector([F.Fault(kind, at_step=1, duration_steps=2, factor=2.0)])
            rows, rep, serves, _ = _lane(pkg, 8, fps=4.0, budget=4, cap=10, mids=("c0",),
                                         fault_injector=inj)
        return rows, rep, serves, inj.events

    rows, rep, _, events = _both(script)
    if kind == "stall":
        assert rows[1]["stalled"] and rows[2]["dispatched"] == 0 < rows[3]["dispatched"]
        assert events[0] == {"step": 1, "fault": "stall", "edge": "start", "duration": 2}
    elif kind == "slow_kernel":
        assert rows[1]["service_factor"] == rows[2]["service_factor"] == 2.0
    else:
        assert [e["edge"] for e in events] == ["down", "up"]
        assert [e["step"] for e in events] == [1, 3]
    with pytest.raises(ValueError):
        TF.Fault("flood")
    with pytest.raises(ValueError):
        TF.Fault(TF.CAMERA_DISCONNECT)


def test_monitors_match_the_reference():
    def script(pkg):
        _, _, _, Depth, Shed, _ = PKGS[pkg]
        depth = Depth(bound=4, clock=lambda: 0.0)
        for d, t in ((3, None), (5, 1.0), (2, 2.0)):
            depth.observe("cam", depth=d, now=t)
        shed = Shed(window=4, clock=lambda: 0.0)
        log = []
        for off, sh in ((10, 0), (20, 8), (30, 8), (40, 8)):
            shed.observe("cam", offered=off, shed=sh)
            log.append(sorted(shed.overloaded))
        return (depth.bounded, depth.max_depth, depth.breaches, depth.high_water, log,
                shed.events, shed.shed_rate("cam"))

    out = _both(script)
    assert out[2] == [(1.0, "cam", 5)] and out[4] == [[], ["cam"], ["cam"], []]
    assert out[6] == pytest.approx(0.2)


def test_gate_fit_prefix_probe_closed_form_matches():
    frames = np.concatenate([-np.ones((8, 4)), np.ones((8, 4))]).astype(np.float32)
    labels = np.array([False] * 8 + [True] * 8)
    gate = TI.CascadeGate.fit_prefix_probe(lambda p, x: x, None, torch.from_numpy(frames),
                                           labels)
    reqs = [Request("cam", torch.full((1, 4), v), 0.0, 10.0) for v in (1.0, -1.0, 1.0)]
    assert gate.decide(reqs) == [True, False, True]
    assert gate.observed_hit_rate() == pytest.approx(2 / 3)
    assert gate.per_camera["cam"] == [2, 3]
    with pytest.raises(ValueError):
        TI.CascadeGate.fit_prefix_probe(lambda p, x: x, None, torch.ones((8, 4)),
                                        np.ones(8, dtype=bool))


# ---------------------------------------------------------------------------
# the overload bench in both packages, from the JAX package's inputs
# ---------------------------------------------------------------------------


class _RecordingFrontEnd(JI.IngestionFrontEnd):
    made: list = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _RecordingFrontEnd.made.append(self)


def _jax_lanes(stack) -> tuple:
    """``benchmarks/overload.py``'s lanes in its ``run()`` order (without
    writing its artifact): rows, the cascade objective view."""
    rows = []
    for overload in (2.0, 4.0):
        for policy in ("drop-oldest", "drop-newest", "degrade"):
            rows.append({"lane": f"policy:{policy}@{overload:g}x",
                         **OV.run_lane(stack, policy, overload, gated=(policy == "degrade"))})
    casc = OV.run_lane(stack, "drop-oldest", 1.0, cascade_always=True)
    rows.append({"lane": "cascade:profile@1x", **casc})
    profile = JaxCascadeProfile(rates=casc["observed_rates"],
                                gate_accuracy={m: stack["gate_acc"] for m in OV.MIDS})
    objective = OV.cascade_objective_view(stack, profile)
    rows.extend(OV.fault_lanes(stack))
    return rows, objective


@pytest.fixture(scope="module")
def overload_runs():
    jadapter = jax_get_adapter("small_cnn")
    jcfg = jadapter.default_config()
    _RecordingFrontEnd.made = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(OV, "IngestionFrontEnd", _RecordingFrontEnd)
        jstack = OV.build_stack()
        jrows, jobjective = _jax_lanes(jstack)
    jlogs = [fe.step_log for fe in _RecordingFrontEnd.made]
    inputs = TOV.OverloadInputs(
        banks={m: np.asarray(OV.frame_bank(m)) for m in OV.MIDS},
        fit=OV.calib_frames(32, key=777), hold=OV.calib_frames(32, key=911),
        calibration=np.asarray(jadapter.calibration_batch(jcfg, jax.random.PRNGKey(7),
                                                          32)["images"]))
    zoo = DA.cnn_zoo(jadapter, jcfg, OV.MIDS)
    stack = TOV.build_stack(inputs, device=CPU,
                            zoo={m: bridge.to_torch(zoo[m], device=CPU) for m in OV.MIDS})
    rows, derived = TOV.evaluate(stack)
    return dict(jstack=jstack, jrows=jrows, jlogs=jlogs, jobjective=jobjective, stack=stack,
                rows=rows, derived=derived)


def test_every_lane_is_equal_step_by_step(overload_runs):
    r = overload_runs
    assert [x["lane"] for x in r["rows"]] == [x["lane"] for x in r["jrows"]]
    assert len(r["jlogs"]) == len(r["rows"])
    for jrow, row, jlog in zip(r["jrows"], r["rows"], r["jlogs"]):
        assert row["step_log"] == jlog, row["lane"]
        assert {k: v for k, v in row.items() if k != "step_log"} == jrow, row["lane"]
        assert row["lost"] == 0 and row["max_depth"] <= TOV.CAP


def test_policy_sweep_degrade_beats_drop_newest(overload_runs):
    d = overload_runs["derived"]
    for overload in ("2x", "4x"):
        assert d[f"degrade_beats_drop_newest_{overload}"]
    assert all(TOV.gates(d).values()), TOV.gates(d)


def test_cascade_objective_is_equal(overload_runs):
    r = overload_runs
    view = {k: r["derived"][k] for k in r["jobjective"]}
    assert view == r["jobjective"]
    assert r["derived"]["cascade_objective_gain"] >= 0.0


def test_gate_probe_w_and_tau_agree(overload_runs):
    r = overload_runs
    jscore = inspect.getclosurevars(r["jstack"]["score_fn"].__wrapped__).nonlocals
    score = inspect.getclosurevars(r["stack"]["gate"].score_fn).nonlocals
    np.testing.assert_allclose(score["w_t"].numpy(), np.asarray(jscore["w_j"]), **TOL)
    np.testing.assert_allclose(score["tau"], jscore["tau"], **TOL)
    assert r["stack"]["gate_acc"] == r["jstack"]["gate_acc"]
    frames = np.concatenate([np.asarray(OV.frame_bank(m)) for m in OV.MIDS])
    want = np.asarray(r["jstack"]["score_fn"](frames))
    got = r["stack"]["gate"].score_fn(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    far = np.abs(want) > 1e-3
    assert far.mean() > 0.99
    assert np.array_equal(got[far] > 0, want[far] > 0)


def test_swap_failure_rolls_back_then_reapplies_alike(overload_runs):
    r = overload_runs
    swap = next(x for x in r["rows"] if x["lane"] == "fault:swap_failure")
    assert swap["swap_failure_raised"] and swap["swap_failure_epoch_bumps"] == 1
    assert swap["swap_failure_bindings_restored"] and swap["swap_failure_pending_kept"]
    assert swap["reapply_epoch_bumps"] == 1
    assert r["stack"]["edge"].bindings == r["jstack"]["edge"].bindings
    assert r["stack"]["edge"].epoch == r["jstack"]["edge"].epoch


# ---------------------------------------------------------------------------
# engine hardening on a real (port) engine
# ---------------------------------------------------------------------------


def _pair():
    adapter = get_adapter("small_cnn")
    cfg = adapter.default_config()
    base = adapter.init(cfg, seed=0, device=CPU)
    g = torch.Generator().manual_seed(1)
    other = unflatten_paths({p: v + 0.01 * torch.randn(v.shape, generator=g)
                             for p, v in sorted(flatten_paths(base).items())})
    return adapter, cfg, {"A": base, "B": other}


def _trunk_plan(adapter, cfg, zoo):
    cloud = ParamStore.from_models(dict(zoo))
    trunk = adapter.split(cfg).prefix_paths
    recs = [r for m, p in zoo.items() for r in adapter.records(cfg, p, m) if r.path in trunk]
    groups = enumerate_groups(recs)
    for g in groups:
        cloud.merge_group(g)
    return MergePlan.from_json(cloud.export_plan(groups).to_json())


def _engine(adapter, cfg, store, mids=("A", "B")):
    return MergeAwareEngine(
        store, instances_from_store(store, "tiny-yolo", model_ids=list(mids)),
        [ModelProgram.from_adapter(adapter, m, cfg=cfg) for m in mids],
        capacity_bytes=10 ** 9, costs={"tiny-yolo": costs_for("tiny-yolo")},
        buckets=(1, 2, 4))


def _payload(i=0):
    return torch.randn((1, 32, 32, 3), generator=torch.Generator().manual_seed(i))


def _reqs(n, sla=30.0):
    return [Request("A" if i % 2 == 0 else "B", _payload(i), 0.0, sla) for i in range(n)]


def _registered(zoo):
    return [RegisteredModel(m, lambda p, b: 0.0, lambda p, b: 1.0, lambda e: [], None, 0.9, 1.0)
            for m in zoo]


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def test_apply_plan_fault_rolls_back_atomically_then_reapplies():
    adapter, cfg, zoo = _pair()
    plan = _trunk_plan(adapter, cfg, zoo)
    store = ParamStore.from_models(dict(zoo))
    eng = _engine(adapter, cfg, store)
    for r in _reqs(4):
        eng.submit(r)
    epoch0, keys0 = store.epoch, set(store.buffers)
    bind0 = {m: dict(b) for m, b in store.bindings.items()}
    inj = TF.FaultInjector()
    inj.arm_swap_failure(store, fail_after_columns=1)
    with pytest.raises(PlanApplyError) as ei:
        eng.apply_plan(plan)
    assert isinstance(ei.value.__cause__, TF.FaultError)
    assert inj.events[-1]["columns_committed"] == 1
    assert store.epoch == epoch0 + 1 and store.bindings == bind0 and set(store.buffers) == keys0
    assert sum(len(q) for q in eng.queues.values()) == 4
    assert sorted(map(tuple, eng.prefix_groups())) == [("A",), ("B",)]
    out = eng.apply_plan(plan)  # the injector is one-shot
    assert out["epoch_bumps"] == 1 and out["pending_requests"] == 4
    assert sorted(map(tuple, eng.prefix_groups())) == [("A", "B")]
    stats = eng.serve(horizon_s=30.0, warmup=_payload())
    assert stats["completed"] == 4 and eng.skipped == 0
    inj.arm_swap_failure(store)
    with pytest.raises(RuntimeError):
        inj.arm_swap_failure(store)
    inj.disarm()
    assert eng.apply_plan(plan)["epoch_bumps"] == 1


def test_lifecycle_controller_survives_a_failed_swap():
    adapter, cfg, zoo = _pair()
    plan = _trunk_plan(adapter, cfg, zoo)
    store = ParamStore.from_models(dict(zoo))
    eng = _engine(adapter, cfg, store)
    for r in _reqs(2):
        eng.submit(r)
    monitor = DriftMonitor(store, dict(zoo), _registered(zoo))
    ctl = LifecycleController(eng, monitor, lambda mids: {}, lambda seed, excl: plan,
                              clock=_Clock())
    ctl.state, ctl._pending_plan = REPLANNING, plan
    TF.FaultInjector().arm_swap_failure(store, fail_after_columns=1)
    ctl.tick()
    assert ctl.failed_swaps == 1 and ctl.swaps == 0
    assert ctl.state == SERVING and ctl.deployed_plan is None
    ev = ctl.events[-1]
    assert ev.state == SERVING and ev.detail["swap_failed"] and not ev.detail["swapped"]
    assert ev.detail["pending_requests"] == 2
    ctl.state = REVERTED
    ctl.tick()
    assert ctl.state == REPLANNING
    ctl.tick()
    assert ctl.swaps == 1 and ctl.deployed_plan is plan and ctl.state == SERVING


def test_replan_keeps_the_reference_schema_without_a_budget():
    """The port's planner has no per-attempt budget: the re-plan event and
    the ``ResumeState`` JSON carry the JAX package's ``replan_timed_out``
    key, always false, and the JSON round-trips byte-equal to the JAX
    package's ``ResumeState`` of the same fields."""
    adapter, cfg, zoo = _pair()
    plan = _trunk_plan(adapter, cfg, zoo)
    store = ParamStore.from_models(dict(zoo))
    ctl = LifecycleController(_engine(adapter, cfg, store),
                              DriftMonitor(store, dict(zoo), _registered(zoo)),
                              lambda mids: {}, lambda seed, excl: plan, clock=_Clock())
    ctl.state = REVERTED
    ctl.tick()
    assert ctl.events[-1].detail == {"excluded": [], "replan_timed_out": False,
                                     "groups": len(plan.groups)}
    ctl.tick()
    state = ctl.resume_state()
    payload = state.to_json()
    assert json.loads(payload)["replan_timed_out"] is False
    back = ResumeState.from_json(payload)
    assert back == state and back.to_json() == payload
    jstate = JaxResumeState(state.plan_json, state.excluded, state.revert_history, state.epoch)
    assert jstate.to_json() == payload


def test_rebind_interleaving_never_drops_queued_requests():
    adapter, cfg, zoo = _pair()
    plan = _trunk_plan(adapter, cfg, zoo)
    store = ParamStore.from_models(dict(zoo))
    eng = _engine(adapter, cfg, store)
    monitor = DriftMonitor(store, dict(zoo), _registered(zoo))

    def pending():
        return sum(len(q) for q in eng.queues.values())

    def rebind(op):
        e0, p0 = store.epoch, pending()
        out = (eng.apply_plan(plan) if op == "apply"
               else eng.revert(monitor, DriftReport({}, {"A", "B"}, set())))
        assert out["epoch_bumps"] == 1 and store.epoch == e0 + 1
        assert out["pending_requests"] == p0 == pending()

    reqs = _reqs(8, sla=1e6)
    for i, r in enumerate(reqs):
        eng.submit(r)
        if i in (1, 6):
            rebind("apply")
        elif i == 3:
            eng.serve(horizon_s=30.0, warmup=_payload())
        elif i == 5:
            rebind("revert")
    eng.serve(horizon_s=30.0)
    assert len(eng.completions) == len(reqs) and eng.skipped == 0
    assert store.shared_keys()
    assert set(store.buffers) == {k for b in store.bindings.values() for k in b.values()}


def test_expired_requests_counted_in_both_executors():
    adapter, cfg, zoo = _pair()
    store = ParamStore.from_models(dict(zoo))
    eng = _engine(adapter, cfg, store)
    eng.submit(Request("A", _payload(), 0.0, 0.0))  # already past its deadline
    stats = eng.serve(horizon_s=5.0)
    assert stats["completed"] == 0 and stats["dropped_expired"] == stats["skipped"] == 1
    ex = EdgeExecutor(store, instances_from_store(store, "tiny-yolo", model_ids=["A"]),
                      {"A": adapter.bound_forward(cfg)}, capacity_bytes=10 ** 9,
                      costs={"tiny-yolo": costs_for("tiny-yolo")})
    ex.submit(Request("A", _payload(), 0.0, 0.0))
    out = ex.serve(horizon_s=5.0, drain=True)
    assert out["dropped_expired"] == 1 and out["completed"] == 0 and ex.skipped == 1


def test_swap_failure_of_a_plan_smaller_than_the_failure_point():
    """A plan with fewer columns than ``fail_after_columns`` fails at its
    end, everything mutated and no epoch bump; the engine still rolls it
    back with one bump — in both packages."""
    jadapter = jax_get_adapter("small_cnn")
    zoo = DA.cnn_zoo(jadapter, jadapter.default_config(), ("A", "B"))
    tzoo = {m: bridge.to_torch(p, device=CPU) for m, p in zoo.items()}
    adapter, cfg, _ = _pair()
    payload = _trunk_plan(adapter, cfg, tzoo).to_json()
    seen = []
    for Store, F, Plan, params in ((JaxStore, JF, JaxMergePlan, zoo),
                                   (ParamStore, TF, MergePlan, tzoo)):
        store = Store.from_models(dict(params))
        inj = F.FaultInjector()
        inj.arm_swap_failure(store, fail_after_columns=10 ** 6)
        with pytest.raises(F.FaultError):
            store.apply_plan(Plan.from_json(payload))
        seen.append((inj.events, store.epoch, store.bindings))
    assert seen[1] == seen[0] and seen[1][1] == 0


def test_completions_own_their_rows():
    """A completion holds a copy of its row, not a view into the whole
    micro-batch output (bank or per member): retained completions must not
    keep every micro-batch's output alive."""
    adapter, cfg, zoo = _pair()
    store = ParamStore.from_models(dict(zoo))
    eng = _engine(adapter, cfg, store)
    eng.apply_plan(_trunk_plan(adapter, cfg, zoo))
    for r in _reqs(3) + [Request("B", _payload(9), 0.0, 60.0)]:
        eng.submit(r)
    stats = eng.serve(horizon_s=30.0, warmup=_payload())
    assert stats["completed"] == 4 and stats["suffix_dispatches"] >= 1
    for c in eng.completions:
        own = c.result.numel() * c.result.element_size()
        assert c.result.untyped_storage().nbytes() == own
