"""The port's fault tolerance: the counterparts of ``tests/test_runtime.py``
(heartbeats, stragglers, ``plan_for_devices``, failure recovery end to
end).  The monitors and the mesh arithmetic are pure Python in both
packages, so their decisions compare exactly; the recovered state is the
checkpointed one bitwise, placed on the port's ``Mesh``."""
import jax
import pytest
import torch

from repro.distributed import elastic as jelastic
from repro.models import transformer as JT
from repro.runtime import monitors as jmonitors
from repro_torch import bridge
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.distributed.elastic import plan_for_devices
from repro_torch.distributed.sharding import LogicalRules, make_mesh
from repro_torch.runtime.monitors import FailurePolicy, HeartbeatMonitor, StragglerMonitor
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import init_state
from repro_torch.utils.tree import flatten_paths

CPU = torch.device("cpu")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_heartbeat_detects_and_rejoins():
    clock = FakeClock()
    dead_log = []
    mon = HeartbeatMonitor(4, timeout_s=10.0, clock=clock, on_failure=dead_log.append)
    clock.t = 5.0
    for w in range(3):
        mon.beat(w)  # worker 3 silent
    clock.t = 12.0  # workers 0-2 fresh (7s); worker 3 stale (12s > 10s)
    newly = mon.check()
    assert newly == {3}
    assert dead_log == [3]
    assert mon.alive == 3
    mon.beat(3)  # restart/rejoin
    assert mon.alive == 4
    mon.tick(0, {"step_time": 1.0})  # the Trainer's call: worker 0 beats
    assert mon.last_seen[0] == 12.0


def _straggler_pair(times):
    """Both packages' monitors over the same step times: (evictions, events)."""
    out = []
    for cls in (StragglerMonitor, jmonitors.StragglerMonitor):
        evicts = []
        mon = cls(threshold=2.0, evict_after=3, on_evict=evicts.append)
        for i, t in enumerate(times):
            mon.tick(i, {"step_time": t})
        mon.tick(len(times), {"loss": 1.0})  # no step_time: ignored
        out.append((evicts, mon.events, mon.flags))
    assert out[0] == out[1]
    return out[0]


def test_straggler_eviction_policy():
    evicts, events, _ = _straggler_pair([1.0] * 10 + [5.0] * 3)  # persistent straggler
    assert evicts, "persistent straggler must trigger eviction"
    assert len(events) >= 3


def test_straggler_transient_absorbed():
    evicts, events, flags = _straggler_pair([1.0] * 10 + [5.0] + [1.0] * 4)  # one-off blip
    assert not evicts and len(events) == 1 and flags == 0


@pytest.mark.parametrize("n,mp,pod", [(512, 16, 16), (256, 16, 0), (384, 16, 0), (40, 4, 2),
                                      (8, 16, 0)])
def test_plan_for_devices(n, mp, pod):
    try:
        want = jelastic.plan_for_devices(n, mp, pod)
    except ValueError:
        with pytest.raises(ValueError):
            plan_for_devices(n, mp, pod)
        return
    got = plan_for_devices(n, mp, pod)
    assert (got.shape, got.axes, got.n_devices) == (want.shape, want.axes, want.n_devices)
    if (n, mp, pod) == (512, 16, 16):
        assert got.shape == (2, 16, 16)
    if n == 384:  # losing a pod: 384 usable devices -> 24 data-way
        assert got.n_devices == 384


def test_failure_recovery_end_to_end(tmp_path):
    """Train state -> ckpt -> 'lose' devices -> restore resharded -> equal."""
    cfg = JT.DenseLMConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
                           d_ff=64, vocab_size=128, scan_layers=False)
    params = bridge.to_torch(JT.init(cfg, jax.random.PRNGKey(0)), device=CPU)
    state = init_state(params, AdamW())
    state["step"] = 7
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, step=7)

    policy = FailurePolicy(total_devices=8, model_parallel=1, ckpt_manager=mgr)
    plan = policy.recover_plan(failed_devices=3)
    jplan = jmonitors.FailurePolicy(total_devices=8, model_parallel=1).recover_plan(3)
    assert plan.n_devices == 5 and plan.shape == jplan.shape

    # the surviving mesh: the plan's shape over the one host device repeated
    def rules_factory(p):
        mesh = make_mesh(p.shape, p.axes, "cpu")
        return LogicalRules(mesh, {"batch": "data", "embed_fsdp": "data", "tensor": None,
                                   "layers": None, "vocab": None, "expert": None})

    fresh = init_state(params, AdamW())  # what the survivors hold before the restore
    new_state, plan2 = policy.simulate(fresh, rules_factory, failed_devices=3)
    assert plan2 == plan
    assert int(new_state["step"]) == int(state["step"]) == 7
    a, b = flatten_paths(state["params"]), flatten_paths(new_state["params"])
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) and b[k].device == CPU for k in a)
    assert all(torch.equal(state["opt"].nu[k], new_state["opt"].nu[k]) for k in a)
    # without a checkpoint manager the given state is resharded as it is
    same, _ = FailurePolicy(8, 1).simulate(state, rules_factory, failed_devices=3)
    assert same["step"] == 7
