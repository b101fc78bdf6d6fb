"""The port's four serving examples against the JAX package's
(``examples/*.py``) on the same draws: the JAX examples' zoo, params,
images and frames, bridged into the port's, fed to the port's example
functions, with what each prints compared.  Step counts are cut where the
example trains (quickstart)."""
import functools
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.core import RegisteredModel
from repro_torch.examples import cloud_edge_plan as tcloud
from repro_torch.examples import drift_and_revert as tdrift
from repro_torch.examples import merge_and_serve as tmerge
from repro_torch.examples import quickstart as tquick
from repro_torch.models.registry import get_adapter as tget_adapter
from test_torch_plan import _counting_clock

CPU = torch.device("cpu")
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(tree):
    return bridge.to_torch(tree, device=CPU)


class BridgedStream:
    """A JAX ``VisionStream``'s batches as CPU tensors, in the port's
    stream interface."""

    def __init__(self, jstream):
        self.j = jstream

    def batch_at(self, step: int) -> dict:
        return _t(self.j.batch_at(step))

    def epoch(self, epoch_idx: int, n_batches: int = 4) -> list:
        return [_t(b) for b in self.j.epoch(epoch_idx, n_batches)]

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@pytest.mark.parametrize("name", ["quickstart", "merge_and_serve", "cloud_edge_plan",
                                  "drift_and_revert"])
def test_examples_default_to_the_card(name):
    mod = {"quickstart": tquick, "merge_and_serve": tmerge, "cloud_edge_plan": tcloud,
           "drift_and_revert": tdrift}[name]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

PRETRAIN_STEPS, MERGE_EPOCHS = 8, 1


def _jax_quickstart(jq, steps: int, max_epochs: int) -> tuple:
    """The JAX example's ``main`` at cut step counts: (inits, streams,
    what it printed)."""
    from repro.core import IncrementalMerger, ParamStore, records_from_params
    from repro.core.merging import MergeTrainer
    from repro.core.validation import meets_targets, validate
    from repro.data.synthetic import VisionStream
    from repro.models import vision as VI
    from repro.train.optimizer import AdamW
    from repro.utils import stable_seed

    cfg = VI.SmallCNNConfig(task="classification", n_classes=4, depth=1, width=8, n_stages=2)
    streams = {"cam-A": VisionStream(4, 32, seed=7), "cam-B": VisionStream(4, 32, seed=8)}
    inits = {m: VI.init_small_cnn(cfg, jax.random.PRNGKey(stable_seed(m))) for m in streams}
    params, orig = {}, {}
    for mid, stream in streams.items():
        params[mid] = jq.pretrain(cfg, inits[mid], stream, steps=steps)
        orig[mid] = float(VI.small_cnn_accuracy(cfg, params[mid], stream.batch_at(0)))
    store = ParamStore.from_models(params)
    before = store.resident_bytes()
    regs = [jq.RegisteredModel(
        mid, lambda p, b: VI.small_cnn_loss(cfg, p, b),
        lambda p, b: VI.small_cnn_accuracy(cfg, p, b),
        lambda e, s=streams[mid]: s.epoch(e, n_batches=4), streams[mid].batch_at(0),
        accuracy_target=0.9, original_accuracy=orig[mid]) for mid in params]
    recs = sum((records_from_params(params[m], m) for m in params), [])
    result = IncrementalMerger(store, regs, recs,
                               MergeTrainer(max_epochs=max_epochs, optimizer=AdamW(lr=2e-3)),
                               min_group_bytes=4096).run()
    accs = validate(store, regs)
    return inits, streams, dict(
        original_accuracy=orig, resident_bytes_before=before,
        resident_bytes_after=store.resident_bytes(), committed=result.committed,
        discarded=result.discarded, accuracies=accs, targets_met=meets_targets(accs, regs),
        events=[e.group_signature[0] for e in result.events])


def test_quickstart_matches_the_jax_example():
    jq = _jax_example("quickstart")
    inits, streams, want = _jax_quickstart(jq, PRETRAIN_STEPS, MERGE_EPOCHS)
    got = tquick.run(tquick.CFG, {m: _t(p) for m, p in inits.items()},
                     {m: BridgedStream(s) for m, s in streams.items()},
                     pretrain_steps=PRETRAIN_STEPS, max_epochs=MERGE_EPOCHS)
    for k in ("resident_bytes_before", "resident_bytes_after", "committed", "discarded",
              "targets_met"):
        assert got[k] == want[k], k
    assert [e["group"] for e in got["events"]] == want["events"]
    for k in ("original_accuracy", "accuracies"):
        assert sorted(got[k]) == sorted(want[k])
        for m in want[k]:
            assert abs(got[k][m] - want[k][m]) <= 1e-4, (k, m)


# ---------------------------------------------------------------------------
# merge_and_serve
# ---------------------------------------------------------------------------


def test_merge_and_serve_simulated_matches_the_jax_example(monkeypatch, capsys):
    jm = _jax_example("merge_and_serve")
    results = []
    real = jm.simulate

    def recording(*a, **k):
        res = real(*a, **k)
        results.append(res)
        return res

    monkeypatch.setattr(jm, "simulate", recording)
    jm.simulated("MP2")
    want_out = capsys.readouterr().out
    got = tmerge.simulated("MP2")
    assert capsys.readouterr().out == want_out
    for merged, res in zip(["none", "optimal"], results):
        assert got[merged] == dict(accuracy=res.overall_accuracy,
                                   processed=res.processed_fraction,
                                   swap_ms=res.swap_ms_total), merged
    assert got["optimal"]["swap_ms"] < got["none"]["swap_ms"]


def _rows_match_direct_forward(store, completions, cfg):
    adapter = tget_adapter("small_cnn")
    for c in completions:
        want = adapter.forward(cfg, store.materialize(c.request.instance_id), c.request.payload)
        torch.testing.assert_close(c.result.float(), want[0].float(), rtol=1e-5, atol=1e-5)


def test_merge_and_serve_real_executor_serves_every_request():
    adapter = tget_adapter("small_cnn")
    cfg = adapter.default_config()
    jadapter = _jax_example("merge_and_serve")  # imports the JAX example's modules
    from repro.models.registry import get_adapter

    ja = get_adapter("small_cnn")
    pa, pb = (_t(ja.init(ja.default_config(), jax.random.PRNGKey(i))) for i in (0, 1))
    imgs = _t({"x": jax.random.normal(jax.random.PRNGKey(2), (1, 32, 32, 3))})["x"]
    assert jadapter is not None
    out = tmerge.real_executor(pa, pb, imgs)
    assert out["engine"]["completed"] == 40 and len(out["engine_completions"]) == 40
    assert out["engine"]["prefix_runs"] > 0
    # the per-request lane runs on the wall clock against 0.5 s deadlines:
    # every request is completed or skipped (expired) by its 3 s horizon's end
    # at most, how many of each depends on the host's load
    assert out["per_request"]["completed"] + out["per_request"]["skipped"] <= 40
    assert out["per_request"]["completed"] == len(out["per_request_completions"])
    _rows_match_direct_forward(out["store"], out["engine_completions"], cfg)
    _rows_match_direct_forward(out["store"], out["per_request_completions"], cfg)


# ---------------------------------------------------------------------------
# cloud_edge_plan
# ---------------------------------------------------------------------------


def test_cloud_edge_plan_matches_the_jax_example(monkeypatch, capsys):
    jc = _jax_example("cloud_edge_plan")
    swaps = []

    class RecordingEngine(jc.MergeAwareEngine):
        def apply_plan(self, plan):
            out = super().apply_plan(plan)
            swaps.append(dict(out, resident=self.store.resident_bytes()))
            return out

    monkeypatch.setattr(jc, "MergeAwareEngine", RecordingEngine)
    # a counting clock in both planners: the plan's event times are in its JSON
    for mod in (jc, tcloud):
        monkeypatch.setattr(mod, "StagedPlanner", functools.partial(
            mod.StagedPlanner, clock=_counting_clock()))
    jzoo = jc.make_zoo()
    jbatch = jc.ADAPTER.calibration_batch(jc.CFG, jax.random.PRNGKey(7), 32)
    jregs = [jc.ADAPTER.registered(jc.CFG, m, jax.random.PRNGKey(i + 10))
             for i, m in enumerate(sorted(jzoo))]
    want_payload = jc.cloud_plan()
    jc.edge_serve(want_payload)
    want_out = capsys.readouterr().out
    want_before = int(want_out.split("resident bytes: ")[1].split(" ->")[0])

    zoo = {m: _t(p) for m, p in jzoo.items()}
    regs = [RegisteredModel(r.model_id, (lambda p, b: tcloud.ADAPTER.loss(tcloud.CFG, p, b)),
                            (lambda p, b: tcloud.ADAPTER.accuracy(tcloud.CFG, p, b)),
                            (lambda e, tb=[_t(b) for b in r.train_batches(0)]: tb),
                            _t(r.val_batch), r.accuracy_target, r.original_accuracy)
            for r in jregs]
    payload, _ = tcloud.cloud_plan(zoo, _t(jbatch), regs)
    assert payload == want_payload  # the plan's JSON byte for byte
    img = _t({"x": jax.random.normal(jax.random.PRNGKey(2), (1, 32, 32, 3))})["x"]
    got = tcloud.edge_serve(payload, {m: _t(p) for m, p in jc.make_zoo().items()}, img)
    (swap,) = swaps
    assert got["shared_keys"] == sorted(swap["shared_keys"])
    assert (got["epoch_bumps"], got["pending_requests"]) == \
        (swap["epoch_bumps"], swap["pending_requests"]) == (1, 9)
    assert (got["resident_bytes_before"], got["resident_bytes_after"]) == \
        (want_before, swap["resident"])
    assert got["prefix_groups_after"] == [["cam-A", "cam-B", "cam-C"]]
    assert got["stats"]["completed"] == 9
    _rows_match_direct_forward(got["store"], got["engine"].completions, tcloud.CFG)


# ---------------------------------------------------------------------------
# drift_and_revert
# ---------------------------------------------------------------------------


def test_drift_and_revert_matches_the_jax_example(monkeypatch, capsys):
    jd = _jax_example("drift_and_revert")
    reports, stores = [], []

    class RecordingMonitor(jd.DriftMonitor):
        def __init__(self, store, *a):
            super().__init__(store, *a)
            stores.append(store)

        def check(self, frames):
            reports.append(super().check(frames))
            return reports[-1]

    monkeypatch.setattr(jd, "DriftMonitor", RecordingMonitor)
    jd.main()
    want_out = capsys.readouterr().out
    (report,), (jstore,) = reports, stores

    from repro.data.synthetic import VisionStream
    from repro.models import vision as VI

    cfg = VI.SmallCNNConfig(task="classification", n_classes=4, depth=1, width=8, n_stages=2)
    pa, pb = (_t(VI.init_small_cnn(cfg, jax.random.PRNGKey(i))) for i in (0, 1))
    frames = {"A": _t(VisionStream(4, 64, seed=0).batch_at(0)),
              "B": _t(VisionStream(4, 64, seed=999).batch_at(0))}
    got = tdrift.run(tdrift.CFG, pa, pb, frames)
    assert sorted(got["checked"]) == sorted(report.checked)
    for m, acc in report.checked.items():
        assert abs(got["checked"][m] - acc) <= 1e-6, m
    assert got["breached"] == set(report.breached)
    assert got["reverted"] == set(report.reverted)
    assert got["shared_after"] == len(jstore.shared_keys())
    assert f"deployed merged config: {got['shared_before']} shared buffers" in want_out
    np.testing.assert_equal(got["shared_before"], 3)
