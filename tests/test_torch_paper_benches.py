"""The port's paper benches (``repro_torch.bench``: Tables 1-3, Figs 3-5,
7, 9-14 and the ordering ablation) and ``core/memory.py`` against the JAX
package's.

The host benches are Python and numpy arithmetic done in the same order in
both packages, so their rows and derived values are compared EXACTLY, on
the three workloads of tests/test_torch_sim.py (the JAX benches'
``WORKLOADS`` bindings patched to them, the port's passed as
``workloads=``) or on every model they list.  Both packages' artifacts go
to ``tmp_path``.

fig14's plan-wire lane is tests/test_torch_plan_wire.py.

fig7 retrains two small CNNs: the port gets the JAX bench's pretrained
params and its streams' batches.  XLA and torch sum float32 in other
orders, so after retraining each member's accuracy is held within one
image of the 32-image validation batch of the JAX row's, and the retrained
shared buffers within rtol = atol = 1e-4 (tests/test_torch_merging.py's
RUN_TOL).
"""
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro.configs import vision_workloads as JV
import repro.core.signatures as JSG
from repro.core import memory as JM
from repro.data.synthetic import VisionStream as JaxVisionStream
from repro.models import vision as JVI
from repro_torch import bridge
from repro_torch.bench import ablation_ordering as TAB
from repro_torch.bench import common as TCOMMON
from repro_torch.bench import fig3_nexus as TF3
from repro_torch.bench import fig4_commonality as TF4
from repro_torch.bench import fig5_potential as TF5
from repro_torch.bench import fig7_sharing_accuracy as TF7
from repro_torch.bench import fig9_powerlaw as TF9
from repro_torch.bench import fig10_e2e as TF10
from repro_torch.bench import fig11_savings as TF11
from repro_torch.bench import fig12_baselines as TF12
from repro_torch.bench import fig13_incremental as TF13
from repro_torch.bench import fig14_bandwidth as TF14
from repro_torch.bench import run as TRUN
from repro_torch.bench import table1_memory as TT1
from repro_torch.bench import table2_times as TT2
from repro_torch.bench import table3_sweeps as TT3
from repro_torch.configs import vision_workloads as TV
from repro_torch.core import memory as TM
from repro_torch.core import signatures as TSG
from repro_torch.models import vision as TVI

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from benchmarks import ablation_ordering as AB  # noqa: E402
from benchmarks import common as JCOMMON  # noqa: E402
from benchmarks import fig3_nexus as F3  # noqa: E402
from benchmarks import fig4_commonality as F4  # noqa: E402
from benchmarks import fig5_potential as F5  # noqa: E402
from benchmarks import fig7_sharing_accuracy as F7  # noqa: E402
from benchmarks import fig9_powerlaw as F9  # noqa: E402
from benchmarks import fig10_e2e as F10  # noqa: E402
from benchmarks import fig11_savings as F11  # noqa: E402
from benchmarks import fig12_baselines as F12  # noqa: E402
from benchmarks import fig13_incremental as F13  # noqa: E402
from benchmarks import fig14_bandwidth as F14  # noqa: E402
from benchmarks import table1_memory as T1  # noqa: E402
from benchmarks import table2_times as T2  # noqa: E402
from benchmarks import table3_sweeps as T3  # noqa: E402

CPU = torch.device("cpu")
RUN_TOL = dict(rtol=1e-4, atol=1e-4)
SIM_WORKLOADS = ("LP2", "MP2", "HP4")
SPEC_IDS = sorted(JVI.SPEC_BUILDERS)

# (JAX run, port run, whether it sweeps workloads); table3 runs its own
# three representative workloads whatever WORKLOADS holds
HOST_BENCHES = {
    "table1_memory": (T1.run, TT1.run, False),
    "table2_times": (T2.run, TT2.run, False),
    "fig3_nexus": (F3.run, TF3.run, True),
    "fig4_commonality": (F4.run, TF4.run, False),
    "fig5_potential": (F5.run, TF5.run, True),
    "fig9_powerlaw": (F9.run, TF9.run, False),
    "fig10_e2e": (F10.run, TF10.run, True),
    "fig11_savings": (F11.run, TF11.run, True),
    "fig12_baselines": (F12.run, TF12.run, True),
    "fig13_incremental": (F13.run, TF13.run, True),
    "fig14_bandwidth": (F14.run_surrogate, TF14.run_surrogate, True),
    "table3_sweeps": (T3.run, TT3.run, False),
    "ablation_ordering": (AB.run, TAB.run, True),
}


@pytest.fixture
def artifacts(tmp_path, monkeypatch):
    """Both packages' ``emit`` write under ``tmp_path``; returns (JAX dir,
    port dir)."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    monkeypatch.setattr(JCOMMON, "ARTIFACTS", str(jdir))
    monkeypatch.setattr(TCOMMON, "ARTIFACTS", str(tdir))
    return jdir, tdir


@pytest.mark.parametrize("name", sorted(HOST_BENCHES))
def test_host_bench_equals_the_reference(name, artifacts, monkeypatch):
    jrun, trun, sweeps = HOST_BENCHES[name]
    if sweeps:
        subset = {w: JV.WORKLOADS[w] for w in SIM_WORKLOADS}
        monkeypatch.setattr(sys.modules[jrun.__module__], "WORKLOADS", subset)
        want = jrun()
        got = trun(workloads={w: TV.WORKLOADS[w] for w in SIM_WORKLOADS})
    else:
        want, got = jrun(), trun()
    assert got["rows"] == want["rows"]
    assert got["derived"] == want["derived"]
    jdir, tdir = artifacts
    artifact = f"{got['name']}.json"
    assert json.loads((tdir / artifact).read_text()) == json.loads((jdir / artifact).read_text())


def test_fig10_on_a_constructed_workload_equals_the_reference(artifacts, monkeypatch):
    """fig10 on MP4, one of the six workloads ``construct_missing`` draws
    (tests/test_torch_sim.py holds both packages' draws equal): its rows
    equal the JAX bench's, and at 75% GEMEL reads below time/space sharing
    in both, the one row of the 15 workloads where it does
    (``chip_smoke.FIG10_ROWS_BELOW_TIMESHARE``)."""
    import repro.serving.workload as JW

    mp4 = {"MP4": JV.construct_missing()["MP4"]}
    for mod in (JV, JW):  # the JAX package looks workloads up by name here
        monkeypatch.setattr(mod, "WORKLOADS", {**JV.WORKLOADS, **mp4})
    monkeypatch.setattr(F10, "WORKLOADS", mp4)
    want = F10.run()
    got = TF10.run(workloads=mp4)
    assert got["rows"] == want["rows"] and got["derived"] == want["derived"]
    below = [r["memory"] for r in got["rows"] if r["gemel_acc"] < r["nexus_acc"]]
    assert below == ["75%"]


@pytest.mark.parametrize("model_id", SPEC_IDS)
def test_memory_accounting_equals_the_reference(model_id):
    js, ts = JVI.get_spec(model_id), TVI.get_spec(model_id)
    for batch in (1, 4):
        assert TM.activation_bytes(ts, batch) == JM.activation_bytes(js, batch)
        assert TM.run_bytes(ts, batch) == JM.run_bytes(js, batch)
    assert TM.load_bytes(ts) == JM.load_bytes(js)
    trecs = TSG.records_from_spec(ts)
    jrecs = JSG.records_from_spec(js)
    tcum, jcum = TM.cumulative_layer_memory(trecs), JM.cumulative_layer_memory(jrecs)
    assert tcum.dtype == jcum.dtype and np.array_equal(tcum, jcum)
    for frac in (0.15, 0.5):
        assert TM.heavy_hitter_stats(trecs, frac) == JM.heavy_hitter_stats(jrecs, frac)
    # a workload of this model and every other, at two batch sizes
    others = [m for m in SPEC_IDS if m != model_id]
    for batch in (1, 2):
        tw = TM.workload_memory([ts] + [TVI.get_spec(m) for m in others], batch)
        jw = JM.workload_memory([js] + [JVI.get_spec(m) for m in others], batch)
        assert (tw.min_bytes, tw.max_bytes, tw.framework_bytes) == \
            (jw.min_bytes, jw.max_bytes, jw.framework_bytes)
        assert [tw.setting(s) for s in ("min", "50%", "75%")] == \
            [jw.setting(s) for s in ("min", "50%", "75%")]


# ---------------------------------------------------------------------------
# fig7: joint retraining on the JAX bench's pretrained params and batches
# ---------------------------------------------------------------------------


class JaxBatches:
    """A port stream over a JAX ``VisionStream``'s batches, as tensors."""

    def __init__(self, stream):
        self.stream = stream

    def batch_at(self, step: int) -> dict:
        return {k: torch.from_numpy(np.array(v)) for k, v in self.stream.batch_at(step).items()}

    def epoch(self, epoch_idx: int, n_batches: int = 4) -> list:
        return [self.batch_at(epoch_idx * n_batches + i) for i in range(n_batches)]


def _recording_validate(validate, to_numpy, log):
    """``validate`` that first records the store's shared buffers."""
    def wrapped(store, models, buffers=None):
        log.append({k: to_numpy(store.buffers[k]) for k in sorted(store.shared_keys())})
        return validate(store, models, buffers)
    return wrapped


@pytest.fixture(scope="module")
def fig7_curves():
    """Both packages' curves at a budget of 2 epochs: the JAX bench whole
    (its pretrained params recorded), the port on those params and the JAX
    streams' batches at n_shared 0, 2 and every layer; each row's shared
    buffers after retraining."""
    mp = pytest.MonkeyPatch()
    pretrained, jbufs, tbufs = [], [], []

    real_pretrain = F7._pretrain

    def pretrain(*a, **kw):
        pretrained.append(real_pretrain(*a, **kw))
        return pretrained[-1]

    mp.setattr(F7, "_pretrain", pretrain)
    mp.setattr(F7, "emit", lambda name, rows, derived=None, quiet=False: {"rows": rows})
    mp.setattr(F7, "validate", _recording_validate(F7.validate, np.asarray, jbufs))
    mp.setattr(TF7, "validate", _recording_validate(TF7.validate, bridge.tensor_to_array, tbufs))
    try:
        jrows = F7.run(budget_epochs=2)["rows"]
        params = {m: bridge.to_torch(p, device=CPU) for m, p in zip("AB", pretrained)}
        streams = {m: JaxBatches(JaxVisionStream(4, 32, seed=7 + i)) for i, m in enumerate("AB")}
        n_all = jrows[-1]["n_shared_layers"]
        rows = TF7.sharing_curve(TF7.Fig7Inputs(params, streams), budget_epochs=2,
                                 n_shared=(0, 2, n_all))
    finally:
        mp.undo()
    cfg = JVI.SmallCNNConfig(task="classification", n_classes=4, depth=1, width=8, n_stages=2)
    orig = {m: float(JVI.small_cnn_accuracy(cfg, p, JaxVisionStream(4, 32, seed=7 + i)
                                            .batch_at(0)))
            for i, (m, p) in enumerate(zip("AB", pretrained))}
    jby = {r["n_shared_layers"]: (r, b) for r, b in zip(jrows, jbufs)}
    return {r["n_shared_layers"]: (r, b, *jby[r["n_shared_layers"]])
            for r, b in zip(rows, tbufs)}, orig


@pytest.mark.parametrize("which", ["none", "two", "all"])
def test_fig7_rows_match_the_reference(fig7_curves, which):
    curves, orig = fig7_curves
    n = sorted(curves)[("none", "two", "all").index(which)]
    row, bufs, jrow, jbufs = curves[n]
    assert row["n_shared_layers"] == jrow["n_shared_layers"] == n
    one_image = 1 / 32
    for m in "AB":
        key = f"acc_{m}_rel"
        assert abs(row[key] - jrow[key]) * orig[m] <= one_image + 1e-6, (m, row, jrow)
    assert abs(row["min_rel_acc"] - jrow["min_rel_acc"]) * min(orig.values()) <= one_image + 1e-6
    assert sorted(bufs) == sorted(jbufs)
    assert (n == 0) == (not bufs)
    for k in jbufs:
        np.testing.assert_allclose(bufs[k], jbufs[k], **RUN_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# the bench runner
# ---------------------------------------------------------------------------


def test_bench_runner_lists_every_ported_bench(artifacts, capsys):
    names = [n for n, _ in TRUN.modules(fast=False)]
    assert names[:6] == ["table1_memory", "table2_times", "fig3_nexus", "fig4_commonality",
                         "fig5_potential", "fig9_powerlaw"]
    assert "fig7_sharing_accuracy" in names
    assert "fig7_sharing_accuracy" not in [n for n, _ in TRUN.modules(fast=True)]
    assert "mixed_zoo" not in names
    i = names.index("ablation_ordering")
    assert names[i:i + 3] == ["ablation_ordering", "roofline", "shard_serve"]
    TRUN.main(["--only", "table2_times", "--device", "cpu"])
    assert "[table2_times] ok" in capsys.readouterr().out
    assert (artifacts[1] / "table2_times.json").exists()
