"""The port's ``CheckpointManager``: the counterparts of
``tests/test_ckpt.py`` (round trip, exact resume after a crash, atomic
save, dedup store, keep-GC) plus bf16 leaves and reshard-on-load.

A port checkpoint holds host numpy and the port's own classes; the JAX
package does not read it.  Where a test starts from the JAX package's
params (its dense test config, per-layer blocks), they cross through
``repro_torch.bridge`` and the restored trees are compared with them.
Everything inside the port is held bitwise: a checkpoint stores bytes.
"""
import itertools
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.ckpt.manager import CheckpointManager, HostBf16
from repro_torch.ckpt.reshard import reshard_state, train_state_shardings
from repro_torch.core import ParamStore, enumerate_groups, records_from_params
from repro_torch.data.synthetic import LMStream
from repro_torch.distributed.sharding import LogicalRules, make_mesh
from repro_torch.models import transformer as TT
from repro_torch.train.optimizer import AdamW, OptState
from repro_torch.train.trainer import Trainer, init_state
from repro_torch.utils.tree import flatten_paths

CPU = torch.device("cpu")
DIMS = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
            vocab_size=128)
TCFG = TT.DenseLMConfig(**DIMS)


@pytest.fixture(scope="module")
def params():
    jcfg = JT.DenseLMConfig(**DIMS, scan_layers=False)
    return bridge.to_torch(JT.init(jcfg, jax.random.PRNGKey(0)), device=CPU)


def _leaves(tree) -> list:
    """Every leaf of a train state in a fixed order (OptState unpacked)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, OptState):
            out += [("opt/step", v.step)] + [(f"opt/mu/{p}", t) for p, t in sorted(v.mu.items())] \
                + [(f"opt/nu/{p}", t) for p, t in sorted(v.nu.items())]
        elif isinstance(v, dict):
            out += sorted(flatten_paths(v, f"{k}/").items())
        else:
            out.append((k, v))
    return out


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                               y.view(torch.int16) if y.dtype == torch.bfloat16 else y), k
        else:
            assert x == y, k


def test_save_restore_roundtrip(tmp_path, params):
    state = init_state(params, AdamW(lr=1e-3), compress_grads=True)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, step=5)
    restored = mgr.restore_latest(device=CPU)
    assert mgr.latest_step() == 5
    assert isinstance(restored["opt"], OptState)
    _assert_states_equal(state, restored)
    # the step counter round-trips both ways: an int in, an int out
    state["step"] = 7
    mgr.save(state, step=int(state["step"]))
    assert int(mgr.restore(7, device=CPU)["step"]) == mgr.latest_step() == 7


def test_bf16_leaves_round_trip_as_their_bits(tmp_path):
    """bf16 leaves are written as uint16 bits with a bfloat16 label (numpy
    has no bfloat16), never through ml_dtypes, and come back bitwise,
    NaN payloads and signed zeros included."""
    bits = torch.tensor([0x7FC1, 0x8000, 0x0000, 0x3F80, 0xFF80, 0x0001], dtype=torch.int32)
    odd = bits.to(torch.int16).view(torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    state = {"params": {"w": torch.randn((16, 8), generator=gen).to(torch.bfloat16), "odd": odd,
                        "f": torch.randn(5, generator=gen), "i": torch.arange(4, dtype=torch.int32)},
             "step": 3}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, step=3)
    with open(mgr._path(3), "rb") as f:
        host = pickle.load(f)["state"]["params"]
    assert isinstance(host["w"], HostBf16) and host["w"].bits.dtype == np.uint16
    assert host["w"].dtype == "bfloat16" and isinstance(host["f"], np.ndarray)
    _assert_states_equal(state, mgr.restore(3, device=CPU))


def test_resume_exact(tmp_path, params):
    """6 steps straight == 3 steps, a crash, and a fresh Trainer resuming
    from the step-3 checkpoint to step 6, bitwise: params, both moments,
    the compressor's feedback and the step counters.  The resumed run's
    iterator starts at the restored step, since fit takes next(data_iter)
    for each step."""
    stream = LMStream(TCFG.vocab_size, 4, 16, device=CPU)

    def fit(steps, start, mgr=None):
        tr = Trainer(lambda p, b: TT.loss_fn(TCFG, p, b), AdamW(lr=1e-3), microbatches=2,
                     compress_grads=True, ckpt_manager=mgr, ckpt_every=3)
        return tr.fit(params, (stream.batch_at(i) for i in itertools.count(start)), steps,
                      log_every=1)

    full = fit(6, 0)
    fit(3, 0, CheckpointManager(str(tmp_path)))  # the crash: nothing after step 3
    assert CheckpointManager(str(tmp_path)).all_steps() == [3]
    resumed = fit(6, 3, CheckpointManager(str(tmp_path)))
    assert [h["step"] for h in resumed["history"]] == [3, 4, 5]
    assert resumed["history"] == full["history"][3:]
    _assert_states_equal(full["state"], resumed["state"])
    restored = CheckpointManager(str(tmp_path)).restore_latest(device=CPU)
    assert int(restored["step"]) == 6
    _assert_states_equal(full["state"], restored)


def test_atomic_no_partial(tmp_path, params):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"params": params, "step": 0}, step=1)
    # tmp files never linger
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000001.ckpt"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dedup_store_checkpoint(tmp_path, dtype):
    """Merged workload checkpoints shared buffers ONCE."""
    gen = torch.Generator().manual_seed(0)
    p1 = {"w": torch.randn((64, 64), generator=gen).to(dtype)}
    p2 = {"w": torch.randn((64, 64), generator=gen).to(dtype)}
    store = ParamStore.from_models({"a": p1, "b": p2})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_store(store, step=1, extra={"note": torch.ones(2)})
    size_unmerged = os.path.getsize(mgr._path(1))

    recs = records_from_params(p1, "a") + records_from_params(p2, "b")
    store.merge_group(enumerate_groups(recs)[0])
    mgr.save_store(store, step=2)
    size_merged = os.path.getsize(mgr._path(2))
    assert size_merged < size_unmerged * 0.7  # one 64x64 buffer gone

    restored, extra = mgr.restore_store(2, device=CPU)
    assert extra is None
    assert restored.bindings == store.bindings
    assert restored.resident_bytes() == store.resident_bytes()
    for m in ("a", "b"):
        got, want = restored.materialize(m)["w"], store.materialize(m)["w"]
        assert got.dtype == dtype and torch.equal(got, want)
    _, extra = mgr.restore_store(1, device=CPU)
    assert torch.equal(extra["note"], torch.ones(2))
    assert CheckpointManager(str(tmp_path / "empty")).restore_store(device=CPU) == (None, None)


def test_keep_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"x": torch.ones(3)}
    for s in [1, 2, 3, 4]:
        mgr.save(state, step=s)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_restore_under_shardings_and_reshard_state(tmp_path, params):
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = LogicalRules(mesh, {"batch": "data", "embed_fsdp": "data", "tensor": "model",
                                "vocab": "model", "layers": None})
    state = init_state(params, AdamW(), compress_grads=True)
    sh = train_state_shardings(state, rules)
    assert sh["opt"].mu.keys() == flatten_paths(params).keys() == sh["err"].keys()
    assert sh["params"]["embed"]["table"].spec == ("model", "data")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, step=2)
    _assert_states_equal(state, mgr.restore(2, shardings=sh))
    _assert_states_equal(state, reshard_state(state, rules))
