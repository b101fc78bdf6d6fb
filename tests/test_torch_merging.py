"""The port's joint retraining against the JAX package: optimizers,
losses, data streams and ``MergeTrainer`` on small_cnn and a tiny dense LM.

Params are one numpy zoo bridged to both packages (never re-drawn), and
every batch is made with numpy.  Tolerances: a single optimizer step or
loss is one short float32 computation, held to 1e-6; training runs compound
XLA's and PyTorch's different float32 summation orders over several steps
and are held to 1e-4, the cross-package float32 tolerance of
test_torch_models.py.  The trainer's decisions compare accuracies with
thresholds; the validation batches here hold 16 rows, so accuracies move in
steps of 1/16 (small_cnn) or 1/128 (dense: 16 rows of 8 tokens), far from
the 1e-3 progress threshold, and the targets are either reached at once
(0.0) or unreachable (2.0, where the relative early failure evicts
members): no decision sits on a tie between the packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IncrementalMerger as JaxIncrementalMerger
from repro.core import ParamStore as JaxStore
from repro.core import enumerate_groups as jax_enumerate_groups
from repro.core.merging import MergeTrainer as JaxMergeTrainer
from repro.core.validation import RegisteredModel as JaxRegistered
from repro.data.synthetic import LMStream as JaxLMStream
from repro.models import layers as JL
from repro.models.registry import get_adapter as jax_get_adapter
from repro.train.optimizer import SGD as JaxSGD
from repro.train.optimizer import AdamW as JaxAdamW
from repro.utils.tree import flatten_paths, unflatten_paths
from repro_torch import bridge
from repro_torch.core import (
    IncrementalMerger, ParamStore, RegisteredModel, enumerate_groups,
)
from repro_torch.core.merging import MergeTrainer, joint_grads
from repro_torch.data.synthetic import LMStream, VisionStream
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models.registry import get_adapter
from repro_torch.train.optimizer import SGD, AdamW

CPU = torch.device("cpu")
STEP_TOL = dict(rtol=1e-6, atol=1e-6)
RUN_TOL = dict(rtol=1e-4, atol=1e-4)
MIDS = ("A", "B", "C")


def _cfgs(name):
    jadapter, tadapter = jax_get_adapter(name), get_adapter(name)
    return jadapter, tadapter, jadapter.default_config(), tadapter.default_config()


def _zoo(name):
    """A base, a variant of it (every leaf + 0.05 N(0,1)) and a foreign
    init, as numpy trees."""
    jadapter, _, jcfg, _ = _cfgs(name)
    base = {p: np.asarray(v) for p, v in
            flatten_paths(jadapter.init(jcfg, jax.random.PRNGKey(0))).items()}
    foreign = {p: np.asarray(v) for p, v in
               flatten_paths(jadapter.init(jcfg, jax.random.PRNGKey(42))).items()}
    rng = np.random.default_rng(1)
    variant = {p: (v + 0.05 * rng.standard_normal(v.shape)).astype(v.dtype)
               for p, v in sorted(base.items())}
    return {"A": unflatten_paths(base), "B": unflatten_paths(variant),
            "C": unflatten_paths(foreign)}


def _batches(name, cfg, seed, n_batches=2, batch=8, val=16):
    """(train batches, val batch) as numpy."""
    rng = np.random.default_rng(seed)

    def one(n):
        if name == "small_cnn":
            return {"images": rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
                    "labels": rng.integers(0, cfg.n_classes, n).astype(np.int32)}
        toks = rng.integers(0, cfg.vocab_size, (n, 9)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return [one(batch) for _ in range(n_batches)], one(val)


def _registered(name, mids, target):
    """Both packages' RegisteredModels over the same numpy batches."""
    jadapter, tadapter, jcfg, tcfg = _cfgs(name)
    jregs, tregs = [], []
    for i, m in enumerate(mids):
        train, val = _batches(name, jcfg, 10 + i)
        jtrain = [{k: jnp.asarray(v) for k, v in b.items()} for b in train]
        ttrain = [{k: torch.from_numpy(v) for k, v in b.items()} for b in train]
        jregs.append(JaxRegistered(
            m, lambda p, b: jadapter.loss(jcfg, p, b), lambda p, b: jadapter.accuracy(jcfg, p, b),
            lambda e, t=jtrain: t, {k: jnp.asarray(v) for k, v in val.items()},
            accuracy_target=target))
        tregs.append(RegisteredModel(
            m, lambda p, b: tadapter.loss(tcfg, p, b), lambda p, b: tadapter.accuracy(tcfg, p, b),
            lambda e, t=ttrain: t, {k: torch.from_numpy(v) for k, v in val.items()},
            accuracy_target=target))
    return jregs, tregs


def _stores(zoo):
    js = JaxStore.from_models({m: jax.tree_util.tree_map(jnp.asarray, p) for m, p in zoo.items()})
    ts = ParamStore.from_models({m: bridge.to_torch(p, device=CPU) for m, p in zoo.items()})
    return js, ts


def _merge_trunks(name, js, ts, mids):
    jadapter, tadapter, jcfg, tcfg = _cfgs(name)
    jtrunk, ttrunk = jadapter.split(jcfg).prefix_paths, tadapter.split(tcfg).prefix_paths
    jrecs = [r for m in mids for r in jadapter.records(jcfg, js.materialize(m), m)
             if r.path in jtrunk]
    trecs = [r for m in mids for r in tadapter.records(tcfg, ts.materialize(m), m)
             if r.path in ttrunk]
    for jg, tg in zip(jax_enumerate_groups(jrecs), enumerate_groups(trecs)):
        assert ts.merge_group(tg) == js.merge_group(jg)
    return jrecs, trecs


def _assert_buffers_close(js, ts, tol):
    assert ts.bindings == js.bindings and ts.epoch == js.epoch
    for k in js.buffers:
        np.testing.assert_allclose(bridge.tensor_to_array(ts.buffers[k]),
                                   np.asarray(js.buffers[k]), **tol, err_msg=k)


# ---------------------------------------------------------------------------
# optimizers, losses, data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt", ["adamw", "adamw-decay-schedule", "sgd", "sgd-unclipped"])
def test_optimizer_steps_match_the_reference(opt):
    jopt, topt = {
        "adamw": (JaxAdamW(lr=1e-2), AdamW(lr=1e-2)),
        "adamw-decay-schedule": (JaxAdamW(lr=lambda s: 1e-2 / s, weight_decay=0.1, clip_norm=0.5),
                                 AdamW(lr=lambda s: 1e-2 / s, weight_decay=0.1, clip_norm=0.5)),
        "sgd": (JaxSGD(lr=0.1), SGD(lr=0.1)),
        "sgd-unclipped": (JaxSGD(lr=0.1, clip_norm=None), SGD(lr=0.1, clip_norm=None)),
    }[opt]
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float32)}
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, \
        {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(4):
        grads = {k: (3.0 * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in params.items()}
        jp, js = jopt.update({k: jnp.asarray(g) for k, g in grads.items()}, js, jp)
        with torch.no_grad():
            tp, ts = topt.update({k: torch.from_numpy(g) for k, g in grads.items()}, ts, tp)
        assert ts.step == int(js.step)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **STEP_TOL)
            np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]), **STEP_TOL)
            np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]), **STEP_TOL)


def test_adamw_keeps_a_bf16_param_in_bf16_with_f32_moments():
    p = {"w": torch.ones(3, dtype=torch.bfloat16)}
    opt = AdamW(lr=0.1)
    st = opt.init(p)
    new, st = opt.update({"w": torch.full((3,), 0.5, dtype=torch.bfloat16)}, st, p)
    assert new["w"].dtype == torch.bfloat16 and st.mu["w"].dtype == torch.float32


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_the_reference(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 40)).astype(np.float32)
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if masked else None
    want = JL.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), valid_vocab=33,
                                    mask=None if mask is None else jnp.asarray(mask))
    got = TL.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                   valid_vocab=33,
                                   mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), **STEP_TOL)


@pytest.mark.parametrize("name,task", [("small_cnn", "classification"),
                                       ("small_cnn", "detection"), ("dense", None)])
def test_adapter_loss_and_accuracy_match_the_reference(name, task):
    import dataclasses

    jadapter, tadapter, jcfg, tcfg = _cfgs(name)
    if task == "detection":
        jcfg = dataclasses.replace(jcfg, task=task)
        tcfg = dataclasses.replace(tcfg, task=task)
    params = flatten_paths(jadapter.init(jcfg, jax.random.PRNGKey(3)))
    params = unflatten_paths({p: np.asarray(v) for p, v in params.items()})
    rng = np.random.default_rng(4)
    if task == "detection":
        g = 32 // (2 ** (jcfg.n_stages - 1))
        batch = {"images": rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
                 "cls_targets": rng.integers(0, jcfg.n_classes, (4, g, g, jcfg.n_anchors)),
                 "loc_targets": rng.standard_normal((4, g, g, 4 * jcfg.n_anchors)
                                                    ).astype(np.float32)}
    else:
        batch = _batches(name, jcfg, 4)[1]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = bridge.to_torch(params, device=CPU)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    jloss = jax.jit(lambda p, b: jadapter.loss(jcfg, p, b))
    jacc = jax.jit(lambda p, b: jadapter.accuracy(jcfg, p, b))
    np.testing.assert_allclose(tadapter.loss(tcfg, tp, tb).item(), float(jloss(jp, jb)),
                               **RUN_TOL)
    assert tadapter.accuracy(tcfg, tp, tb).item() == float(jacc(jp, jb))


def test_lm_stream_yields_the_reference_tokens():
    for step in (0, 3):
        want = JaxLMStream(100, 4, 12, seed=5).batch_at(step)
        got = LMStream(100, 4, 12, seed=5, device="cpu").batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_vision_stream_is_a_deterministic_learnable_pool():
    s = VisionStream(4, 8, seed=7, device="cpu")
    b0, again = s.batch_at(0), VisionStream(4, 8, seed=7, device="cpu").batch_at(0)
    assert b0["images"].shape == (8, 32, 32, 3) and b0["labels"].shape == (8,)
    assert torch.equal(b0["images"], again["images"]) and torch.equal(b0["labels"], again["labels"])
    # the pool cycles: batch 32 of 8 wraps a pool of 256
    assert torch.equal(s.batch_at(32)["images"], b0["images"])
    assert len(s.epoch(1, n_batches=3)) == 3
    assert set(s._pool["labels"].tolist()) == {0, 1, 2, 3}
    det = VisionStream(3, 2, seed=1, task="detection", device="cpu").batch_at(0)
    assert det["cls_targets"].shape == (2, 8, 8, 4) and det["loc_targets"].shape == (2, 8, 8, 16)


@pytest.mark.parametrize("name", ["small_cnn", "dense"])
def test_registered_from_a_seed_trains_on_its_own_batches(name):
    _, tadapter, _, tcfg = _cfgs(name)
    reg = tadapter.registered(tcfg, "m", 3, device="cpu")
    again = tadapter.registered(tcfg, "m", torch.Generator().manual_seed(3))
    params = tadapter.init(tcfg, 0, device="cpu")
    for a, b in zip(reg.train_batches(0) + [reg.val_batch],
                    again.train_batches(0) + [again.val_batch]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    loss = reg.loss_fn(params, reg.train_batches(0)[0])
    assert loss.ndim == 0 and torch.isfinite(loss)
    assert 0.0 <= float(reg.accuracy_fn(params, reg.val_batch)) <= 1.0


# ---------------------------------------------------------------------------
# joint retraining
# ---------------------------------------------------------------------------


def test_require_no_grad_refuses_a_recorded_kernel_call():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.require_no_grad("flash_attention", x, None)
    with torch.no_grad():
        ops.require_no_grad("flash_attention", x)
    ops.require_no_grad("flash_attention", torch.ones(3), None)


@pytest.mark.parametrize("name", ["small_cnn", "dense"])
def test_shared_gradients_are_the_sum_of_the_members(name):
    """A shared buffer's joint gradient is the mean over the members of
    their separate gradients (the joint loss is their mean); a private
    buffer gets its own member's share; both equal JAX's gradient of the
    reference joint loss within 1e-6."""
    jadapter, tadapter, jcfg, tcfg = _cfgs(name)
    js, ts = _stores(_zoo(name))
    _merge_trunks(name, js, ts, ("A", "B"))
    jregs, tregs = _registered(name, ("A", "B"), 0.9)
    bindings = {m: dict(ts.bindings[m]) for m in ("A", "B")}
    keys = sorted({k for b in bindings.values() for k in b.values()})
    buffers = {k: ts.buffers[k] for k in keys}
    loss_fns = {r.model_id: r.loss_fn for r in tregs}
    batches = {r.model_id: r.train_batches(0)[0] for r in tregs}
    loss, grads = joint_grads(bindings, loss_fns, buffers, batches)
    per = {m: joint_grads({m: bindings[m]}, loss_fns, buffers, batches)[1] for m in bindings}
    shared = ts.shared_keys()
    assert shared and all(k in bindings["A"].values() for k in shared)
    for k in keys:
        torch.testing.assert_close(grads[k], (per["A"][k] + per["B"][k]) / 2, rtol=1e-6,
                                   atol=1e-7)
        if k not in shared:  # a private key gets exactly one member's gradient
            assert any(torch.count_nonzero(per[m][k]) == 0 for m in bindings)

    def jloss(bufs):
        total = 0.0
        for r in jregs:
            p = unflatten_paths({p: bufs[k] for p, k in js.bindings[r.model_id].items()})
            total = total + r.loss_fn(p, r.train_batches(0)[0])
        return total / 2

    jl, jg = jax.jit(jax.value_and_grad(jloss))({k: js.buffers[k] for k in keys})
    np.testing.assert_allclose(loss.item(), float(jl), **STEP_TOL)
    for k in keys:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jg[k]), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["small_cnn", "dense"])
@pytest.mark.parametrize("target", [0.0, 2.0], ids=["reached", "unreachable"])
def test_merge_trainer_matches_the_reference(name, target):
    """One joint retraining of the merged trunks: the same success, failed
    set, epochs, data fractions and accuracies as the JAX trainer, and
    buffers within 1e-4 after the run."""
    zoo = _zoo(name)
    js, ts = _stores(zoo)
    _merge_trunks(name, js, ts, MIDS)
    jregs, tregs = _registered(name, MIDS, target)
    jres = JaxMergeTrainer(optimizer=JaxAdamW(lr=3e-3), max_epochs=4).train(js, jregs)
    tres = MergeTrainer(optimizer=AdamW(lr=3e-3), max_epochs=4).train(ts, tregs)
    assert tres.success == jres.success
    assert tres.failed_models == jres.failed_models
    assert tres.epochs_used == jres.epochs_used
    assert tres.data_fraction_log == jres.data_fraction_log
    assert tres.accuracies == jres.accuracies
    _assert_buffers_close(js, ts, RUN_TOL)
    if target == 0.0:
        assert tres.success and tres.epochs_used == 1
    else:
        assert not tres.success and tres.failed_models


def test_incremental_merger_with_joint_retraining_matches_the_reference():
    """The planner over the three largest small_cnn trunk groups with real
    retraining (targets relative to each member's measured accuracy): the
    same committed groups, events and final bytes, buffers within 1e-4."""
    name = "small_cnn"
    zoo = _zoo(name)
    js, ts = _stores(zoo)
    jadapter, tadapter, jcfg, tcfg = _cfgs(name)
    jregs, tregs = _registered(name, MIDS, 0.9)
    for jr, tr in zip(jregs, tregs):
        acc = float(jr.accuracy_fn(js.materialize(jr.model_id), jr.val_batch))
        assert float(tr.accuracy_fn(ts.materialize(tr.model_id), tr.val_batch)) == acc
        jr.original_accuracy = tr.original_accuracy = acc
    jtrunk = jadapter.split(jcfg).prefix_paths
    jrecs = [r for m in MIDS for r in jadapter.records(jcfg, js.materialize(m), m)
             if r.path in jtrunk]
    keep = {g.signature for g in jax_enumerate_groups(jrecs)[:3]}
    trecs = [r for m in MIDS for r in tadapter.records(tcfg, ts.materialize(m), m)
             if r.signature in keep]
    jrecs = [r for r in jrecs if r.signature in keep]
    clock = lambda: 0.0  # noqa: E731
    jres = JaxIncrementalMerger(js, jregs, jrecs, JaxMergeTrainer(
        optimizer=JaxAdamW(lr=3e-3), max_epochs=2, clock=clock), clock=clock).run()
    tres = IncrementalMerger(ts, tregs, trecs, MergeTrainer(
        optimizer=AdamW(lr=3e-3), max_epochs=2, clock=clock), clock=clock).run()
    assert (tres.attempted, tres.committed, tres.discarded, tres.final_bytes) == \
        (jres.attempted, jres.committed, jres.discarded, jres.final_bytes)
    assert [(e.group_signature, e.n_appearances, e.saved_bytes, e.accuracies)
            for e in tres.events] == \
        [(e.group_signature, e.n_appearances, e.saved_bytes, e.accuracies) for e in jres.events]
    assert tres.committed >= 1
    _assert_buffers_close(js, ts, RUN_TOL)
