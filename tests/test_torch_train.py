"""The port's training tier against the JAX package: schedules, the int8
gradient compressor with error feedback, and ``Trainer`` step for step on
shared parameters and the same ``LMStream`` tokens.

The config is ``tests/test_ckpt.py``'s dense LM (per-layer blocks in both
packages).  JAX params cross through ``repro_torch.bridge``; the JAX
package's step is jitted (its ``Trainer`` does that itself).

Tolerances, float32 across packages (XLA and PyTorch reduce the same
GEMMs and norms in different orders): losses within 1e-5 absolute,
``grad_norm`` within 1e-5 relative, final params within 1e-5.  With
``compress_grads`` a gradient 1e-7 off can round to the neighbouring int8
level (one quantum, amax / 127, of that leaf), and AdamW turns that into a
different update of that element: there ``grad_norm`` is held at 1e-4
relative and the params at 1e-4, with at most 1% of the elements beyond
1e-5.  The optimizer's moments are held as the params are.  The carried
error takes each flip whole (one quantum of its leaf), so it is held at
1e-5 for all but 2% of its elements (1.3% were beyond at microbatches 1
and none at 2, on the CPU).  The compressor alone is bitwise the JAX
package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import LMStream as JLMStream
from repro.distributed.compression import Int8Compressor as JInt8Compressor
from repro.models import transformer as JT
from repro.train import schedule as jsched
from repro.train.optimizer import AdamW as JAdamW
from repro.train.trainer import Trainer as JTrainer
from repro_torch import bridge
from repro_torch.data.synthetic import LMStream, sharded_iter
from repro_torch.distributed.compression import Int8Compressor
from repro_torch.distributed.elastic import reshard_tree
from repro_torch.distributed.sharding import LogicalRules, make_mesh
from repro_torch.models import transformer as TT
from repro_torch.train import schedule as tsched
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import (
    Trainer, _split_microbatches, batch_shardings, init_state, make_train_step,
)
from repro_torch.utils.tree import flatten_paths

CPU = torch.device("cpu")
DIMS = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
            vocab_size=128)
JCFG = JT.DenseLMConfig(**DIMS, scan_layers=False)
TCFG = TT.DenseLMConfig(**DIMS)
STEPS = 6


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def host_params():
    """The JAX package's params as host numpy (each run builds its own
    arrays from these: the JAX step donates its state)."""
    return jax.tree_util.tree_map(np.array, JT.init(JCFG, jax.random.PRNGKey(0)))


def _np(tree) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in flatten_paths(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _tnp(flat: dict) -> dict:
    return {k: v.float().numpy() for k, v in flat.items()}


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("warmup_cosine", (3e-4, 20, 100)),
    ("warmup_cosine", (1e-3, 0, 10, 0.0)),
    ("inverse_sqrt", (3e-4, 20)),
])
def test_schedule_matches_jax(name, args):
    jfn, tfn = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for step in range(0, 130):
        got = tfn(step)
        assert got.dtype == torch.float32 and got.shape == ()
        want = np.float32(jfn(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=0, err_msg=str(step))


def test_adamw_takes_a_schedule():
    opt = AdamW(lr=tsched.warmup_cosine(1e-2, 2, 10))
    params = {"w": torch.ones(3)}
    new, state = opt.update({"w": torch.ones(3)}, opt.init(params), params)
    assert state.step == 1
    # step 1 of 2 warmup steps: lr = 5e-3, and AdamW's first update is lr * sign(g)
    torch.testing.assert_close(new["w"], torch.full((3,), 1 - 5e-3), rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# int8 compression with error feedback
# ---------------------------------------------------------------------------


def test_int8_compression_error_feedback():
    """Quantization error is carried, not lost: sum over steps converges."""
    comp = Int8Compressor()
    g_true = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(64)
                                    .astype(np.float32)) * 0.01}
    err = comp.init(g_true)
    acc = torch.zeros(64)
    for _ in range(50):
        g_q, err = comp.compress(g_true, err)
        acc = acc + g_q["w"]
    torch.testing.assert_close(acc / 50, g_true["w"], rtol=0, atol=2e-4)
    assert Int8Compressor.wire_bytes_fraction() == 0.5


def test_int8_compressor_is_bitwise_the_jax_one():
    """Five rounds of compress on the same numpy gradients, the error fed
    back in each package: compressed gradients (float32 and bf16 leaves)
    and the error bitwise equal, including values exactly at x.5 quanta.
    The port takes the gradients flat by path, as its trainer holds them."""
    rng = np.random.default_rng(1)
    half = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 3.0], np.float32) / 127.0
    grads = [{"a": {"w": rng.standard_normal((8, 16)).astype(np.float32) * 1e-3,
                    "h": half * (1 + i)},
              "b": rng.standard_normal(40).astype(np.float32).astype(jnp.bfloat16)}
             for i in range(5)]
    jc, tc = JInt8Compressor(), Int8Compressor()
    jerr = jc.init(jax.tree_util.tree_map(jnp.asarray, grads[0]))
    terr = tc.init(flatten_paths(bridge.to_torch(grads[0], device=CPU)))
    for g in grads:
        jg, jerr = jc.compress(jax.tree_util.tree_map(jnp.asarray, g), jerr)
        tg, terr = tc.compress(flatten_paths(bridge.to_torch(g, device=CPU)), terr)
        for tree_j, tree_t in ((jg, tg), (jerr, terr)):
            want = flatten_paths(jax.tree_util.tree_map(np.asarray, tree_j))
            got = flatten_paths(bridge.to_numpy(tree_t))
            assert sorted(want) == sorted(got)
            for k in want:
                assert want[k].dtype == got[k].dtype, k
                np.testing.assert_array_equal(got[k].view(np.uint8), want[k].view(np.uint8),
                                              err_msg=k)


# ---------------------------------------------------------------------------
# Trainer against the JAX package's
# ---------------------------------------------------------------------------


def _run_jax(host_params, microbatches, compress):
    tr = JTrainer(lambda p, b: JT.loss_fn(JCFG, p, b), JAdamW(lr=1e-3),
                  microbatches=microbatches, compress_grads=compress)
    return tr.fit(jax.tree_util.tree_map(jnp.asarray, host_params),
                  iter(JLMStream(128, 4, 16)), STEPS, log_every=1)


def _run_port(host_params, microbatches, compress, **kw):
    tr = Trainer(lambda p, b: TT.loss_fn(TCFG, p, b), AdamW(lr=1e-3),
                 microbatches=microbatches, compress_grads=compress, **kw)
    return tr.fit(bridge.to_torch(host_params, device=CPU),
                  iter(LMStream(128, 4, 16, device=CPU)), STEPS, log_every=1)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_trainer_matches_jax_trainer(host_params, microbatches, compress):
    jout = _run_jax(host_params, microbatches, compress)
    tout = _run_port(host_params, microbatches, compress)
    assert [h["step"] for h in tout["history"]] == list(range(STEPS))
    gtol = 1e-4 if compress else 1e-5
    for jh, th in zip(jout["history"], tout["history"]):
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(th["grad_norm"], jh["grad_norm"], rtol=gtol, atol=0)
    assert int(jout["state"]["step"]) == tout["state"]["step"] == STEPS
    want, got = _np(jout["state"]["params"]), _tnp(flatten_paths(tout["state"]["params"]))
    assert sorted(want) == sorted(got)
    ptol = 1e-4 if compress else 1e-5
    beyond = sum(int((np.abs(got[k] - want[k]) > 1e-5).sum()) for k in want)
    assert beyond <= 0.01 * sum(v.size for v in want.values()), beyond
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ptol, err_msg=k)
    jopt, topt = jout["state"]["opt"], tout["state"]["opt"]
    assert topt.step == int(jopt.step) == STEPS
    for moment in ("mu", "nu"):
        jm, tm = _np(getattr(jopt, moment)), _tnp(getattr(topt, moment))
        assert sorted(jm) == sorted(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=0, atol=ptol, err_msg=f"{moment} {k}")
    if compress:
        jerr, terr = _np(jout["state"]["err"]), _tnp(tout["state"]["err"])
        assert sorted(jerr) == sorted(terr)
        # a flipped rounding moves that element's carried error by a quantum
        beyond = sum(int((np.abs(terr[k] - jerr[k]) > 1e-5).sum()) for k in jerr)
        assert beyond <= 0.02 * sum(v.size for v in jerr.values()), beyond
    else:
        assert "err" not in tout["state"]


def test_microbatches_sum_to_the_whole_batch(host_params):
    """Two microbatches of the mean loss give the whole batch's gradient
    (equal-size halves), up to float32 summation order."""
    params = bridge.to_torch(host_params, device=CPU)
    batch = LMStream(128, 4, 16, device=CPU).batch_at(0)
    loss_fn = lambda p, b: TT.loss_fn(TCFG, p, b)  # noqa: E731
    outs = [make_train_step(loss_fn, AdamW(lr=1e-3), microbatches=m)(
        init_state(params, AdamW()), batch) for m in (1, 2)]
    torch.testing.assert_close(outs[1][1]["loss"], outs[0][1]["loss"], rtol=0, atol=1e-6)
    torch.testing.assert_close(outs[1][1]["grad_norm"], outs[0][1]["grad_norm"],
                               rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="microbatches 3"):
        _split_microbatches(batch, 3)


def test_trainer_with_rules_on_a_repeated_cpu_mesh_equals_no_rules(host_params):
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    rules = LogicalRules(mesh, {"batch": "data", "embed_fsdp": "data", "tensor": "model",
                                "vocab": "model", "layers": None})
    plain = _run_port(host_params, 2, True)
    ruled = _run_port(host_params, 2, True, rules=rules)
    assert ruled["history"] == plain["history"]
    for tree in ("params", "err"):
        a, b = flatten_paths(plain["state"][tree]), flatten_paths(ruled["state"][tree])
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_sharded_iter_and_reshard_tree_place_on_the_mesh(host_params):
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = LogicalRules(mesh, {"batch": "data", "embed_fsdp": "data", "tensor": "model"})
    stream = LMStream(128, 4, 16, device=CPU)
    b = next(sharded_iter(iter(stream), rules))
    assert {k: s.spec for k, s in batch_shardings(b, rules).items()} == \
        {"tokens": ("data", None), "labels": ("data", None)}
    assert all(torch.equal(b[k], stream.batch_at(0)[k]) for k in b)
    assert next(sharded_iter(iter(stream))).keys() == b.keys()
    placed = reshard_tree(host_params, rules)
    for k, v in flatten_paths(placed).items():
        assert isinstance(v, torch.Tensor) and v.device == CPU
        np.testing.assert_array_equal(v.numpy(), flatten_paths(host_params)[k])
    # empty subtrees (non-parametric norms) keep their place
    assert flatten_paths(placed).keys() == flatten_paths(host_params).keys()
