"""The port's ``EdgeExecutor`` (the time/space-sharing baseline) against the
JAX package's, on the same stores (bridged params), the same requests and
the same injected clock.

The clock is a fake that advances a fixed step on every call, so both
executors see the same times as long as they read it at the same points:
statistics (skips, SLA, scheduler loads, loaded bytes, evictions) and the
completion order must then be EQUAL.  Served rows are held to 1e-4 (XLA
and PyTorch sum the same float32 products in different orders, see
test_torch_models.py); greedy decode tokens must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode import _cfgs as dense_cfgs
from test_torch_recurrent import _cfgs as recurrent_cfgs
from test_torch_recurrent import _jax_params
from test_torch_serving import _family, _trunk_groups

from repro.core import ParamStore as JaxStore
from repro.core import enumerate_groups as jax_enumerate_groups
from repro.models import transformer as JT
from repro.models.registry import get_adapter as jax_get_adapter
from repro.serving import decode as JD
from repro.serving.costs import costs_for as jax_costs_for
from repro.serving.executor import EdgeExecutor as JaxEdgeExecutor
from repro.serving.executor import ModelProgram as JaxProgram
from repro.serving.executor import Request as JaxRequest
from repro.serving.workload import instances_from_store as jax_instances
from repro_torch import bridge
from repro_torch.core import ParamStore, enumerate_groups
from repro_torch.models.registry import get_adapter
from repro_torch.serving import decode as TD
from repro_torch.serving.costs import costs_for
from repro_torch.serving.executor import EdgeExecutor, ModelProgram, Request, base_model_id
from repro_torch.serving.workload import instances_from_store

XTOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
TIME_KEYS = ("elapsed_s", "tokens_per_s")


class FakeClock:
    """Advances ``step`` seconds on every read."""

    def __init__(self, step: float = 1e-3):
        self.t, self.step = 0.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def _stores(name, mids):
    """Both packages' stores over the same params: the JAX adapter's shapes
    and dtypes (``jax.eval_shape``, nothing compiled), values drawn with
    numpy at an init's scale (1/sqrt(fan-in) for matrices and kernels)."""
    import jax

    from repro.utils.tree import flatten_paths, unflatten_paths

    jadapter, _, jcfg, _ = _family(name)
    shapes = flatten_paths(jax.eval_shape(lambda key: jadapter.init(jcfg, key),
                                          jax.random.PRNGKey(0)))
    rng = np.random.default_rng(6)
    zoo = {}
    for m in mids:
        flat = {}
        for p, v in sorted(shapes.items()):
            scale = 0.1 if len(v.shape) < 2 else 1.0 / np.sqrt(np.prod(v.shape[:-1]))
            flat[p] = (scale * rng.standard_normal(v.shape)).astype(v.dtype)
        zoo[m] = unflatten_paths(flat)
    return (JaxStore.from_models({m: jax.tree_util.tree_map(jnp.asarray, p)
                                  for m, p in zoo.items()}),
            ParamStore.from_models({m: bridge.to_torch(p, device=CPU) for m, p in zoo.items()}))


def _executors(jadapter, tadapter, jcfg, tcfg, js, ts, mids, capacity, buckets=(1, 2, 4, 8)):
    common = dict(capacity_bytes=capacity, simulate_dma=False, buckets=buckets)
    jex = JaxEdgeExecutor(js, jax_instances(js, "tiny-yolo", model_ids=list(mids)),
                          {m: jadapter.bound_forward(jcfg) for m in mids},
                          costs={"tiny-yolo": jax_costs_for("tiny-yolo")}, clock=FakeClock(),
                          **common)
    tex = EdgeExecutor(ts, instances_from_store(ts, "tiny-yolo", model_ids=list(mids)),
                       {m: tadapter.bound_forward(tcfg) for m in mids},
                       costs={"tiny-yolo": costs_for("tiny-yolo")}, clock=FakeClock(), **common)
    return jex, tex


def _payload_pair(name, cfg, rng):
    if name == "small_cnn":
        p = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
        return jnp.asarray(p), torch.from_numpy(p)
    p = rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
    return jnp.asarray(p), torch.from_numpy(p.astype(np.int64))


CASES = {  # name -> (batch, deadline of request i in seconds)
    "small_cnn": (1, lambda i: 30.0 + i * 1e-3),
    "small_cnn-batch4": (4, lambda i: 30.0 + i * 1e-3),
    "dense": (2, lambda i: 30.0 + i * 1e-3),
    "small_cnn-expiring": (2, lambda i: 0.012 + i * 1e-3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_serve_equals_the_reference(case):
    """Members A and B share their merged trunk, C and D stay private; the
    capacity holds one member and a half besides the activation, so the
    round robin swaps and evicts.  In the expiring case deadlines are a few
    clock ticks apart and most requests are dropped before their turn."""
    name = case.split("-")[0]
    batch, deadline = CASES[case]
    jadapter, tadapter, jcfg, tcfg = _family(name)
    mids = ("A", "B", "C", "D")
    js, ts = _stores(name, mids)
    for jg, tg in zip(_trunk_groups(jadapter, jcfg, js, ("A", "B"), jax_enumerate_groups),
                      _trunk_groups(tadapter, tcfg, ts, ("A", "B"), enumerate_groups)):
        js.merge_group(jg)
        ts.merge_group(tg)
    act = int(costs_for("tiny-yolo").activation_gb(batch) * 1e9)
    capacity = act + int(1.5 * ts.model_bytes("C"))
    jex, tex = _executors(jadapter, tadapter, jcfg, tcfg, js, ts, mids, capacity)
    rng = np.random.default_rng(4)
    order = [mids[(5 * i) % 4] for i in range(14)]
    for i, m in enumerate(order):
        jp, tp = _payload_pair(name, jcfg, rng)
        jex.submit(JaxRequest(m, jp, 0.0, deadline(i), meta=i))
        tex.submit(Request(m, tp, 0.0, deadline(i), meta=i))
    warm = _payload_pair(name, jcfg, rng)
    jstats = jex.serve(horizon_s=60.0, batch=batch, warmup=warm[0], drain=True)
    tstats = tex.serve(horizon_s=60.0, batch=batch, warmup=warm[1], drain=True)
    assert tstats == jstats
    assert tex.scheduler.stats == jex.scheduler.stats
    assert [i.instance_id for i in tex.scheduler.order] == \
        [i.instance_id for i in jex.scheduler.order]
    assert [(c.request.meta, c.finished_s) for c in tex.completions] == \
        [(c.request.meta, c.finished_s) for c in jex.completions]
    assert tstats["completed"] + tstats["skipped"] == len(order)
    assert tex.scheduler.stats["evictions"] > 0
    if case.endswith("expiring"):
        assert 0 < tstats["dropped_expired"] == tstats["skipped"] < len(order)
    else:
        assert tstats["completed"] == len(order) and tstats["sla_fraction"] == 1.0
    for jc, tc in zip(jex.completions, tex.completions):
        np.testing.assert_allclose(bridge.tensor_to_array(tc.result), np.asarray(jc.result),
                                   **XTOL)


def test_base_model_id_strips_the_feed_suffix():
    assert base_model_id("r50#3") == "r50" and base_model_id("lm-A") == "lm-A"


# ---------------------------------------------------------------------------
# serve_decode: the per-request decode baseline lane
# ---------------------------------------------------------------------------


def _decode_family(family):
    """(JAX adapter, port adapter, JAX cfg, port cfg, JAX params by member)
    at the smoke configs, three members from their own seeds."""
    mids = ("A", "B", "C")
    if family == "dense":
        jcfg, tcfg = dense_cfgs()
        import jax

        jparams = {m: JT.init(jcfg, jax.random.PRNGKey(i)) for i, m in enumerate(mids)}
    else:
        jcfg, tcfg = recurrent_cfgs(family, "smoke")
        jparams = {m: _jax_params(family, "smoke", i) for i, m in enumerate(mids)}
    return jax_get_adapter(family), get_adapter(family), jcfg, tcfg, jparams


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_serve_decode_equals_the_reference(family):
    """Six requests over three unmerged members, EDF order unlike arrival
    order: equal tokens, equal step/token counts and scheduler loads, and
    the reference's structure — one chunked prompt step, then one step per
    further token (tests/test_decode.py)."""
    jadapter, tadapter, jcfg, tcfg, jparams = _decode_family(family)
    mids = tuple(jparams)
    js = JaxStore.from_models(jparams)
    ts = ParamStore.from_models({m: bridge.to_torch(p, device=CPU) for m, p in jparams.items()})
    capacity = int(costs_for("tiny-yolo").activation_gb(1) * 1e9) + int(1.5 * ts.model_bytes("A"))
    jex, tex = _executors(jadapter, tadapter, jcfg, tcfg, js, ts, mids, capacity)
    rng = np.random.default_rng(9)
    prompt_len, max_new = 4, 5
    prompts = [rng.integers(0, jcfg.vocab_size, prompt_len).astype(np.int32) for _ in range(6)]
    deadlines = [10.0 + d for d in (5, 1, 4, 0, 3, 2)]
    jreqs = [JD.DecodeRequest(mids[i % 3], prompts[i], max_new, deadline_s=deadlines[i], meta=i)
             for i in range(6)]
    treqs = [TD.DecodeRequest(mids[i % 3], prompts[i], max_new, deadline_s=deadlines[i], meta=i)
             for i in range(6)]
    jstats = jex.serve_decode(jreqs, [JaxProgram.from_adapter(jadapter, m, cfg=jcfg)
                                      for m in mids], max_len=16)
    tstats = tex.serve_decode(treqs, [ModelProgram.from_adapter(tadapter, m, cfg=tcfg)
                                      for m in mids], max_len=16)
    assert {k: v for k, v in tstats.items() if k not in TIME_KEYS} == \
        {k: v for k, v in jstats.items() if k not in TIME_KEYS}
    assert tstats["completed"] == 6
    assert tstats["steps"] == tstats["tokens_decoded"] == 6 * max_new
    assert tstats["prompt_tokens"] == 6 * prompt_len and tstats["tokens_per_s"] > 0
    assert [c.request.meta for c in tex.decode_completions] == [3, 1, 5, 4, 2, 0]
    assert [(c.request.meta, c.tokens, c.finished_s) for c in tex.decode_completions] == \
        [(c.request.meta, c.tokens, c.finished_s) for c in jex.decode_completions]
    assert all(len(c.tokens) == max_new and all(isinstance(t, int) for t in c.tokens)
               for c in tex.decode_completions)
    assert tex.scheduler.stats == jex.scheduler.stats
    assert tex.scheduler.stats["evictions"] > 0
    # the first token is the argmax of the member's own forward at the
    # prompt's last position
    for c in tex.decode_completions:
        logits = tadapter.forward(tcfg, ts.materialize(c.request.instance_id),
                                  torch.from_numpy(c.request.prompt.astype(np.int64))[None])
        assert c.tokens[0] == int(logits[0, -1].argmax())


def test_serve_decode_refuses_a_program_without_a_decode_surface():
    jadapter, tadapter, jcfg, tcfg = _family("small_cnn")
    _, ts = _stores("small_cnn", ("A",))
    tex = EdgeExecutor(ts, instances_from_store(ts, "tiny-yolo"),
                       {"A": tadapter.bound_forward(tcfg)}, capacity_bytes=10 ** 9,
                       costs={"tiny-yolo": costs_for("tiny-yolo")}, simulate_dma=False)
    req = TD.DecodeRequest("A", np.zeros(3, np.int32), 2)
    with pytest.raises(ValueError):
        tex.serve_decode([req], [ModelProgram.from_adapter(tadapter, "A", cfg=tcfg)])
