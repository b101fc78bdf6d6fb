"""The port's LM bench ports (``repro_torch.bench.lm_merging``,
``decode_serve``, ``serve_throughput``, ``plan_search``) against the JAX
package's benches on the JAX benches' own draws.

Each scenario is the JAX bench's: its zoo, calibration batch, request
tokens, decode prompts and frames are drawn by the JAX code and handed to
the port as numpy (``bridge``).  Both packages' planners get a counting
clock (through the bench modules' ``StagedPlanner`` name), so the plans'
provenance, and with it the plan JSON, is equal byte for byte.  Nothing here
writes an artifact: the JAX benches' ``emit`` is replaced by a function that
returns what it was given.

Equal exactly: every count and identity of ``derived`` (plan bytes,
committed / cross-variant / shared keys, memory saved, dispatches,
micro-batches, bank hits, group steps, per-group-step dispatch ratios, pool
high water, max active, the swap fields, attempts, fraction saved,
simulator accuracy, the round-trip fields) and the plans' JSON.  Within
rtol = atol = 1e-5 (float32; XLA and torch sum in other orders): decode
logits, and served rows after dividing both by the row's largest
magnitude (the perturbed heads put logits near 12, where float32 sums in
another order land 1e-5 apart).  Not compared: times and their ratios.

The structural gates of ``scripts/ci.sh`` (S2 and D1) are asserted on the
CPU runs; D1's replay is held at the stated 1e-5 instead of bitwise
(torch's CPU GEMMs give a row other bits at another batch size).
"""
import dataclasses
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.serving.decode as jax_decode
from repro.models import griffin as JG
from repro.models import transformer as JT
from repro.models.registry import get_adapter as jax_get_adapter
from repro_torch import bridge
from repro_torch.bench import decode_serve as TDS
from repro_torch.bench import lm_merging as TLM
from repro_torch.bench import plan_search as TPS
from repro_torch.bench import serve_throughput as TST
from repro_torch.models import griffin as TG
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_adapter

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from benchmarks import decode_serve as DS  # noqa: E402
from benchmarks import lm_merging as LM  # noqa: E402
from benchmarks import plan_search as PS  # noqa: E402
from benchmarks import serve_throughput as ST  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
JaxStagedPlanner = jax_core.StagedPlanner


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


def _no_emit(name, rows, derived=None, quiet=False):
    return {"name": name, "rows": rows, "derived": derived or {}}


@pytest.fixture(scope="module")
def jax_planners():
    """The JAX package's ``StagedPlanner`` (as the benches import it) on a
    counting clock, with every ``PlanResult`` recorded."""
    results = []

    def planner(*a, **kw):
        p = JaxStagedPlanner(*a, clock=Ticks(), **kw)
        run = p.run

        def recorded():
            res = run()
            results.append(res)
            return res

        p.run = recorded
        return p

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_core, "StagedPlanner", planner)
    for mod in (LM, DS, ST, PS):
        mp.setattr(mod, "emit", _no_emit)
    yield results
    mp.undo()


# ---------------------------------------------------------------------------
# lm_merging: the S2 scenario
# ---------------------------------------------------------------------------


def _lm_scenario(bf16: bool = False) -> TLM.LMScenario:
    """The JAX LM bench's draws as a port scenario: the zoo, the
    calibration batch (PRNGKey(7)), the request tokens and the decode
    prompts (``decode_serve``'s PRNGKey(1000 + 13 i + j)).  ``bf16``
    draws the zoo at the tiny config in bfloat16 in both packages."""
    jadapter = jax_get_adapter("dense")
    jcfg = jadapter.default_config()
    adapter = get_adapter("dense")
    cfg = adapter.default_config()
    if bf16:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
    zoo = LM.lm_zoo(jadapter, jcfg)
    cal = jadapter.calibration_batch(jcfg, jax.random.PRNGKey(7), 32)
    payloads = [_np(r.payload) for r in LM.lm_requests(jcfg, LM.MIDS)]

    def prompt(i, j, n):
        return _np(jax.random.randint(jax.random.PRNGKey(1000 + 13 * i + j), (n,), 0,
                                      jcfg.vocab_size)).astype(np.int32)

    return TLM.LMScenario(
        adapter, cfg, {m: bridge.to_torch(p, device=CPU) for m, p in zoo.items()},
        {k: _t(v) for k, v in cal.items()},
        payload=lambda i, j: _t(payloads[i * LM.REQS_PER_MODEL + j]),
        prompt=prompt, planner_clock=Ticks)


@pytest.fixture(scope="module")
def lm_serve(jax_planners):
    """Both packages' merge-and-serve, and the plans' JSON."""
    n0 = len(jax_planners)
    jrows, jderived = LM.merge_and_serve()
    jplan = jax_planners[n0].plan.to_json()
    scn = _lm_scenario()
    res, _ = TLM.plan_variants(scn)
    engines = {}
    rows, derived = TLM.merge_and_serve(scn, on_lane=lambda n, e, s: engines.setdefault(n, e))
    return dict(jrows=jrows, jderived=jderived, jplan=jplan, rows=rows, derived=derived,
                plan=res.plan.to_json(), scn=scn, engines=engines)


LM_EXACT = ("plan_bytes", "committed_groups", "cross_variant_groups", "retrain_attempts",
            "pruned_prefilter", "memory_saved_bytes", "memory_saved_pct", "shared_keys",
            "epoch_bumps", "prefix_jits", "outputs_bitwise_identical", "suffix_dispatches",
            "suffix_dispatches_nobank", "shared_microbatches", "bank_hits", "trainer")


def test_lm_serve_counts_and_plan_are_equal(lm_serve):
    jd, d = lm_serve["jderived"], lm_serve["derived"]
    assert set(jd) <= set(d)
    assert {k: d[k] for k in LM_EXACT} == {k: jd[k] for k in LM_EXACT}
    assert lm_serve["plan"] == lm_serve["jplan"]
    keys = ("path", "resident_bytes", "completed", "prefix_runs", "suffix_dispatches",
            "sla_fraction")
    assert [{k: r[k] for k in keys} for r in lm_serve["rows"]] == \
        [{k: r[k] for k in keys} for r in lm_serve["jrows"]]


def test_lm_serve_meets_the_suffix_bank_gates(lm_serve):
    """``scripts/ci.sh``'s S2 gates on the port's CPU run (the timed
    ``bank_speedup_rps`` is printed, not held, on a shared CPU), and the
    bench's own check; every banked row equals the member's own suffix."""
    d = lm_serve["derived"]
    g = TLM.gates(d)
    assert all(g.values()) and set(TLM.timed_gates(d)) == {"bank_speedup_rps >= 1.5"}, g
    assert d["cross_variant_groups"] >= 1 and d["memory_saved_bytes"] > 0
    assert d["suffix_dispatches"] == d["shared_microbatches"] < d["suffix_dispatches_nobank"]
    assert d["bank_gap"] == 0.0


def test_lm_serve_rows_match_the_reference_engine(lm_serve):
    """The bank lane's served rows against the JAX engine's on the same
    plan and trace, within 1e-5 of each row's largest magnitude."""
    jadapter = jax_get_adapter("dense")
    jcfg = jadapter.default_config()
    jeng = LM.lm_engine(jax_core.ParamStore.from_models(LM.lm_zoo(jadapter, jcfg)), jadapter,
                        jcfg, LM.MIDS)
    jeng.apply_plan(jax_core.MergePlan.from_json(lm_serve["jplan"]))
    reqs = LM.lm_requests(jcfg, LM.MIDS)
    for r in reqs:
        jeng.submit(r)
    jeng.serve(horizon_s=60.0, warmup=reqs[0].payload)
    want = {(c.request.instance_id, c.request.deadline_s): _np(c.result)
            for c in jeng.completions}
    got = {(c.request.instance_id, c.request.deadline_s): c.result.numpy()
           for c in lm_serve["engines"]["merged-plan-bank"].completions}
    assert sorted(got) == sorted(want) and len(got) == len(reqs)
    for k in want:  # rows scaled by their largest magnitude (logits reach ~12)
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k] / scale, want[k] / scale, **TOL)


def test_lm_retrain_plans_on_the_cpu(lm_serve):
    """``--retrain``: the joint ``MergeTrainer`` (two epochs, target 0.0)
    commits every trunk group the surrogate does."""
    res, _ = TLM.plan_variants(lm_serve["scn"], retrain=True)
    assert res.committed == lm_serve["derived"]["committed_groups"] > 0


# ---------------------------------------------------------------------------
# decode_serve: the D1 scenario at the smoke sizes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def decode_lanes(jax_planners):
    """Both packages' three lanes at the smoke sizes, and the completions
    of each one's logits-recording pass."""
    jverify, verify = [], []
    check = jax_decode.verify_bitwise

    def recording_check(dec, *a, **kw):
        jverify.extend(dec.completions)
        return check(dec, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_decode, "verify_bitwise", recording_check)
        jrows, jderived = DS.run_lanes(n_per_model=2, max_new=4)

    def on_lane(name, lane, stats):
        if name == "verify":
            verify.extend(lane.last_decoder.completions)

    rows, derived = TDS.run_lanes(_lm_scenario(), 2, 4, on_lane=on_lane)
    return dict(jrows=jrows, jderived=jderived, rows=rows, derived=derived,
                jverify=jverify, verify=verify)


DECODE_EXACT = ("plan_epoch_bumps", "group_steps", "trunk_dispatch_per_group_step",
                "bank_dispatch_per_group_step", "head_dispatches", "lost_in_flight",
                "pool_identity_ok", "pool_high_water_pages", "max_active", "swap_epoch_bumps",
                "swap_in_flight_at_swap", "swap_survivors", "swap_lost_in_flight",
                "swap_completed", "swap_trunk_dispatches", "swap_bank_dispatches", "requests")


def test_decode_lanes_counts_are_equal(decode_lanes):
    jd, d = decode_lanes["jderived"], decode_lanes["derived"]
    assert set(jd) <= set(d)
    assert {k: d[k] for k in DECODE_EXACT} == {k: jd[k] for k in DECODE_EXACT}
    keys = ("lane", "tokens_decoded", "steps", "completed")
    assert [{k: r[k] for k in keys} for r in decode_lanes["rows"]] == \
        [{k: r[k] for k in keys} for r in decode_lanes["jrows"]]


def test_decode_lanes_meet_the_streaming_decode_gates(decode_lanes):
    """``scripts/ci.sh``'s D1 gates (the smoke trace: no speedup gate), the
    replay within 1e-5 of the unpaged decode instead of bitwise."""
    d = decode_lanes["derived"]
    assert all(TDS.gates(d, smoke=True).values()), TDS.gates(d, smoke=True)
    assert d["replay_tol"] == 1e-5 and d["replay_confident_argmax_mismatches"] == 0
    assert decode_lanes["jderived"]["outputs_bitwise_identical"]


def test_decode_verify_pass_matches_the_reference(decode_lanes):
    """The logits-recording pass: the same requests complete in the same
    order with the same tokens, every logits row within 1e-5 of the JAX
    decoder's."""
    got, want = decode_lanes["verify"], decode_lanes["jverify"]
    assert len(got) == len(want) == 10
    for c, jc in zip(got, want):
        assert c.request.instance_id == jc.request.instance_id
        assert list(c.request.prompt) == list(np.asarray(jc.request.prompt))
        assert c.tokens == jc.tokens
        for row, jrow in zip(c.logits, jc.logits):
            np.testing.assert_allclose(row, np.asarray(jrow), **TOL)


# ---------------------------------------------------------------------------
# serve_throughput and plan_search: host-level benches
# ---------------------------------------------------------------------------


SERVE_EXACT = ("cache_hit_rate", "cache_verified", "binding_epochs", "materializations",
               "prefix_runs", "suffix_runs", "suffix_dispatches", "bank_hits", "microbatches",
               "n_requests", "suffix_runs_nobank", "suffix_dispatches_nobank",
               "bank_dispatch_per_microbatch", "sla_no_worse")


def test_serve_throughput_counts_are_equal(jax_planners):
    """24 requests with the nobank lane: every count, the materialisations
    by model and bank, and the ``scripts/ci.sh`` bank gates."""
    jadapter = jax_get_adapter("small_cnn")
    jcfg = jadapter.default_config()
    inp = TST.ServeInputs(
        {m: bridge.to_torch(jadapter.init(jcfg, jax.random.PRNGKey(i)), device=CPU)
         for i, m in enumerate(TST.ORDER)}, _t(ST._frame()))
    jout = ST.run(n_requests=24, suffix_bank_lane=True, quiet=True)
    rows, d = TST.evaluate(inp, n_requests=24)
    jd = jout["derived"]
    assert set(jd) <= set(d)
    assert {k: d[k] for k in SERVE_EXACT} == {k: jd[k] for k in SERVE_EXACT}
    assert [(r["path"], r["completed"], r["sla_fraction"]) for r in rows] == \
        [(r["path"], r["completed"], r["sla_fraction"]) for r in jout["rows"]]
    assert all(TST.gates(d).values())


def test_plan_search_counts_and_plans_are_equal(jax_planners):
    """Both planners' attempts, commits, discards, prunes, fraction saved
    and simulated accuracy, the round trip, and both plans' JSON."""
    jadapter = jax_get_adapter("small_cnn")
    jcfg = jadapter.default_config()
    jzoo = PS._zoo(jcfg)
    inp = TPS.PlanInputs(
        {m: bridge.to_torch(jzoo[m], device=CPU) for m in TPS.ORDER},
        {"images": _t(jadapter.calibration_batch(jcfg, jax.random.PRNGKey(7), 32)["images"])},
        _t(jax.random.normal(jax.random.PRNGKey(3), (2, 32, 32, 3))), planner_clock=Ticks)
    n0 = len(jax_planners)
    jout = PS.run(quiet=True)
    jplans = [r.plan.to_json() for r in jax_planners[n0:]]
    rows, d, plans = TPS.evaluate(inp)
    jd = jout["derived"]
    assert d == jd
    drop = lambda r: {k: v for k, v in r.items() if k != "wall_s"}  # noqa: E731
    assert [drop(r) for r in rows] == [drop(r) for r in jout["rows"]]
    assert [plans["memory-forward"].plan.to_json(), plans["similarity"].plan.to_json()] == jplans
    assert all(TPS.gates(d).values())


# ---------------------------------------------------------------------------
# the unpaged caches' length on the device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_unpaged_length_is_a_device_tensor_and_logits_match(family):
    """``init_cache``'s ``length`` is a 0-d int32 tensor, advanced in place
    by ``decode_step``; a 5-token prompt then single tokens past the
    griffin window give the JAX package's logits (1e-5) and lengths."""
    jmod, tmod = {"dense": (JT, TT), "hybrid": (JG, TG)}[family]
    jadapter, adapter = jax_get_adapter(family), get_adapter(family)
    jcfg, cfg = jadapter.default_config(), adapter.default_config()
    jp = jadapter.init(jcfg, jax.random.PRNGKey(0))
    tp = bridge.to_torch(jp, device=CPU)
    n = 5 + (getattr(cfg, "window", None) or 4) + 3
    max_len = -(-n // 8) * 8
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, n)).astype(np.int32)
    jc = jmod.init_cache(jcfg, 2, max_len)
    tc = tmod.init_cache(cfg, 2, max_len, device=CPU)
    length = tc["length"]
    assert isinstance(length, torch.Tensor) and length.dim() == 0
    assert length.dtype == torch.int32 and int(length) == 0
    jstep = jax.jit(functools.partial(jmod.decode_step, jcfg))
    for lo, hi in [(0, 5)] + [(i, i + 1) for i in range(5, n)]:
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, lo:hi]))
        tl, tc = tmod.decode_step(cfg, tp, tc, _t(toks[:, lo:hi]))
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
        assert tc["length"] is length and int(length) == int(jc["length"]) == hi
