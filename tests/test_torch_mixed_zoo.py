"""GEMEL across model families: the ssm and hybrid calibration tiers, the
family-aware prefilter (``core.policy``) and the mixed-family zoo bench
(``repro_torch.bench.mixed_zoo``) against the JAX package's.

The zoo runs on the JAX bench's own draws (``benchmarks/mixed_zoo.py``:
its members bridged, its calibration batch, request payloads and decode
prompts handed over as numpy), both planners on one counting clock.

Tolerances:
  * decisions (mergeability, family filtering, plan JSON, every derived
    count) exactly equal;
  * CKA similarities 1e-6 (float64 Grams of activations that agree to
    float32 rounding);
  * activations, logits and losses 1e-4 (XLA and PyTorch reduce float32 in
    different orders, compounding through the layers);
  * served rows against the JAX engine's 1e-5 after dividing both by the
    row's largest magnitude (the heads' N(0, 1) perturbation puts logits
    near 16, where float32 orderings through three layers and the softcap
    differ by 2e-5), as the port's CPU decode replay; inside the port, served
    rows against a replay of the engine's dispatch and decode against the
    unpaged replay bitwise.  (The JAX engine's own decode is not bitwise
    against its unpaged replay on this CPU: its banked heads differ from
    the per-member heads by a few ulps, so its ``decode_outputs_bitwise``
    reads False here; it is not compared.)
"""
import dataclasses
import itertools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.core.policy as JPOL
from repro.configs import olmo_1b as jax_olmo
from repro.core.signatures import LayerRecord as JRecord
from repro.models import transformer as JT
from repro.models.registry import get_adapter as jax_get_adapter
from repro_torch import bridge
from repro_torch.bench import mixed_zoo as TMZ
from repro_torch.configs import olmo_1b
from repro_torch.core import MergePlan, ParamStore, enumerate_groups
from repro_torch.core import policy as TPOL
from repro_torch.core.signatures import LayerRecord as TRecord
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_adapter
from repro_torch.utils.tree import flatten_paths

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from benchmarks import mixed_zoo as MZ  # noqa: E402
from test_torch_lm_bench import Ticks  # noqa: E402

XTOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")


def _np(t):
    return np.asarray(bridge.tensor_to_array(t), np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the calibration tiers of ssm and hybrid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_layer_activations_and_loss_match_reference(family):
    ja, ta = jax_get_adapter(family), get_adapter(family)
    jcfg, tcfg = ja.default_config(), ta.default_config()
    assert ta.can_calibrate
    jp = jax.jit(ja.init, static_argnums=0)(jcfg, jax.random.PRNGKey(3))
    tp = bridge.to_torch(jp, device=CPU)
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (3, 9)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": _t(toks[:, :-1]), "labels": _t(toks[:, 1:])}
    jacts, tacts = ja.layer_activations(jcfg, jp, jb), ta.layer_activations(tcfg, tp, tb)
    assert sorted(tacts) == sorted(jacts)
    assert {"embed", "final_norm", "lm_head"} <= set(tacts)
    for k in jacts:
        assert tacts[k].dtype == np.float32
        np.testing.assert_allclose(tacts[k], np.asarray(jacts[k], np.float32), **XTOL, err_msg=k)
    np.testing.assert_allclose(float(ta.loss(tcfg, tp, tb)), float(ja.loss(jcfg, jp, jb)),
                               **XTOL)
    # every trunk record maps onto a probe (what the scorer keys on)
    trunk = ta.split(tcfg).prefix_paths
    keys = {TPOL.default_layer_key(r.path) for r in ta.records(tcfg, tp, "m")
            if r.path in trunk}
    assert keys <= set(tacts)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_the_calibration_taps_leave_forward_unchanged(family):
    adapter = get_adapter(family)
    cfg = adapter.default_config()
    params = adapter.init(cfg, seed=5, device=CPU)
    toks = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(6))
    mod = adapter.module
    taps: dict = {}
    tapped = mod.head(cfg, params, mod.trunk(cfg, params, toks, taps=taps), taps=taps)
    assert torch.equal(tapped, adapter.forward(cfg, params, toks)) and taps


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_olmo_configs_are_the_reference_widths():
    names = {f.name for f in dataclasses.fields(TT.DenseLMConfig)} - {"dtype"}
    for name in ("full_config", "smoke_config"):
        j, t = getattr(jax_olmo, name)(), getattr(olmo_1b, name)()
        assert {n: getattr(t, n) for n in names} == {n: getattr(j, n) for n in names}
        assert t.dtype == jnp.dtype(j.dtype).name


def test_olmo_smoke_forward_matches_the_reference_direct_forward():
    """olmo's non-parametric LayerNorm: held to the JAX package's direct
    ``transformer.forward`` on the nested params (its ParamStore cannot
    serve a norm without leaves)."""
    jcfg = dataclasses.replace(jax_olmo.smoke_config(), scan_layers=False)
    tcfg = olmo_1b.smoke_config()
    jp = jax.jit(JT.init, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    tp = bridge.to_torch(jp, device=CPU)
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    want = JT.forward(jcfg, jp, jnp.asarray(toks))
    np.testing.assert_allclose(_np(get_adapter("dense").forward(tcfg, tp, _t(toks))),
                               np.asarray(want), **XTOL)


# ---------------------------------------------------------------------------
# the family-aware prefilter
# ---------------------------------------------------------------------------

FAMS = ["dense", "moe", "ssm", "hybrid", None]


@pytest.mark.parametrize("a,b", list(itertools.product(FAMS, FAMS)))
def test_trunk_mergeable_equals_the_reference(a, b):
    assert TPOL.trunk_mergeable(a, b) == JPOL.trunk_mergeable(a, b)


@pytest.mark.parametrize("path", ["embed/table", "final_norm/scale", "lm_head/w",
                                  "blocks/0/attn/wq", "blocks/1/mixer/in_proj/w",
                                  "repeats/0/2_attn/attn/wo", "embedding/x", "lm_head"])
def test_is_interface_path_equals_the_reference(path):
    assert TPOL.is_interface_path(path) == JPOL.is_interface_path(path)


def _column(cls, spec):
    """Records of one column: (model_id, path) pairs of one signature."""
    return [cls(m, p, ("sig",), 64, 0.5) for m, p in spec]


FAMILY_OF = {"d1": "dense", "d2": "dense", "m1": "moe", "s1": "ssm", "s2": "ssm",
             "h1": "hybrid", "u1": None}
COLUMNS = {
    "trunk-dense-moe-ssm": [("s1", "blocks/0/x/w"), ("d1", "blocks/0/x/w"),
                            ("m1", "blocks/0/x/w")],
    "trunk-tie": [("s2", "blocks/0/x/w"), ("h1", "blocks/0/x/w"), ("d2", "blocks/0/x/w"),
                  ("s1", "blocks/0/x/w"), ("d1", "blocks/0/x/w")],
    "trunk-unknown": [("u1", "blocks/0/x/w"), ("s1", "blocks/0/x/w")],
    "interface": [("s1", "embed/table"), ("d1", "embed/table"), ("h1", "embed/table")],
    "mixed-interface": [("s1", "embed/table"), ("d1", "blocks/0/x/w"), ("h1", "embed/table")],
}


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_family_filter_decisions_equal_the_reference(name):
    js = JPOL.RepresentationSimilarityScorer({}, families=FAMILY_OF)
    ts = TPOL.RepresentationSimilarityScorer({}, families=FAMILY_OF)
    want = [r.key for r in js._family_filter(_column(JRecord, COLUMNS[name]))]
    got = [r.key for r in ts._family_filter(_column(TRecord, COLUMNS[name]))]
    assert got == want and ts.pruned_cross_family == js.pruned_cross_family
    # without families every column passes whole
    plain = TPOL.RepresentationSimilarityScorer({})
    assert len(plain._family_filter(_column(TRecord, COLUMNS[name]))) == len(COLUMNS[name])


# ---------------------------------------------------------------------------
# the mixed zoo on the JAX bench's draws
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zoo():
    """Both packages' zoos, the JAX bench's plan JSON and its engine's
    served rows, and the port's scenario on the same draws."""
    mp = pytest.MonkeyPatch()
    planner = jax_core.StagedPlanner
    mp.setattr(jax_core, "StagedPlanner", lambda *a, **kw: planner(*a, clock=Ticks(), **kw))
    jm = MZ.zoo_members()
    jres, _ = MZ.plan_zoo(jm)
    mp.undo()
    jpayload = jres.plan.to_json()
    params_of = {m: p for m, (_, __, p) in jm.items()}
    jstore = jax_core.ParamStore.from_models(params_of)
    jeng = MZ.zoo_engine(jstore, jm)
    jswap = jeng.apply_plan(jax_core.MergePlan.from_json(jpayload))
    jreqs = MZ.zoo_requests(jm, 8)
    for r in jreqs:
        jeng.submit(r)
    jeng.serve(horizon_s=60.0, warmup=jreqs[0].payload)
    jrows = {(c.request.instance_id, c.request.deadline_s): np.asarray(c.result)
             for c in jeng.completions}
    fam_of = {m: a.family for m, (a, _, __) in jm.items()}
    jplan = jax_core.MergePlan.from_json(jpayload)
    want = {
        "families_served": 4, "models": 8, "plan_bytes": len(jpayload),
        "committed_groups": jres.committed,
        "cross_member_groups": sum(any(len(c.members) >= 2 for c in pg.columns)
                                   for pg in jplan.groups),
        "cross_family_groups": sum(any(len({fam_of[r.model_id] for r in c.members}) >= 2
                                       for c in pg.columns) for pg in jplan.groups),
        "memory_saved_bytes": (jax_core.ParamStore.from_models(params_of).resident_bytes()
                               - jstore.resident_bytes()),
        "epoch_bumps": jswap["epoch_bumps"],
    }

    members = {m: (get_adapter(a.name), get_adapter(a.name).default_config(),
                   bridge.to_torch(p, device=CPU)) for m, (a, _, p) in jm.items()}
    a0, c0, _ = next(iter(jm.values()))
    cal = a0.calibration_batch(c0, jax.random.PRNGKey(7), 32)
    payloads = [np.asarray(r.payload) for r in jreqs]
    prompts = {(MZ.FAMILIES.index(r.instance_id.split("-")[0]), "AB".index(r.instance_id[-1])):
               np.asarray(r.prompt, np.int32) for r in MZ.decode_requests(jm)}
    scn = TMZ.ZooScenario(members, {k: _t(v) for k, v in cal.items()},
                          payload=lambda i, j: _t(payloads[i * 8 + j]),
                          prompt=lambda i, j: prompts[(i, j)], planner_clock=Ticks)
    return dict(jm=jm, jpayload=jpayload, jrows=jrows, want=want, scn=scn, cal=cal)


def test_zoo_configs_are_the_reference_defaults(zoo):
    for m, (a, cfg, _) in zoo["scn"].members.items():
        jcfg = zoo["jm"][m][1]
        names = {f.name for f in dataclasses.fields(cfg)} - {"dtype"}
        assert {n: getattr(cfg, n) for n in names} == {n: getattr(jcfg, n) for n in names}
        assert a.family == zoo["jm"][m][0].family


def test_from_adapters_scorer_similarities_equal_the_reference(zoo):
    """The scorer built through the adapters, on every trunk column of the
    zoo: CKA within 1e-6, the same family cuts and the same kept records."""
    jm, scn = zoo["jm"], zoo["scn"]
    js = JPOL.RepresentationSimilarityScorer.from_adapters(jm, zoo["cal"], TMZ.MIN_SIMILARITY)
    ts = TPOL.RepresentationSimilarityScorer.from_adapters(scn.members, scn.calibration,
                                                           TMZ.MIN_SIMILARITY)
    assert ts.families == js.families
    jt = TPOL.CoherenceSurrogateTrainer.from_adapters(scn.members, scn.calibration)
    assert sorted(jt.probe.activations) == sorted(scn.members)
    recs = {}
    for name, members in (("jax", jm), ("torch", scn.members)):
        out = []
        for m, (adapter, cfg, params) in members.items():
            trunk = adapter.split(cfg).prefix_paths
            out += [r for r in adapter.records(cfg, params, m) if r.path in trunk]
        recs[name] = out
    jgroups = jax_core.enumerate_groups(recs["jax"])
    tgroups = enumerate_groups(recs["torch"])
    assert [g.signature for g in tgroups] == [g.signature for g in jgroups]
    n_cols = 0
    for jg, tg in zip(jgroups, tgroups):
        for jcol, tcol in zip(jg.columns(), tg.columns()):
            want, got = js.column_similarities(jcol), ts.column_similarities(tcol)
            assert want.keys() == got.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
            n_cols += 1
    assert n_cols > 20
    jkept, jpruned = js.prefilter(jgroups)
    tkept, tpruned = ts.prefilter(tgroups)
    assert [[r.key for r in g.records] for g in tkept] == \
        [[r.key for r in g.records] for g in jkept]
    assert (ts.pruned_groups, ts.pruned_members, ts.pruned_cross_family) == \
        (js.pruned_groups, js.pruned_members, js.pruned_cross_family)


@pytest.fixture(scope="module")
def port_run(zoo):
    """The port's whole pipeline on the JAX draws, the plan JSON it wrote,
    and its merged engine's served rows."""
    recorded = []
    mp = pytest.MonkeyPatch()
    to_json = TPOL.MergePlan.to_json

    def recording(self, *a, **kw):
        text = to_json(self, *a, **kw)
        recorded.append(text)
        return text

    mp.setattr(TPOL.MergePlan, "to_json", recording)
    try:
        rows, derived, info = TMZ.run_zoo(zoo["scn"], 8)
    finally:
        mp.undo()
    store = ParamStore.from_models({m: p for m, (_, __, p) in zoo["scn"].members.items()})
    eng = TMZ.zoo_engine(zoo["scn"], store)
    eng.apply_plan(MergePlan.from_json(recorded[0]))
    for r in TMZ.zoo_requests(zoo["scn"], 8):
        eng.submit(r)
    eng.serve(horizon_s=60.0)
    served = {(c.request.instance_id, c.request.deadline_s): _np(c.result)
              for c in eng.completions}
    return dict(rows=rows, derived=derived, info=info, plans=recorded, served=served)


def test_plan_json_is_the_reference_byte_for_byte(zoo, port_run):
    assert port_run["plans"] == [zoo["jpayload"]]


def test_derived_counts_equal_the_reference(zoo, port_run):
    d = port_run["derived"]
    assert {k: d[k] for k in zoo["want"]} == zoo["want"]
    assert all(TMZ.gates(d, port_run["info"], CPU).values())
    assert d["cross_family_groups"] >= 1 and d["memory_saved_bytes"] > 0
    # the scan and attention kernels' plain versions ran on the hot path
    assert all(d[f"dispatch_{k}"] > 0 for k in ("mamba_scan", "rg_lru_scan",
                                                 "flash_attention", "decode_attention",
                                                 "page_gather", "bank_matmul"))


def test_served_rows_bitwise_the_replay_and_close_to_the_reference_engine(zoo, port_run):
    d, info = port_run["derived"], port_run["info"]
    assert d["outputs_bitwise_ref"] and info["bank_gap"] == 0.0
    served, jrows = port_run["served"], zoo["jrows"]
    assert served.keys() == jrows.keys() and len(served) == 64
    for key, want in jrows.items():
        scale = np.abs(want).max()
        np.testing.assert_allclose(served[key] / scale, want / scale, rtol=1e-5, atol=1e-5,
                                   err_msg=str(key))


def test_decode_bitwise_against_the_unpaged_replay(port_run):
    d, info = port_run["derived"], port_run["info"]
    assert d["decode_outputs_bitwise"]
    st = info["decode_stats"]
    assert st["completed"] == 8 and st["lost_in_flight"] == 0 and st["pool_identity_ok"]
    assert st["max_active"] == len(TMZ.FAMILIES)
    assert info["decode_replay"]["argmax_mismatches"] == 0


def test_zoo_members_share_one_table_per_shape():
    """The port's own draws: one embedding table per (shape, dtype),
    shared across families; A keeps the base trunk, B moves it; heads
    move for both."""
    members = TMZ.zoo_members(device=CPU)
    flat = {m: flatten_paths(p) for m, (_, __, p) in members.items()}
    tables = {id(f["embed/table"]) for f in flat.values()}
    assert len(tables) == 1 and list(members) == [
        f"{fam}-{v}" for fam in TMZ.FAMILIES for v in TMZ.VARIANTS]
    for fam in TMZ.FAMILIES:
        a, b = flat[f"{fam}-A"], flat[f"{fam}-B"]
        trunk = [p for p in a if not TMZ.is_head(p) and p != "embed/table"]
        assert trunk and all(not torch.equal(a[p], b[p]) for p in trunk)
        assert all(not torch.equal(a[p], b[p]) for p in a if TMZ.is_head(p))
