"""Paper Fig 14 (the port of ``benchmarks/fig14_bandwidth.py``): cloud->edge
bandwidth during incremental merging — most bandwidth is spent AFTER most
savings are banked (late groups are many and light).  Paper: 6.0-19.4 GB
total; e.g. 86% of savings in 42 min with only 2.1 of 6.0 GB used.

    PYTHONPATH=src python -m repro_torch.bench.fig14_bandwidth [--device cuda|cpu]

Two lanes:

1. **Surrogate sweep** (``fig14_bandwidth`` artifact, host only) — the
   descriptor-scale bandwidth-vs-savings curve over the vision workloads.
2. **Plan wire format** (``BENCH_plan_wire`` artifact, DESIGN.md S3) — the
   bytes an *incremental update* puts on the cloud->edge link, on the LM
   bench's zoo (``bench.lm_merging``).  Plan v1 (the planner's own plan,
   full weights) is deployed onto an edge store; the cloud then
   "retrains" the shared buffers lm-C does NOT bind, leaving the lm-C
   columns untouched, and re-exports plan v2 three ways:

   * ``full``      — every shared buffer as raw bytes;
   * ``delta``     — against the deployed v1 buffers: unchanged keys ship
     as zero-payload ``same`` entries, changed keys still ship full;
   * ``delta_q8``  — changed float buffers as int8 residuals with
     per-leaf amax scales (``distributed.compression``).  Only numpy's
     floating kinds quantize, as in the reference, so a bf16 trunk ships
     its changed buffers full here too.

   Gates: ``delta_q8`` serialized-plan bytes <= 0.35x ``full``; after
   applying the ``delta_q8`` plan on the edge, lm-C (untouched) gives
   BITWISE-identical logits, and the quantized members clear the drift
   monitor's threshold against the cloud's exact post-retrain weights
   (top-1 agreement on the check batch).

:func:`plan_wire` takes the lane's inputs: the :class:`LMScenario` (zoo and
planner calibration), the check batch and, optionally, the planned
``(PlanResult, cloud store)``; :func:`run_plan_wire` runs it on
``lm_merging.numpy_scenario`` and :func:`numpy_batch`.  Each re-export is
serialized once and that string is measured; one lane's JSON is held at a
time.

The cloud's "retraining" keeps each buffer's dtype (:func:`retrained`).
The reference adds its float32 ramp to a bf16 buffer and keeps the float32
sum, so at bf16 it ships the changed buffers as float32 ``full`` entries
(twice the bytes) and hands the edge float32 buffers; at float32, the
tiny config's dtype, the two are bitwise the same.

The default config (head dim 16) runs on the CPU only: the flash kernel
compiles head dims 64, 128 and 256, so ``--device cuda`` (the default)
raises there.  On the card the lane runs at stablelm-1.6b's width from
``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.bench.common import check_gates, emit
from repro_torch.bench.gemel_scale import surrogate_merge
from repro_torch.bench.lm_merging import LMScenario, numpy_scenario, plan_variants
from repro_torch.configs.vision_workloads import WORKLOADS
from repro_torch.core import MergePlan, RegisteredModel
from repro_torch.core.drift import DriftMonitor
from repro_torch.core.signatures import weights_wire_bytes
from repro_torch.core.store import ParamStore
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import flatten_paths

AGREE_TARGET = 0.98  # relative drift target for the quantized models
WIRE_RATIO_GATE = 0.35
UNTOUCHED = "lm-C"  # the member whose shared buffers the cloud leaves alone


def run_surrogate(workloads: Optional[dict] = None) -> dict:
    rows = []
    for name in workloads or WORKLOADS:
        r = surrogate_merge(name, workloads=workloads)
        if not r.events:
            continue
        total_bw = sum(e.shipped_bytes for e in r.events)
        total_saved = r.events[-1].cumulative_saved
        # bandwidth used by the time 70% of savings are banked
        bw_at_70 = 0
        for e in r.events:
            bw_at_70 += e.shipped_bytes
            if e.cumulative_saved >= 0.7 * total_saved:
                break
        rows.append({
            "workload": name,
            "total_bandwidth_gb": total_bw / 1e9,
            "bw_gb_at_70pct_savings": bw_at_70 / 1e9,
            "bw_frac_at_70pct_savings": bw_at_70 / max(total_bw, 1),
        })
    bws = [r["total_bandwidth_gb"] for r in rows]
    return emit("fig14_bandwidth", rows, {
        "total_bw_range_gb": f"{min(bws):.1f}-{max(bws):.1f}",
        "paper": "6.0-19.4 GB; savings bank before bandwidth is spent",
    })


# ---------------------------------------------------------------------------
# Plan wire-format lane (DESIGN.md S3)
# ---------------------------------------------------------------------------


def numpy_batch(cfg, device=None) -> dict:
    """The drift check's batch: 8 sequences of 8 tokens from numpy."""
    toks = np.random.default_rng(33).integers(0, cfg.vocab_size, (8, 9)).astype(np.int32)
    dev = resolve_device(device)
    return {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
            "labels": torch.from_numpy(toks[:, 1:]).to(dev)}


def retrained(value: torch.Tensor, i: int) -> torch.Tensor:
    """The cloud's stand-in for retraining the ``i``-th changed buffer:
    + 1e-3 cos(0, 1, 2, ... + i), the reference's ramp, drawn in float32
    with numpy on the host (the same bits on every device) and added in
    float32.  The sum is cast back to the buffer's dtype, where the
    reference keeps it in float32: a bf16 model's forward takes bf16
    weights only."""
    ramp = np.cos(np.arange(value.numel(), dtype=np.float32) + i).reshape(tuple(value.shape))
    delta = torch.from_numpy(np.float32(1e-3) * ramp).to(value.device)
    return (value.float() + delta).to(value.dtype)


def _kind_counts(plan) -> dict:
    out = {"full": 0, "same": 0, "delta_q8": 0}
    for e in (plan.shared_weights or {}).values():
        out[e.get("kind", "full")] += 1
    return out


@torch.no_grad()
def _agreement_model(adapter, cfg, mid, ref_params, batch) -> RegisteredModel:
    """RegisteredModel whose accuracy is top-1 agreement with the cloud's
    exact post-retrain weights — the drift monitor's cloud-side oracle."""
    ref = adapter.forward(cfg, ref_params, batch["tokens"])[..., :cfg.vocab_size].argmax(-1)

    def agree(params, b, _ref=ref):
        pred = adapter.forward(cfg, params, b["tokens"])[..., :cfg.vocab_size].argmax(-1)
        return (pred == _ref).float().mean()

    return RegisteredModel(mid, lambda p, b: 0.0, agree, lambda e: [], batch,
                           accuracy_target=AGREE_TARGET, original_accuracy=1.0)


@torch.no_grad()
def plan_wire(scn: LMScenario, batch: dict, planned: Optional[tuple] = None) -> tuple:
    """The wire lane on ``scn``'s zoo; ``planned`` is ``plan_variants``'s
    ``(PlanResult, cloud store)`` (planned here when None).  The cloud store
    is updated in place.  Returns (rows, derived, seconds): host seconds of
    each step (``export``, ``to_json`` and ``from_json`` per lane,
    ``apply_plan`` of v1 and of ``delta_q8``)."""
    adapter, cfg = scn.adapter, scn.cfg
    res, cloud = plan_variants(scn) if planned is None else planned
    seconds = {"export": {}, "to_json": {}, "from_json": {}, "apply_plan": {}}

    # v1: the planner's own full-weight plan, deployed onto a fresh edge
    # box; its layer_groups() are the committed (scorer-refined) groups the
    # re-export below must speak for — enumerating candidates afresh would
    # reintroduce the pruned lm-C memberships and drop the split columns
    v1 = res.plan
    groups = v1.layer_groups()
    edge = ParamStore.from_models(dict(scn.zoo))
    t0 = time.perf_counter()
    edge.apply_plan(v1)
    seconds["apply_plan"]["v1"] = time.perf_counter() - t0

    # cloud-side "retraining": perturb the shared buffers lm-C does not
    # touch; the lm-C columns stay bitwise
    c_keys = set(edge.bindings[UNTOUCHED].values())
    shared = sorted(cloud.shared_keys())
    changed = [k for k in shared if k not in c_keys]
    unchanged = [k for k in shared if k in c_keys]
    if not (changed and unchanged):
        raise ValueError(f"the scenario needs both entry kinds: {len(changed)} shared keys "
                         f"{UNTOUCHED} does not bind, {len(unchanged)} it binds")
    cloud.update_buffers({k: retrained(cloud.buffers[k], i) for i, k in enumerate(changed)})

    # v2, three wire formats — delta base is what the edge box holds NOW
    base = {k: edge.buffers[k] for k in edge.shared_keys()}
    rows, bytes_on_wire = [], {}
    for lane, kw in (("full", {}), ("delta", {"delta_base": base}),
                     ("delta_q8", {"delta_base": base, "quantize": True})):
        t0 = time.perf_counter()
        plan = cloud.export_plan(groups, include_weights=True, **kw)
        seconds["export"][lane] = time.perf_counter() - t0
        t0 = time.perf_counter()
        payload = plan.to_json()
        seconds["to_json"][lane] = time.perf_counter() - t0
        del plan
        t0 = time.perf_counter()
        wire = MergePlan.from_json(payload)
        seconds["from_json"][lane] = time.perf_counter() - t0
        jb = len(payload)  # json.dumps escapes non-ASCII: one byte a character
        del payload
        bytes_on_wire[lane] = jb
        rows.append({
            "lane": lane, "json_bytes": jb,
            "payload_bytes": weights_wire_bytes(wire.shared_weights),
            **{f"n_{k}": v for k, v in _kind_counts(wire).items()},
        })
    # ``wire`` is the delta_q8 lane's decoded plan

    # apply the delta+int8 plan on the edge; the decode needs the resident
    # v1 buffers as base, which is exactly what the store holds.  A store
    # rebinds and never writes a buffer in place, so the tensors
    # materialized before the apply are the pre-update values.
    pre_tree = edge.materialize(UNTOUCHED)
    pre_c = flatten_paths(pre_tree)
    t0 = time.perf_counter()
    edge.apply_plan(wire)
    seconds["apply_plan"]["delta_q8"] = time.perf_counter() - t0
    del wire

    # unchanged model (lm-C): bitwise leaves and logits against pre-update
    post_tree = edge.materialize(UNTOUCHED)
    post_c = flatten_paths(post_tree)
    tokens = batch["tokens"]
    unchanged_bitwise = (
        pre_c.keys() == post_c.keys()
        and all(torch.equal(pre_c[p], post_c[p]) for p in pre_c)
        and torch.equal(adapter.forward(cfg, pre_tree, tokens),
                        adapter.forward(cfg, post_tree, tokens)))
    # exactly-unchanged shared buffers also stay bitwise (the `same` kind)
    unchanged_bitwise = unchanged_bitwise and all(
        torch.equal(edge.buffers[k], base[k]) for k in unchanged)

    # quantized models: drift-monitor check vs the cloud's exact weights
    mids = sorted(m for m in edge.bindings if m != UNTOUCHED)
    models = [_agreement_model(adapter, cfg, m, cloud.materialize(m), batch) for m in mids]
    mon = DriftMonitor(edge, {m: cloud.materialize(m) for m in mids}, models)
    report = mon.check({m: batch for m in mids})

    ratio = bytes_on_wire["delta_q8"] / bytes_on_wire["full"]
    derived = {
        "wire_ratio_delta": bytes_on_wire["delta"] / bytes_on_wire["full"],
        "wire_ratio_delta_q8": ratio,
        "wire_ratio_gate": WIRE_RATIO_GATE,
        "wire_ratio_ok": ratio <= WIRE_RATIO_GATE,
        "changed_keys": len(changed),
        "unchanged_keys": len(unchanged),
        "unchanged_bitwise": bool(unchanged_bitwise),
        "quant_agreement": {m: round(a, 6) for m, a in report.checked.items()},
        "quant_within_drift": not report.breached,
    }
    return rows, derived, seconds


def run_plan_wire(device=None) -> dict:
    scn = numpy_scenario(device=device)
    rows, derived, _ = plan_wire(scn, numpy_batch(scn.cfg, scn.device))
    return emit("BENCH_plan_wire", rows, derived)


def gates(d: dict) -> dict:
    """The lane's acceptance check (scripts/ci.sh:223-226 holds the ratio)."""
    return {"wire_ratio_delta_q8 <= 0.35": d["wire_ratio_ok"],
            "unchanged_bitwise": d["unchanged_bitwise"],
            "quant_within_drift": d["quant_within_drift"]}


def run(device=None) -> dict:
    run_surrogate()
    return run_plan_wire(device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    check_gates("plan_wire", gates(run(device=args.device)["derived"]))


if __name__ == "__main__":
    main()
