"""Pluggable merge-policy subsystem (the port of ``repro.core.policy``; an
``objective=`` such as ``serving.simulator.effective_accuracy_objective``
puts the simulator in the loop).

The §5.3 search is decomposed into explicit stages driven by a
:class:`StagedPlanner`:

    enumerate -> score/prefilter -> attempt -> commit/rollback

* **CandidateScorer** owns the ordering of candidate groups and an optional
  training-free *prefilter*.  :class:`MemoryForwardScorer` is the paper's
  memory-forward order; :class:`RepresentationSimilarityScorer` runs a
  calibration batch through each model and drops group members whose
  activations diverge (linear CKA) before any retraining is spent.
* **Trainer** — ``core.merging.MergeTrainer`` (real joint retraining) or
  :class:`CoherenceSurrogateTrainer` (training-free stand-in).

The planner's output is a :class:`MergePlan` — ordered committed groups,
per-column binding deltas (shared key + donor + members) and provenance —
that serializes to JSON byte for byte as the JAX package's does, so a plan
made by either package applies in the other: ``ParamStore.export_plan``
builds one, ``ParamStore.apply_plan`` replays it with a single epoch bump,
and ``MergeAwareEngine.apply_plan`` hot-swaps it under a live serve loop.

The CKA arithmetic is numpy float64 on the host, on (N, N) Gram matrices
of N calibration samples, as in the JAX package: with equal activations
both packages make the same decisions.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core.groups import LayerGroup, enumerate_groups
from repro_torch.core.signatures import (
    LayerRecord, decode_weight_entry, encode_weight_entry, record_from_json,
    record_to_json, signature_from_json, signature_to_json,
)
from repro_torch.core.store import ParamStore


# ---------------------------------------------------------------------------
# MergePlan — the serializable planning artifact
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ColumnBinding:
    """One shared buffer: its store key, the member appearances rebound to
    it, and the donor appearance whose weights initialise it when the plan
    does not carry trained weights."""

    key: str
    donor: tuple  # (model_id, path)
    members: tuple  # tuple[LayerRecord, ...] in merge (position) order


@dataclasses.dataclass(frozen=True)
class PlanGroup:
    signature: tuple
    columns: tuple  # tuple[ColumnBinding, ...]


# to_json's stand-in for a payload: a NUL, which json.dumps writes as the
# escape below (a plan whose other strings write it too is dumped whole)
_PAYLOAD_MARK = "\x00"
_PAYLOAD_MARK_JSON = '\\u0000'


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """Ordered committed groups + binding deltas + provenance.

    ``shared_weights`` optionally carries the shared-buffer values (wire
    entries, ``core.signatures``) so a plan exported after joint retraining
    reproduces serving outputs bitwise on a fresh store; without it,
    ``apply_plan`` initialises each shared key from the recorded donor —
    exactly what ``merge_group`` does."""

    version: int
    groups: tuple  # tuple[PlanGroup, ...] in commit order
    provenance: dict
    shared_weights: Optional[dict] = None  # key -> wire entry

    def binding_deltas(self) -> dict:
        """{(model_id, path): shared_key} for every rebound appearance."""
        return {(r.model_id, r.path): col.key
                for pg in self.groups for col in pg.columns for r in col.members}

    def layer_groups(self) -> list:
        """Committed groups as :class:`LayerGroup`s."""
        return [LayerGroup(pg.signature, [r for col in pg.columns for r in col.members])
                for pg in self.groups]

    def models(self) -> set:
        return {r.model_id for pg in self.groups for c in pg.columns for r in c.members}

    def to_json(self, indent: Optional[int] = None) -> str:
        """The plan as JSON text, ``json.dumps``'s.  The entries' payloads
        are base64 (the wire codec's only form), which JSON writes as it
        is, so they are spliced into the text of everything else instead
        of passing through the encoder's per-character escaping: that took
        most of the time of a multi-gigabyte plan.  (A payload that is not
        base64 but for a control character would be spliced raw, and
        ``json.loads`` refuses the text, as no decoder takes the payload.)"""
        def document(weights: dict) -> dict:
            return {
                "version": self.version,
                "groups": [
                    {
                        "signature": signature_to_json(pg.signature),
                        "columns": [
                            {"key": c.key, "donor": list(c.donor),
                             "members": [record_to_json(r) for r in c.members]}
                            for c in pg.columns
                        ],
                    }
                    for pg in self.groups
                ],
                "provenance": self.provenance,
                "shared_weights": weights,
            }

        weights, payloads = self.shared_weights, []
        if weights:
            slim = {}
            for k, e in weights.items():
                data = e.get("data")
                if (isinstance(data, str) and data.isascii() and '"' not in data
                        and "\\" not in data):
                    e = {**e, "data": _PAYLOAD_MARK + str(len(payloads))}
                    payloads.append(data)
                slim[k] = e
            weights = slim
        text = json.dumps(document(weights), indent=indent)
        if not payloads:
            return text
        head, *marked = text.split(_PAYLOAD_MARK_JSON)
        if len(marked) != len(payloads):  # another string writes the mark too
            return json.dumps(document(self.shared_weights), indent=indent)
        out = [head]
        for part in marked:
            i, rest = part.split('"', 1)
            out += [payloads[int(i)], '"', rest]
        return "".join(out)

    @classmethod
    def from_json(cls, payload: str) -> "MergePlan":
        obj = json.loads(payload)
        groups = []
        for pg in obj["groups"]:
            sig = signature_from_json(pg["signature"])
            cols = tuple(
                ColumnBinding(c["key"], tuple(c["donor"]),
                              tuple(record_from_json(m, sig) for m in c["members"]))
                for c in pg["columns"])
            groups.append(PlanGroup(sig, cols))
        return cls(obj["version"], tuple(groups), obj["provenance"],
                   obj.get("shared_weights"))


def encode_weights(store: ParamStore, keys: list, base: Optional[dict] = None,
                   quantize: bool = False) -> dict:
    """Serialize shared-buffer values for a plan payload, one entry at a
    time (each is copied to the host only while it is encoded).  ``base``
    maps a key to the value the receiving edge box currently holds under it:
    unchanged buffers ship as zero-payload ``same`` entries and, with
    ``quantize``, changed float buffers as int8 residuals."""
    return {k: encode_weight_entry(store.buffers[k],
                                   base=None if base is None else base.get(k),
                                   quantize=quantize)
            for k in keys}


def decode_weight(entry: dict, base=None):
    return decode_weight_entry(entry, base=base)


# ---------------------------------------------------------------------------
# CandidateScorer interface
# ---------------------------------------------------------------------------


class CandidateScorer:
    """Orders candidate groups (higher score attempted first) and optionally
    refines/prunes them before retraining is spent."""

    name = "scorer"

    def score(self, group: LayerGroup) -> float:
        raise NotImplementedError

    def prefilter(self, groups: list) -> tuple:
        """Returns (kept, pruned).  ``kept`` entries may be *refined* groups
        (members dropped); ``pruned`` lists candidates rejected outright."""
        return list(groups), []

    def order(self, groups: list) -> list:
        return sorted(groups, key=lambda g: (-self.score(g), g.signature))


class MemoryForwardScorer(CandidateScorer):
    """The paper's §5.3 order: group memory descending."""

    name = "memory-forward"

    def score(self, group: LayerGroup) -> float:
        return float(group.memory)


def activation_gram(x) -> np.ndarray:
    """Centered sample-space Gram K = X Xᵀ of an (N, ...) activation batch,
    in float64 — the O(N²·D) building block of linear CKA."""
    x = np.asarray(x, dtype=np.float64).reshape(x.shape[0], -1)
    x = x - x.mean(axis=0, keepdims=True)
    return x @ x.T


def cka_from_grams(kx: np.ndarray, ky: np.ndarray) -> float:
    """CKA(X, Y) = tr(KxKy) / (||Kx||_F ||Ky||_F) for centered Grams."""
    hsic = float(np.sum(kx * ky))
    denom = float(np.linalg.norm(kx) * np.linalg.norm(ky))
    if denom < 1e-12:
        return 0.0
    return hsic / denom


def linear_cka(x, y) -> float:
    """Linear CKA between two (N, ...) activation batches."""
    return cka_from_grams(activation_gram(x), activation_gram(y))


def default_layer_key(path: str) -> str:
    """Map a param path to the layer whose activation probes it: drop the
    final leaf segment ("stage0/0/conv1/w" -> "stage0/0/conv1")."""
    return path.rsplit("/", 1)[0] if "/" in path else path


def calibration_activations(members: dict, batch: dict) -> dict:
    """Activation payload for the scorer/surrogate, computed through each
    family's adapter.  ``members``: {model_id: (adapter, cfg, params)}; the
    same ``batch`` runs through every model.  Returns {model_id:
    {layer_key: (N, ...) float32 numpy}}."""
    return {mid: adapter.layer_activations(cfg, params, batch)
            for mid, (adapter, cfg, params) in members.items()}


# Mixed-zoo trunk eligibility: families whose trunk-internal layers are
# op-congruent and may share a buffer when signatures match.  dense and moe
# blocks run the same attention op sequence, so their attention and norm
# leaves may merge; the ssm mixer and the griffin recurrence are other
# computations even where a shape coincides, so a trunk column never mixes
# them with transformer trunks.  A family in no class merges its trunk
# only with itself.
TRUNK_COMPATIBLE: tuple = (frozenset({"dense", "moe"}),)

# Interface layers — the token embedding and the final-norm/unembedding
# suffix — compute the same op in every LM family, so cross-family sharing
# there is decided by signature and CKA alone.
INTERFACE_PREFIXES: tuple = ("embed", "final_norm", "lm_head")


def trunk_mergeable(fam_a: Optional[str], fam_b: Optional[str]) -> bool:
    """May trunk-internal layers of these two families share a buffer?  An
    unknown family merges only with itself."""
    if fam_a == fam_b:
        return True
    if fam_a is None or fam_b is None:
        return False
    return any(fam_a in c and fam_b in c for c in TRUNK_COMPATIBLE)


def is_interface_path(path: str) -> bool:
    return path.split("/", 1)[0] in INTERFACE_PREFIXES


class RepresentationSimilarityScorer(MemoryForwardScorer):
    """Training-free prefilter: prune group members whose calibration-batch
    activations diverge from the rest of their column, *before* any retrain
    is spent.  Ordering among survivors stays memory-forward (§5.3).

    ``activations``: {model_id: {layer_key: (N, ...) array}}, with layer
    keys as :func:`default_layer_key` maps record paths.  Records with no
    probe are conservatively kept.

    ``families``: optional {model_id: family name} for a mixed zoo: a
    trunk-internal column is first cut to its largest :func:`trunk_mergeable`
    class (``pruned_cross_family`` counts the records cut), while interface
    layers (:data:`INTERFACE_PREFIXES`) stay cross-family and CKA decides."""

    name = "representation-similarity"

    def __init__(self, activations: dict, min_similarity: float = 0.5,
                 families: Optional[dict] = None):
        self.activations = activations
        self.min_similarity = min_similarity
        self.families = families
        self.pruned_members = 0
        self.pruned_groups = 0
        self.pruned_cross_family = 0
        self._sim_cache: dict = {}
        self._gram_cache: dict = {}

    @classmethod
    def from_adapters(cls, members: dict, batch: dict, min_similarity: float = 0.5):
        """The scorer through the adapter contract: ``members = {model_id:
        (adapter, cfg, params)}`` and one shared calibration batch.  Each
        adapter's ``family`` tag sets the mixed-zoo eligibility."""
        return cls(calibration_activations(members, batch), min_similarity,
                   families={mid: adapter.family for mid, (adapter, _, __) in members.items()})

    def _family_filter(self, col: list) -> list:
        """Keep the largest trunk-compatible class of a trunk-internal
        column (ties: the class whose least member key sorts first).
        Interface columns pass through."""
        if not self.families or all(is_interface_path(r.path) for r in col):
            return col
        classes: list = []
        for r in col:
            fam = self.families.get(r.model_id)
            for cl in classes:
                if trunk_mergeable(fam, self.families.get(cl[0].model_id)):
                    cl.append(r)
                    break
            else:
                classes.append([r])
        best = min(classes, key=lambda cl: (-len(cl), sorted(r.key for r in cl)[0]))
        self.pruned_cross_family += len(col) - len(best)
        return best

    def _gram(self, record: LayerRecord):
        lk = default_layer_key(record.path)
        ck = (record.model_id, lk)
        if ck not in self._gram_cache:
            act = self.activations.get(record.model_id, {}).get(lk)
            self._gram_cache[ck] = None if act is None else activation_gram(act)
        return self._gram_cache[ck]

    def _pair(self, a: LayerRecord, b: LayerRecord) -> Optional[float]:
        ka, kb = self._gram(a), self._gram(b)
        if ka is None or kb is None:
            return None
        ck = (a.model_id, default_layer_key(a.path), b.model_id, default_layer_key(b.path))
        if ck not in self._sim_cache:
            self._sim_cache[ck] = cka_from_grams(ka, kb)
        return self._sim_cache[ck]

    def column_similarities(self, col: list) -> dict:
        """record.key -> mean pairwise CKA with the other probed members
        (None when the record has no probe)."""
        out = {}
        for r in col:
            sims = [s for o in col if o is not r for s in [self._pair(r, o)] if s is not None]
            out[r.key] = float(np.mean(sims)) if sims else None
        return out

    def column_cluster(self, col: list) -> tuple:
        """Largest mutually-coherent subset of a column's members: seed with
        the most similar probed pair, greedily grow by the member whose
        *minimum* similarity to the cluster stays >= ``min_similarity``.
        Unprobed members are kept.  Returns (kept_records,
        observed_similarities)."""
        probed = [r for r in col if self._gram(r) is not None]
        unprobed = [r for r in col if self._gram(r) is None]
        sims: dict = {}
        best_pair, best = None, -1.0
        for i in range(len(probed)):
            for j in range(i + 1, len(probed)):
                s = self._pair(probed[i], probed[j])
                sims[(i, j)] = sims[(j, i)] = s
                if s > best:
                    best, best_pair = s, (i, j)
        observed = [sims[(i, j)] for i in range(len(probed)) for j in range(i + 1, len(probed))]
        if best_pair is None:
            return list(col), observed  # nothing probed: keep everything
        if best < self.min_similarity:
            # no coherent pair at all — only unprobed members could share
            return (unprobed if len(unprobed) >= 2 else []), observed
        cluster = set(best_pair)
        candidates = set(range(len(probed))) - cluster
        while candidates:
            gains = {c: min(sims[(c, m)] for m in cluster) for c in candidates}
            c = max(sorted(gains), key=lambda k: gains[k])
            if gains[c] < self.min_similarity:
                break
            cluster.add(c)
            candidates.remove(c)
        keep = [r for i, r in enumerate(probed) if i in cluster] + unprobed
        return keep, observed

    def refine(self, group: LayerGroup) -> tuple:
        """Shrink each column to its coherent cluster; returns
        (refined_group | None, similarities observed).  A model that loses
        an appearance in column *k* is dropped from all later columns too,
        so its kept appearances stay a positional prefix and every
        surviving pairing was actually scored."""
        kept, sims = [], []
        broken: set = set()  # models whose appearance chain broke earlier
        for col in group.columns():
            col = [r for r in col if r.model_id not in broken]
            if len(col) >= 2:
                fcol = self._family_filter(col)
                broken |= {r.model_id for r in col} - {r.model_id for r in fcol}
                col = fcol
            if len(col) < 2:
                kept.extend(col)  # unshared appearance: keeps ranks aligned
                continue
            kcol, observed = self.column_cluster(col)
            sims.extend(observed)
            if len(kcol) >= 2:
                broken |= {r.model_id for r in col} - {r.model_id for r in kcol}
                kept.extend(kcol)
            else:
                broken |= {r.model_id for r in col}
        refined = LayerGroup(group.signature, kept) if len(kept) >= 2 else None
        if refined is not None and not any(len(c) >= 2 for c in refined.columns()):
            refined = None
        return refined, sims

    def similarity(self, group: LayerGroup) -> float:
        _, sims = self.refine(group)
        return float(np.mean(sims)) if sims else 1.0

    def prefilter(self, groups: list) -> tuple:
        kept, pruned = [], []
        for g in groups:
            refined, _ = self.refine(g)
            if refined is None:
                self.pruned_groups += 1
                self.pruned_members += len(g.records)
                pruned.append(g)
            else:
                self.pruned_members += len(g.records) - len(refined.records)
                kept.append(refined)
        return kept, pruned


class CoherenceSurrogateTrainer:
    """Training-free stand-in for ``MergeTrainer``: a configuration survives
    "retraining" iff every shared column is a mutually coherent cluster on
    the calibration batch; members outside the largest coherent cluster are
    reported as early failures.  Each ``train`` call counts as one attempt.
    It never changes a buffer."""

    def __init__(self, activations: dict, min_similarity: float = 0.5):
        self.probe = RepresentationSimilarityScorer(activations, min_similarity)
        self.calls = 0

    @classmethod
    def from_adapters(cls, members: dict, batch: dict, min_similarity: float = 0.5):
        """The adapter-contract constructor, as the scorer's."""
        return cls(calibration_activations(members, batch), min_similarity)

    def train(self, store, models, group=None):
        from repro_torch.core.merging import MergeResult

        self.calls += 1
        failed: set = set()
        for col in group.columns():
            if len(col) < 2:
                continue
            keep, _ = self.probe.column_cluster(col)
            failed |= {r.model_id for r in col} - {r.model_id for r in keep}
        accs = {m.model_id: (0.0 if m.model_id in failed else 1.0) for m in models}
        return MergeResult(not failed, accs, failed, 1, 0.0, [])


# ---------------------------------------------------------------------------
# Staged planner — enumerate -> score -> attempt -> commit/rollback
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MergeEvent:
    """One committed merging iteration (Figs 13 and 14: savings over time,
    and the weights shipped to the edge for this update)."""

    time: float  # seconds since merging started (planner clock)
    group_signature: tuple
    n_appearances: int
    saved_bytes: int  # incremental savings from this group
    cumulative_saved: int
    shipped_bytes: int  # weights shipped to the edge for this update
    accuracies: dict
    objective: Optional[float] = None  # simulator-in-the-loop score, if set


@dataclasses.dataclass(frozen=True)
class CascadeProfile:
    """Observed cascade behaviour of the serving front end, as planner
    input: per-instance heavy-path hit rates (the fraction of offered frames
    the gate sends to the heavy merged group) and the accuracy credit a
    gate-only completion earns.  Built from a ``CascadeGate``'s observed
    hit rates (``bench/overload.py``) and consumed by
    ``serving.simulator.effective_accuracy_objective(cascade=...)``: when
    only 40% of a camera's frames reach the heavy model, its residency is
    worth proportionally less swap pressure."""

    rates: dict  # instance_id -> hit rate in [0, 1]
    gate_accuracy: dict  # instance_id -> gate-only accuracy credit in [0, 1]

    def simulator_arg(self) -> dict:
        """The ``cascade=`` mapping ``simulator.simulate`` consumes:
        {instance_id: (hit_rate, gate_accuracy)}."""
        return {iid: (float(self.rates[iid]), float(self.gate_accuracy.get(iid, 0.0)))
                for iid in self.rates}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps({
            "rates": {k: float(v) for k, v in sorted(self.rates.items())},
            "gate_accuracy": {k: float(v) for k, v in sorted(self.gate_accuracy.items())},
        }, indent=indent)

    @classmethod
    def from_json(cls, payload: str) -> "CascadeProfile":
        obj = json.loads(payload)
        return cls(dict(obj["rates"]), dict(obj["gate_accuracy"]))


@dataclasses.dataclass
class PlanResult:
    store: ParamStore
    events: list
    attempted: int
    committed: int
    discarded: int
    baseline_bytes: int
    final_bytes: int
    pruned: int = 0  # candidates removed by the scorer prefilter
    plan: Optional[MergePlan] = None

    @property
    def saved_bytes(self) -> int:
        return self.baseline_bytes - self.final_bytes

    @property
    def fraction_saved(self) -> float:
        return self.saved_bytes / max(self.baseline_bytes, 1)


class StagedPlanner:
    """Incremental AIMD merging planner (§5.3), staged and pluggable.

    1. **enumerate** — layer groups across the workload;
    2. **score** — ``scorer.prefilter`` refines/prunes candidates without
       training, ``scorer.order`` ranks the survivors;
    3. **attempt** — take the next group, rebind it shared, retrain jointly
       (``core.merging.MergeTrainer`` or an injected surrogate);
    4. **commit/rollback** — on trainer success (and, when an ``objective``
       is set, no regression of its score) the
       weights stay; otherwise roll back and AIMD-shrink: prune
       early-failed models if reported, else halve dropping earliest-position
       appearances, and retry while the remainder still out-ranks the next
       candidate.

    Timing is injectable (``clock=``) so event traces are deterministic
    under test.  Warm start
    (§5.1 step 5, "merging resumes from the previously deployed state"):
    ``exclude_models`` leaves breached or quarantined members out of the
    search, and ``seed_plan``'s committed groups are re-attempted first.
    The result carries a :class:`MergePlan` built from the committed groups
    (``ParamStore.export_plan``)."""

    def __init__(
        self,
        store: ParamStore,
        models: list,  # list[RegisteredModel]
        records: list,  # list[LayerRecord] for the workload
        trainer=None,  # object with .train(store, models) -> MergeResult
        min_group_bytes: int = 1,
        scorer: Optional[CandidateScorer] = None,
        objective: Optional[Callable] = None,  # (store, groups) -> float
        clock: Callable[[], float] = time.monotonic,
        plan_weights: bool = True,
        exclude_models: Optional[set] = None,
        seed_plan: Optional[MergePlan] = None,
    ):
        self.store = store
        self.models = {m.model_id: m for m in models}
        self.records = list(records)
        self.trainer = trainer
        self.min_group_bytes = min_group_bytes
        self.scorer = scorer or MemoryForwardScorer()
        self.objective = objective
        self.clock = clock
        # ship the trained shared-buffer values in the plan: retraining
        # commits new values, so a weightless plan would rebuild the
        # pre-retraining configuration on the edge
        self.plan_weights = plan_weights
        self.exclude_models = set(exclude_models or ())
        self.seed_plan = seed_plan
        self.pruned_candidates: list = []
        self._trainer_takes_group: Optional[bool] = None

    # -- stage 1+2: enumerate and score ---------------------------------------

    def _seed_groups(self) -> list:
        """Committed groups of the previously deployed plan, minus excluded
        members — already validated configurations, re-attempted FIRST and
        in their original commit order.  They bypass the prefilter (they
        survived retraining once) and supersede the same-signature
        enumerated candidates (resume, don't re-litigate the last search)."""
        if self.seed_plan is None:
            return []
        seeds = []
        for g in self.seed_plan.layer_groups():
            g = g.without_models(self.exclude_models)
            if len(g.records) >= 2 and any(len(c) >= 2 for c in g.columns()):
                seeds.append(g)
        return seeds

    def candidates(self) -> list:
        records = [r for r in self.records if r.model_id not in self.exclude_models]
        kept, pruned = self.scorer.prefilter(enumerate_groups(records))
        self.pruned_candidates = pruned
        ordered = self.scorer.order(kept)
        seeds = self._seed_groups()
        if not seeds:
            return ordered
        seed_sigs = {g.signature for g in seeds}
        return seeds + [g for g in ordered if g.signature not in seed_sigs]

    # -- rollback support ------------------------------------------------------

    def _snapshot(self):
        return dict(self.store.buffers), {m: dict(b) for m, b in self.store.bindings.items()}

    def _restore(self, snap):
        self.store.buffers, self.store.bindings = snap[0], snap[1]
        self.store.bump_epoch()  # rollback rebinds: invalidate cached trees

    def _involved(self, group: LayerGroup) -> list:
        return [self.models[mid] for mid in sorted(group.models) if mid in self.models]

    def _train(self, group: LayerGroup):
        """Stage 3: joint retrain.  Trainers whose ``train`` accepts a
        ``group=`` kwarg (surrogates judging the configuration itself)
        receive it; ``MergeTrainer`` reads the store bindings."""
        if self._trainer_takes_group is None:
            try:
                sig = inspect.signature(self.trainer.train)
                self._trainer_takes_group = "group" in sig.parameters
            except (TypeError, ValueError):
                self._trainer_takes_group = False
        if self._trainer_takes_group:
            return self.trainer.train(self.store, self._involved(group), group=group)
        return self.trainer.train(self.store, self._involved(group))

    # -- stage 3+4: attempt, commit/rollback -----------------------------------

    def run(self) -> PlanResult:
        t0 = self.clock()
        baseline = self.store.resident_bytes()
        events: list = []
        committed_groups: list = []
        attempted = committed = discarded = 0
        cumulative_saved = 0
        best_obj = self.objective(self.store, []) if self.objective is not None else None

        queue = self.candidates()
        qi = 0
        while qi < len(queue):
            group = queue[qi]
            next_score = self.scorer.score(queue[qi + 1]) if qi + 1 < len(queue) else 0.0

            while True:  # AIMD retry loop on this group
                if len(group.records) < 2 or group.savings < self.min_group_bytes:
                    discarded += 1
                    break
                attempted += 1
                # one clock read per attempt, where the JAX package starts
                # its attempt timer: an injected clock then gives both
                # packages the same event times
                self.clock()
                snap = self._snapshot()
                before = self.store.resident_bytes()
                self.store.merge_group(group)
                result = self._train(group)

                if result.success:
                    obj = None
                    if self.objective is not None:
                        obj = self.objective(self.store, committed_groups + [group])
                        if obj < best_obj:
                            # retraining passed but the deployed quality
                            # regressed (e.g. merging broke the swap order):
                            # roll back the commit and move on
                            self._restore(snap)
                            discarded += 1
                            break
                        best_obj = obj
                    committed += 1
                    committed_groups.append(group)
                    saved = before - self.store.resident_bytes()
                    cumulative_saved += saved
                    shipped = sum(self.store.model_bytes(mid) for mid in sorted(group.models))
                    ev = MergeEvent(self.clock() - t0, group.signature, len(group.records),
                                    saved, cumulative_saved, shipped, result.accuracies,
                                    objective=obj)
                    events.append(ev)
                    break

                # failure: roll back weights/bindings to last successful state
                self._restore(snap)
                if result.failed_models:
                    group = group.without_models(result.failed_models)
                else:
                    group = group.drop_earliest_half()
                # keep retrying only while the shrunken group still out-ranks
                # the next candidate in the scorer's order (§5.3)
                if self.scorer.score(group) <= next_score or len(group.records) < 2:
                    discarded += 1
                    break
            qi += 1

        plan = self.store.export_plan(
            committed_groups,
            provenance=self._provenance(events, attempted, committed, discarded, baseline,
                                        best_obj),
            include_weights=self.plan_weights,
        )
        return PlanResult(self.store, events, attempted, committed, discarded, baseline,
                          self.store.resident_bytes(), pruned=len(self.pruned_candidates),
                          plan=plan)

    def _provenance(self, events, attempted, committed, discarded, baseline,
                    best_obj) -> dict:
        # the JAX package's schema; with no per-attempt budget a re-plan
        # never times out
        prov = {
            "planner": type(self).__name__,
            "scorer": self.scorer.name,
            "warm_start": self.seed_plan is not None,
            "excluded": sorted(self.exclude_models),
            "attempted": attempted,
            "committed": committed,
            "discarded": discarded,
            "pruned": len(self.pruned_candidates),
            "replan_timed_out": False,
            "baseline_bytes": baseline,
            "final_bytes": self.store.resident_bytes(),
            "events": [
                {"time": e.time,
                 "signature": signature_to_json(e.group_signature),
                 "n_appearances": e.n_appearances,
                 "saved_bytes": e.saved_bytes,
                 "objective": e.objective}
                for e in events
            ],
        }
        if self.objective is not None:
            prov["objective_final"] = best_obj
        return prov
