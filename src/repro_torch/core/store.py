"""ParamStore — the weight-unification substrate (the port of
``repro.core.store``).

A store holds *physical* buffers (tensors) keyed by string ids; each model
has a *binding map* ``{leaf_path: store_key}``.  Unmerged models bind every
path to a private key ``"<model>:<path>"``.  Merging a :class:`LayerGroup`
rebinds all member paths to one shared key, initialised from a donor
member's weights (§5.3).

:meth:`materialize` is a plain dict lookup, so every member of a group gets
the SAME tensor object for a shared key: the bytes exist once on the device,
and autograd sums the members' gradients into that one buffer (joint
retraining, ``core.merging``, materializes leaf tensors through
``materialize(..., buffers=)``).

Plans round-trip cloud -> edge: :meth:`export_plan` builds a
``MergePlan`` from the store's committed bindings, :meth:`apply_plan`
replays one onto another store with a single epoch bump.

Resident bytes = unique buffers, which is what merging saves.  Bindings
change only at merge/unmerge time, so the serve loop reuses one tree per
model per *binding epoch* (:meth:`materialize_cached`);
:attr:`materializations` counts rebuilds.

**Mesh-sharded serve tier (DESIGN.md S3).**  A store can carry an injected
``placement`` (``distributed.partitioning.MeshPlacement``; the caller
builds the logical rules and hands them in).  With a placement installed
every key has a deterministic *home shard* ``shard_of(key) =
stable_seed(key) % n_shards`` (bookkeeping identity: per-shard epochs and
DMA/residency attribution, the JAX package's to the bit), mutators place
committed buffers under their binding path's partitioning rules, and
:meth:`materialize_bank` splits the stacked suffix bank's leading axis over
the mesh's ``model`` axis (``MeshPlacement.place_bank``).  Residency
semantics: shared trunk buffers replicate across shards, private buffers
live on their home shard — :meth:`resident_shards` is the scheduler's
per-device admission view.

**Per-shard epochs**: alongside the global counter every shard keeps its
own epoch in :attr:`shard_epochs`.  ``bump_epoch(keys=...)`` names the
touched store keys; exactly the home shards of those keys advance once.
``keys=None`` (global invalidation: a placement change) advances every
shard.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional

import torch

from repro_torch.core.groups import LayerGroup, disambiguate_base, stable_group_id
from repro_torch.utils.ids import stable_seed
from repro_torch.utils.tree import flatten_paths, leaf_bytes, unflatten_paths


def _private_key(model_id: str, path: str) -> str:
    return f"{model_id}:{path}"


@dataclasses.dataclass
class ParamStore:
    buffers: dict  # store_key -> tensor
    bindings: dict  # model_id -> {path: store_key}
    epoch: int = 0  # bumped on every rebinding / buffer commit
    materializations: dict = dataclasses.field(default_factory=dict)
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)
    # mesh placement (distributed.partitioning.MeshPlacement), injected by
    # the caller; None on a single device
    placement: Optional[Any] = None
    shard_epochs: dict = dataclasses.field(default_factory=dict)

    # -- shard identity -------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return self.placement.n_shards if self.placement is not None else 1

    def shard_of(self, key: str) -> int:
        """Deterministic home shard of a store key (per-shard epochs,
        residency/DMA attribution), stable across processes and independent
        of physical placement."""
        return stable_seed(key) % self.n_shards

    def resident_shards(self, key: str) -> tuple:
        """Shards on which a resident copy of ``key`` lives: shared buffers
        replicate across the mesh, private buffers live on their home
        shard.  The scheduler's per-device admission view; the shared set
        is recomputed per binding epoch."""
        if self.n_shards == 1:
            return (0,)
        shared = self._cache.get("__shared_keys__")
        if shared is None:
            shared = self._cache["__shared_keys__"] = frozenset(self.shared_keys())
        if key in shared:
            return tuple(range(self.n_shards))
        return (self.shard_of(key),)

    # -- cache bookkeeping ----------------------------------------------------

    def bump_epoch(self, keys: Optional[Iterable] = None) -> int:
        """Invalidate every cached tree and bank (bindings or buffer values
        changed).  ``keys`` names the store keys the mutation touched: their
        home shards' epochs advance exactly once; ``None`` advances every
        shard."""
        self.epoch += 1
        shards = range(self.n_shards) if keys is None else {self.shard_of(k) for k in keys}
        for s in shards:
            self.shard_epochs[s] = self.shard_epochs.get(s, 0) + 1
        self._cache.clear()
        return self.epoch

    def update_buffers(self, new: dict) -> None:
        """Commit new buffer values (e.g. after joint retraining) and
        invalidate cached trees that reference the old tensors.  Only the
        touched keys' home shards advance their epoch."""
        if self.placement is not None and new:
            paths = self._paths_for(set(new))
            new = {k: self._place(v, paths.get(k)) for k, v in new.items()}
        self.buffers.update(new)
        self.bump_epoch(keys=new.keys())

    # -- placement ------------------------------------------------------------

    def _place(self, value, path: Optional[str]):
        """Place a committed buffer under its binding path's partitioning
        rules (no-op without a placement)."""
        if self.placement is None:
            return value
        return self.placement.place(value, path)

    def _paths_for(self, keys: set) -> dict:
        """A representative binding path per key (the partitioning rules key
        on the path tail; every binding of a shared key is congruent)."""
        out: dict = {}
        for binding in self.bindings.values():
            for p, k in binding.items():
                if k in keys and k not in out:
                    out[k] = p
        return out

    def set_placement(self, placement: Optional[Any]) -> None:
        """Install (or clear) the mesh placement and re-place every buffer —
        the elastic mesh-change path (``ckpt.reshard.reshard_store``).
        Global invalidation: every shard's epoch advances once."""
        self.placement = placement
        if placement is not None:
            paths = self._paths_for(set(self.buffers))
            for k in list(self.buffers):
                self.buffers[k] = self._place(self.buffers[k], paths.get(k))
        self.bump_epoch()

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_models(cls, models: dict, placement: Optional[Any] = None) -> "ParamStore":
        """models: {model_id: params tree}.  With a ``placement`` every leaf
        is placed under its path's rules (on a mesh of the leaves' own
        device, the leaf itself)."""
        buffers: dict = {}
        bindings: dict = {}
        for mid, params in models.items():
            bindings[mid] = {}
            for path, leaf in flatten_paths(params).items():
                key = _private_key(mid, path)
                buffers[key] = placement.place(leaf, path) if placement is not None else leaf
                bindings[mid][path] = key
        return cls(buffers, bindings, placement=placement)

    # -- merging --------------------------------------------------------------

    def merge_group(self, group: LayerGroup) -> list:
        """Rebind the group's appearances to shared buffers, COLUMN-wise
        (each model's k-th appearance shares with other models' k-th).  The
        first record of each column donates the weights.  Returns the shared
        keys created."""
        base = disambiguate_base(
            stable_group_id(group.signature),
            lambda p: any(k.startswith(p) for k in self.buffers),
        )
        keys = []
        touched: set = set()
        for ci, col in enumerate(group.columns()):
            if len(col) < 2:
                continue  # single appearance: nothing to share
            gid = f"{base}:c{ci}"
            donor = col[0]
            self.buffers[gid] = self._place(
                self.buffers[self.bindings[donor.model_id][donor.path]], donor.path)
            touched.add(gid)
            for r in col:
                old = self.bindings[r.model_id][r.path]
                self.bindings[r.model_id][r.path] = gid
                if old != gid:
                    touched.add(old)
                    self._gc_key(old)
            keys.append(gid)
        if keys:
            self.bump_epoch(keys=touched)
        return keys

    def unmerge(self, group: LayerGroup) -> None:
        """Give every member back a private copy of its current weights."""
        touched: set = set()
        for r in group.records:
            cur = self.bindings[r.model_id][r.path]
            priv = _private_key(r.model_id, r.path)
            if priv != cur:
                self.buffers[priv] = self._place(self.buffers[cur].clone(), r.path)
            self.bindings[r.model_id][r.path] = priv
            touched.update((cur, priv))
        self._gc_unreferenced()  # shared buffers may now be orphaned
        self.bump_epoch(keys=touched)

    def _gc_key(self, key: str) -> None:
        for binding in self.bindings.values():
            if key in binding.values():
                return
        self.buffers.pop(key, None)

    def _gc_unreferenced(self) -> None:
        live = {k for b in self.bindings.values() for k in b.values()}
        for k in list(self.buffers.keys()):
            if k not in live:
                del self.buffers[k]

    # -- plan round-trip (cloud -> edge) ---------------------------------------

    def export_plan(self, groups: list, provenance: Optional[dict] = None,
                    include_weights: bool = False,
                    delta_base: Optional[dict] = None,
                    quantize: bool = False):
        """Build a serializable ``MergePlan`` from committed groups and the
        store's *current* bindings: for each column actually bound to one
        shared (non-private) key, record the key, the donor appearance
        (``merge_group``'s rule: first record of the column) and the member
        records.  Columns that no longer share are dropped — the plan
        reflects store reality, not planner intent.  ``include_weights``
        carries the shared-buffer values, so a retrained configuration
        reproduces bitwise on a fresh store; ``delta_base`` (key -> value the
        receiving edge holds) delta-encodes them, ``quantize`` ships changed
        float buffers as int8 residuals."""
        from repro_torch.core.policy import (
            ColumnBinding, MergePlan, PlanGroup, encode_weights,
        )

        pgs = []
        shared: list = []
        for g in groups:
            cols = []
            for col in g.columns():
                if len(col) < 2:
                    continue
                key = self.bindings[col[0].model_id][col[0].path]
                if key == _private_key(col[0].model_id, col[0].path):
                    continue  # not shared
                if any(self.bindings[r.model_id][r.path] != key for r in col):
                    continue  # column split since commit (revert/unmerge)
                cols.append(ColumnBinding(key, (col[0].model_id, col[0].path), tuple(col)))
                shared.append(key)
            if cols:
                pgs.append(PlanGroup(g.signature, tuple(cols)))
        weights = (encode_weights(self, shared, base=delta_base, quantize=quantize)
                   if include_weights else None)
        return MergePlan(1, tuple(pgs), provenance or {}, weights)

    def _plan_key_remap(self, plan) -> dict:
        """A plan key may already exist in this store bound to a *different*
        group's members (two disjoint same-architecture pairs merged by
        independent plans): remap such a plan group's keys to a fresh ``~n``
        base.  Keys whose current owners are all members of the plan's own
        column stay as they are (re-apply / update of the same buffer)."""
        owners: dict = {}
        for mid, binding in self.bindings.items():
            for path, key in binding.items():
                owners.setdefault(key, set()).add((mid, path))
        taken = set(self.buffers)
        remap: dict = {}
        for pg in plan.groups:
            members_by_key = {c.key: {(r.model_id, r.path) for r in c.members}
                              for c in pg.columns}
            if not any(owners.get(k, set()) - members_by_key[k] for k in members_by_key):
                taken.update(members_by_key)
                continue
            base = next(iter(members_by_key)).rsplit(":", 1)[0]
            new_base = disambiguate_base(base, lambda p: any(k.startswith(p) for k in taken))
            for k in members_by_key:
                remap[k] = new_base + ":" + k.rsplit(":", 1)[1]
                taken.add(remap[k])
        return remap

    def apply_plan(self, plan) -> list:
        """Replay a ``MergePlan`` onto this store: stage every column rebind
        (shared-key value = the carried weights, decoded onto the device of
        the column's current buffer, else the recorded donor's buffer), then
        commit with ONE epoch bump.  Nothing is mutated until every value is
        staged, so a payload that fails to decode leaves the store as it
        was.  Delta-encoded entries reconstruct against the buffer this
        store holds under the same (post-remap) key."""
        from repro_torch.core.policy import decode_weight

        carried = plan.shared_weights or {}
        remap = self._plan_key_remap(plan)
        staged: list = []  # (key, value, path, [(model_id, path), ...])
        for pg in plan.groups:
            for col in pg.columns:
                final = remap.get(col.key, col.key)
                if col.key in carried:
                    entry = carried[col.key]
                    base = (self.buffers.get(final)
                            if isinstance(entry, dict)
                            and entry.get("kind", "full") != "full" else None)
                    first = col.members[0]
                    device = self.buffers[self.bindings[first.model_id][first.path]].device
                    val = decode_weight(entry, base=base).to(device)
                else:
                    dm, dp = col.donor
                    val = self.buffers[self.bindings[dm][dp]]
                staged.append((final, val, col.members[0].path,
                               [(r.model_id, r.path) for r in col.members]))
        keys = []
        touched: set = set()
        for key, val, path, members in staged:
            self.buffers[key] = self._place(val, path)
            touched.add(key)
            for mid, mpath in members:
                old = self.bindings[mid][mpath]
                if old != key:
                    touched.add(old)
                self.bindings[mid][mpath] = key
            keys.append(key)
        self._gc_unreferenced()
        if keys:
            self.bump_epoch(keys=touched)
        return keys

    # -- materialisation ------------------------------------------------------

    def materialize(self, model_id: str, buffers: Optional[dict] = None) -> dict:
        """Nested params for one model; shared keys hand every member the
        same tensor object.  ``buffers`` (key -> tensor) replaces the
        store's own, e.g. leaf tensors that require grad in a joint step."""
        buffers = self.buffers if buffers is None else buffers
        binding = self.bindings[model_id]
        return unflatten_paths({p: buffers[k] for p, k in binding.items()})

    def materialize_cached(self, model_id: str) -> dict:
        """Serve-path materialisation: the *same* tree object for a model
        until the next binding epoch.  Callers treat it as read-only."""
        hit = self._cache.get(model_id)
        if hit is not None:
            return hit
        tree = self.materialize(model_id)
        self._cache[model_id] = tree
        self.materializations[model_id] = self.materializations.get(model_id, 0) + 1
        return tree

    @staticmethod
    def bank_id(model_ids: tuple) -> str:
        """Materialisation-counter key for a suffix bank over ``model_ids``."""
        return "bank:" + "+".join(model_ids)

    def materialize_bank(self, model_ids: tuple, paths=None) -> dict:
        """Suffix-bank materialisation: one tree whose every leaf is the
        members' buffers stacked on a leading bank axis —
        ``leaf[path][n] == buffers[bindings[model_ids[n]][path]]`` —
        restricted to ``paths``.  The stack is a new device tensor, cached
        per binding epoch like :meth:`materialize_cached`; rebuilds count in
        :attr:`materializations` under :meth:`bank_id`.  Under a placement
        each leaf's bank axis is split over the mesh's ``model`` axis
        (``MeshPlacement.place_bank``), the sharded dispatch's input."""
        model_ids = tuple(model_ids)
        pkey = None if paths is None else frozenset(paths)
        ckey = ("__bank__", model_ids, pkey)
        hit = self._cache.get(ckey)
        if hit is not None:
            return hit
        use = sorted(self.bindings[model_ids[0]]) if paths is None else sorted(pkey)
        flat = {p: torch.stack([self.buffers[self.bindings[m][p]] for m in model_ids])
                for p in use}
        if self.placement is not None:
            flat = {p: self.placement.place_bank(a) for p, a in flat.items()}
        tree = unflatten_paths(flat)
        self._cache[ckey] = tree
        bid = self.bank_id(model_ids)
        self.materializations[bid] = self.materializations.get(bid, 0) + 1
        return tree

    # -- accounting -----------------------------------------------------------

    def resident_bytes(self, model_ids: Optional[list] = None) -> int:
        """Unique buffer bytes for a set of models (the device footprint)."""
        ids = model_ids if model_ids is not None else list(self.bindings.keys())
        keys = {self.bindings[m][p] for m in ids for p in self.bindings[m]}
        return sum(leaf_bytes(self.buffers[k]) for k in keys)

    def resident_bytes_by_shard(self, model_ids: Optional[list] = None) -> dict:
        """Per-shard resident bytes for a set of models: shared buffers count
        on every shard (replicated trunk), private buffers on their home
        shard — the per-device view the sharded scheduler budgets against."""
        ids = model_ids if model_ids is not None else list(self.bindings.keys())
        keys = {self.bindings[m][p] for m in ids for p in self.bindings[m]}
        out = {s: 0 for s in range(self.n_shards)}
        for k in keys:
            nbytes = leaf_bytes(self.buffers[k])
            for s in self.resident_shards(k):
                out[s] += nbytes
        return out

    def model_bytes(self, model_id: str) -> int:
        return sum(leaf_bytes(self.buffers[k])
                   for k in set(self.bindings[model_id].values()))

    def shared_keys(self) -> set:
        counts: dict = {}
        for b in self.bindings.values():
            for k in set(b.values()):
                counts[k] = counts.get(k, 0) + 1
        return {k for k, c in counts.items() if c > 1}

    def incremental_load_bytes(self, next_model: str, resident: set) -> int:
        """Bytes that must be loaded to run ``next_model`` given the set of
        store keys already resident — the merging-aware swap cost (§5.4)."""
        needed = set(self.bindings[next_model].values())
        return sum(leaf_bytes(self.buffers[k]) for k in needed - resident)

    def keys_for(self, model_id: str) -> set:
        return set(self.bindings[model_id].values())

    def binding_signature(self, model_id: str, paths: Optional[set] = None) -> tuple:
        """Hashable fingerprint of (path -> store key) over ``paths``: equal
        fingerprints over a prefix's paths mean the prefix runs on identical
        weights — the engine's shared-stem detection."""
        b = self.bindings[model_id]
        use = sorted(paths) if paths is not None else sorted(b.keys())
        return tuple((p, b[p]) for p in use)
