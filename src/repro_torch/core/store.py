"""ParamStore — the weight-unification substrate (the port of
``repro.core.store``; placement and plan shipping wait for later slices).

A store holds *physical* buffers (tensors) keyed by string ids; each model
has a *binding map* ``{leaf_path: store_key}``.  Unmerged models bind every
path to a private key ``"<model>:<path>"``.  Merging a :class:`LayerGroup`
rebinds all member paths to one shared key, initialised from a donor
member's weights (§5.3).

:meth:`materialize` is a plain dict lookup, so every member of a group gets
the SAME tensor object for a shared key: the bytes exist once on the device,
and autograd would sum the members' gradients into that one buffer.

Resident bytes = unique buffers, which is what merging saves.  Bindings
change only at merge/unmerge time, so the serve loop reuses one tree per
model per *binding epoch* (:meth:`materialize_cached`);
:attr:`materializations` counts rebuilds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.groups import LayerGroup, disambiguate_base, stable_group_id
from repro_torch.utils.tree import flatten_paths, leaf_bytes, unflatten_paths


def _private_key(model_id: str, path: str) -> str:
    return f"{model_id}:{path}"


@dataclasses.dataclass
class ParamStore:
    buffers: dict  # store_key -> tensor
    bindings: dict  # model_id -> {path: store_key}
    epoch: int = 0  # bumped on every rebinding
    materializations: dict = dataclasses.field(default_factory=dict)
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    # -- cache bookkeeping ----------------------------------------------------

    def bump_epoch(self) -> int:
        """Invalidate every cached tree and bank (bindings changed)."""
        self.epoch += 1
        self._cache.clear()
        return self.epoch

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_models(cls, models: dict) -> "ParamStore":
        """models: {model_id: params tree}."""
        buffers: dict = {}
        bindings: dict = {}
        for mid, params in models.items():
            bindings[mid] = {}
            for path, leaf in flatten_paths(params).items():
                key = _private_key(mid, path)
                buffers[key] = leaf
                bindings[mid][path] = key
        return cls(buffers, bindings)

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
        for ci, col in enumerate(group.columns()):
            if len(col) < 2:
                continue  # single appearance: nothing to share
            gid = f"{base}:c{ci}"
            self.buffers[gid] = self.buffers[self.bindings[col[0].model_id][col[0].path]]
            for r in col:
                old = self.bindings[r.model_id][r.path]
                self.bindings[r.model_id][r.path] = gid
                if old != gid:
                    self._gc_key(old)
            keys.append(gid)
        if keys:
            self.bump_epoch()
        return keys

    def unmerge(self, group: LayerGroup) -> None:
        """Give every member back a private copy of its current weights."""
        for r in group.records:
            cur = self.bindings[r.model_id][r.path]
            priv = _private_key(r.model_id, r.path)
            if priv != cur:
                self.buffers[priv] = self.buffers[cur].clone()
            self.bindings[r.model_id][r.path] = priv
        self._gc_unreferenced()  # shared buffers may now be orphaned
        self.bump_epoch()

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

    # -- materialisation ------------------------------------------------------

    def materialize(self, model_id: str) -> dict:
        """Nested params for one model; shared keys hand every member the
        same tensor object."""
        binding = self.bindings[model_id]
        return unflatten_paths({p: self.buffers[k] for p, k in binding.items()})

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
        :attr:`materializations` under :meth:`bank_id`."""
        model_ids = tuple(model_ids)
        pkey = None if paths is None else frozenset(paths)
        ckey = ("__bank__", model_ids, pkey)
        hit = self._cache.get(ckey)
        if hit is not None:
            return hit
        use = sorted(self.bindings[model_ids[0]]) if paths is None else sorted(pkey)
        flat = {p: torch.stack([self.buffers[self.bindings[m][p]] for m in model_ids])
                for p in use}
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
