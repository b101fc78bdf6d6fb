"""Merging-aware Nexus-variant scheduler (§3.2 + §5.4) — the port of
``repro.serving.scheduler``.  Pure policy: no framework code; the
discrete-event simulator and the real executors both drive it.

  * round-robin order over model instances; with merging, instances that
    share the most bytes are placed adjacently so each swap loads only the
    non-resident layers (§5.4);
  * without merging, instances are visited in ``instance_id`` order;
  * memory admission: the params resident set is tracked at store-key
    granularity; eviction removes the most-recently-run instance's private
    keys ("next use most distant in the future" under round-robin);
  * sharded admission (DESIGN.md S3): with ``shard_fn`` the capacity is
    per shard and a key counts against every shard it resides on;
  * per-swap cost: incremental bytes / PCIe bandwidth.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serving.costs import PCIE_GBPS


@dataclasses.dataclass
class Instance:
    """One registered query at the edge: a model instance bound to a feed."""

    instance_id: str
    model_id: str  # cost-table id
    keys: frozenset  # store keys (weights) this instance needs
    key_bytes: dict  # key -> bytes
    accuracy: float = 1.0

    @property
    def param_bytes(self) -> int:
        return sum(self.key_bytes[k] for k in self.keys)


def shared_bytes(a: Instance, b: Instance) -> int:
    return sum(a.key_bytes[k] for k in a.keys & b.keys)


def merging_aware_order(instances: list) -> list:
    """Greedy chain: start from the largest instance, repeatedly append the
    instance sharing the most bytes with the current tail (paper §5.4)."""
    if not instances:
        return []
    remaining = sorted(instances, key=lambda i: -i.param_bytes)
    order = [remaining.pop(0)]
    while remaining:
        tail = order[-1]
        nxt = max(remaining, key=lambda i: (shared_bytes(tail, i), -i.param_bytes))
        remaining.remove(nxt)
        order.append(nxt)
    return order


@dataclasses.dataclass
class MemoryState:
    capacity_bytes: int
    resident: dict  # key -> bytes
    owners: dict  # key -> set(instance_id) of resident instances using it
    lru: list  # instance ids, least-recently-run first

    @classmethod
    def empty(cls, capacity_bytes: int) -> "MemoryState":
        return cls(capacity_bytes, {}, {}, [])

    @property
    def used_bytes(self) -> int:
        return sum(self.resident.values())


class Scheduler:
    """Admission + eviction + swap accounting over one device, or over the
    shards of a mesh."""

    def __init__(self, instances: list, capacity_bytes: int, costs: dict,
                 merged: bool = True, shard_fn=None, n_shards: int = 1):
        self.instances = {i.instance_id: i for i in instances}
        self.order = (merging_aware_order(instances) if merged
                      else sorted(instances, key=lambda i: i.instance_id))
        self.mem = MemoryState.empty(capacity_bytes)
        self.costs = costs
        # sharded admission (DESIGN.md S3): with shard_fn (key -> tuple of
        # resident shards, e.g. ParamStore.resident_shards) capacity_bytes
        # becomes PER-SHARD — a key counts against every shard it resides on
        # (replicated trunk on all, private suffix on its home shard), so a
        # merged group whose total exceeds one device's budget still admits
        # when each shard's slice fits.
        self.shard_fn = shard_fn
        self.n_shards = max(int(n_shards), 1) if shard_fn is not None else 1
        self.stats = {"loads": 0, "loaded_bytes": 0, "evictions": 0}

    def _activation_bytes(self, inst: Instance, batch: int) -> int:
        return int(self.costs[inst.model_id].activation_gb(batch) * 1e9)

    def _shards_of(self, key) -> tuple:
        return self.shard_fn(key) if self.shard_fn is not None else (0,)

    def _bytes_by_shard(self, items) -> dict:
        """items: iterable of (key, bytes) -> {shard: bytes} under the
        residency map (replicated keys count on every resident shard)."""
        out = {s: 0 for s in range(self.n_shards)}
        for k, b in items:
            for s in self._shards_of(k):
                out[s] += b
        return out

    def resident_bytes_by_shard(self) -> dict:
        return self._bytes_by_shard(self.mem.resident.items())

    def load(self, instance_id: str, batch: int) -> dict:
        """Make ``instance_id`` runnable; returns swap accounting."""
        inst = self.instances[instance_id]
        need_keys = {k: inst.key_bytes[k] for k in inst.keys
                     if k not in self.mem.resident}
        need_bytes = sum(need_keys.values())
        act = self._activation_bytes(inst, batch)
        evicted = []

        def fits():
            if self.shard_fn is None:
                return self.mem.used_bytes + need_bytes + act <= self.mem.capacity_bytes
            used = self.resident_bytes_by_shard()
            need = self._bytes_by_shard(need_keys.items())
            return all(used[s] + need[s] + act <= self.mem.capacity_bytes
                       for s in range(self.n_shards))

        # Evict most-recently-run first (its next turn is the furthest away
        # under round-robin); never evict keys the incoming instance needs.
        while not fits() and self.mem.lru:
            victim_id = self.mem.lru.pop()
            victim = self.instances[victim_id]
            for k in victim.keys:
                users = self.mem.owners.get(k)
                if users is None:
                    continue
                users.discard(victim_id)
                if not users and k not in inst.keys:
                    self.mem.resident.pop(k, None)
                    self.mem.owners.pop(k, None)
            evicted.append(victim_id)
        if not fits() and (need_bytes + act) <= self.mem.capacity_bytes:
            # residual keys from evicted instances — drop any not needed
            for k in list(self.mem.resident.keys()):
                if k not in inst.keys and not self.mem.owners.get(k):
                    self.mem.resident.pop(k, None)
                    self.mem.owners.pop(k, None)
                    if fits():
                        break

        for k, b in need_keys.items():
            self.mem.resident[k] = b
        for k in inst.keys:
            self.mem.owners.setdefault(k, set()).add(instance_id)
        if instance_id in self.mem.lru:
            self.mem.lru.remove(instance_id)
        self.mem.lru.append(instance_id)

        self.stats["loads"] += 1
        self.stats["loaded_bytes"] += need_bytes
        self.stats["evictions"] += len(evicted)
        return {
            "loaded_bytes": need_bytes,
            "loaded_keys": list(need_keys),
            "loaded_bytes_by_shard": self._bytes_by_shard(need_keys.items()),
            "load_ms": 1000.0 * need_bytes / 1e9 / PCIE_GBPS,
            "evicted": evicted,
            "resident_bytes": self.mem.used_bytes,
        }

    def run_time_ms(self, instance_id: str, batch: int) -> float:
        return self.costs[self.instances[instance_id].model_id].run_time(batch)

    def rebind(self, instances: list) -> dict:
        """Swap the instance table for plan-rebuilt Instances (a live
        MergePlan application changed the store-key sets) WITHOUT resetting
        residency: keys still referenced by some instance stay resident, so
        the next loads pay only the plan's incremental bytes; keys no longer
        referenced are dropped.  Round-robin order is recomputed
        merging-aware over the new key sets."""
        self.instances = {i.instance_id: i for i in instances}
        self.order = merging_aware_order(instances)
        live = {k for i in instances for k in i.keys}
        dropped = [k for k in self.mem.resident if k not in live]
        for k in dropped:
            self.mem.resident.pop(k, None)
            self.mem.owners.pop(k, None)
        known = set(self.instances)
        self.mem.lru = [iid for iid in self.mem.lru if iid in known]
        for k, users in list(self.mem.owners.items()):
            # keep only live instances whose NEW key set still includes k
            users.intersection_update(iid for iid in known if k in self.instances[iid].keys)
            if not users:
                # unowned residuals stay resident (evictable later); only the
                # owners table entry goes
                self.mem.owners.pop(k)
        return {"resident_bytes": self.mem.used_bytes, "dropped_keys": len(dropped)}

    def peek_load_bytes(self, instance_id: str) -> int:
        """Incremental bytes a load of ``instance_id`` would transfer right
        now, WITHOUT mutating residency/LRU state (sizes a prefetch)."""
        inst = self.instances[instance_id]
        return sum(inst.key_bytes[k] for k in inst.keys
                   if k not in self.mem.resident)

    @staticmethod
    def overlapped_load_ms(load_ms: float, hidden_ms: float) -> float:
        """Visible stall of a load that overlaps ``hidden_ms`` of compute."""
        return max(load_ms - hidden_ms, 0.0)

    def cycle_swap_bytes(self, batches: dict) -> dict:
        """Steady-state incremental load (GB) per instance around the
        round-robin cycle (for the profiler): two full cycles on a copy."""
        out = {}
        sim = Scheduler(list(self.instances.values()), self.mem.capacity_bytes, self.costs,
                        shard_fn=self.shard_fn, n_shards=self.n_shards)
        sim.order = self.order
        for _ in range(2):
            for inst in self.order:
                r = sim.load(inst.instance_id, batches.get(inst.instance_id, 1))
                out[inst.instance_id] = r["loaded_bytes"] / 1e9
        return out
