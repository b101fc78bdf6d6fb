"""Reshard-on-load: place host parameters or a live ParamStore onto a
*different* mesh (the port of ``repro.ckpt.reshard``).

Resharding is placement only: compute the specs from the partitioning rules
on the new mesh and place each leaf (``distributed.partitioning.put``).
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.distributed.partitioning import (
    MeshPlacement, NamedSharding, _guarded, _map_with_path, put,
)
from repro_torch.distributed.sharding import LogicalRules


def reshard_params(params: Any, rules: LogicalRules):
    """``params`` (tensors or host arrays) placed under their
    ``param_specs`` on ``rules``' mesh, the tree's structure kept."""
    def one(path, x):
        spec = _guarded(rules, path, tuple(getattr(x, "shape", ())))
        return put(NamedSharding(rules.mesh, spec), x)

    return _map_with_path(one, params)


def reshard_store(store: Any, rules: Optional[LogicalRules], bank_axis: str = "model"):
    """Re-place a ParamStore onto the mesh in ``rules`` — the plan-receiving
    path when the edge box runs a *different* mesh than the sender
    (``distributed.elastic.plan_for_devices`` picks the local shape): builds
    a fresh ``MeshPlacement`` and installs it, re-placing every buffer under
    the new rules.  ``rules=None`` clears the placement (back to
    single-device semantics).  Returns the installed placement."""
    placement = MeshPlacement(rules, bank_axis=bank_axis) if rules is not None else None
    store.set_placement(placement)
    return placement
