"""Reshard-on-load: place a host train state, host parameters or a live
ParamStore onto a *different* mesh (the port of ``repro.ckpt.reshard``).

A checkpoint holds host arrays (``ckpt.manager``), so resharding is
placement only: compute the specs from the partitioning rules on the new
mesh and place each leaf (``distributed.partitioning.put``).  Used by the
failure-recovery path (``runtime.monitors.FailurePolicy``).
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.distributed.elastic import reshard_tree
from repro_torch.distributed.partitioning import MeshPlacement, place_tree
from repro_torch.distributed.sharding import LogicalRules
from repro_torch.train.trainer import state_shardings


def train_state_shardings(state: Any, rules: LogicalRules):
    return state_shardings(state, rules)


def reshard_state(state: Any, rules: LogicalRules):
    """Place a (host or device) train state onto the mesh in ``rules``."""
    return place_tree(state, train_state_shardings(state, rules))


def reshard_params(params: Any, rules: LogicalRules):
    """``params`` (tensors or host arrays) placed under their
    ``param_specs`` on ``rules``' mesh, the tree's structure kept."""
    return reshard_tree(params, rules)


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
