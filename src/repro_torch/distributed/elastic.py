"""Elastic scaling: remap a training or serving job onto a different mesh
(the port of ``repro.distributed.elastic``).

On node failure (or scale-up) the job restarts on a new mesh shape: params
and optimizer state are resharded on load.  The checkpoint stores plain
host arrays (``ckpt.manager``); :func:`plan_for_devices` picks the new mesh
from the surviving devices and :func:`reshard_tree` places a tree on it.
No in-flight migration is attempted.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.distributed.partitioning import param_shardings, place_tree
from repro_torch.distributed.sharding import LogicalRules


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A candidate mesh for the surviving device set."""

    shape: tuple
    axes: tuple

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)


def plan_for_devices(n_devices: int, model_parallel: int, multi_pod_size: int = 0) -> MeshPlan:
    """Largest usable mesh given surviving devices: keep the model axis fixed
    (TP degree is a property of the model config), shrink data/pod axes."""
    if n_devices < model_parallel:
        raise ValueError(
            f"{n_devices} devices cannot host model-parallel degree {model_parallel}"
        )
    data = n_devices // model_parallel
    if multi_pod_size and data > multi_pod_size:
        pods = data // multi_pod_size
        return MeshPlan((pods, multi_pod_size, model_parallel), ("pod", "data", "model"))
    return MeshPlan((data, model_parallel), ("data", "model"))


def reshard_tree(tree, rules: LogicalRules):
    """Place a host-resident (or device) param tree onto the mesh described
    by ``rules``, leaf by leaf under its ``param_specs``."""
    return place_tree(tree, param_shardings(tree, rules))
