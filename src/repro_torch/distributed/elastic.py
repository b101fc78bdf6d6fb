"""Elastic scaling: the mesh a job (or a plan-receiving edge box) runs on,
from the devices it has (the port of ``repro.distributed.elastic``'s mesh
arithmetic).  Host arithmetic only: the placement it feeds is
``ckpt.reshard.reshard_store``."""
from __future__ import annotations

import dataclasses
import math


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
