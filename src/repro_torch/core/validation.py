"""Accuracy vetting (§5.1 step 2 / §5.5; the port of
``repro.core.validation``): merged configurations ship to the edge only
after every constituent model meets its per-model accuracy target
*relative to the original (unmerged) model*."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass
class RegisteredModel:
    """One user-registered query (§5.1): a model + data + accuracy target."""

    model_id: str
    loss_fn: Callable  # (params, batch) -> scalar loss tensor
    accuracy_fn: Callable  # (params, batch) -> scalar in [0, 1]
    train_batches: Callable  # (epoch:int) -> iterable of batches
    val_batch: Any
    accuracy_target: float = 0.95  # relative to original accuracy
    original_accuracy: Optional[float] = None  # measured before merging

    @property
    def absolute_target(self) -> float:
        base = self.original_accuracy if self.original_accuracy is not None else 1.0
        return self.accuracy_target * base


@torch.no_grad()
def validate(store, models: list, buffers=None) -> dict:
    """Per-model accuracy of the *current* store weights."""
    out = {}
    for m in models:
        params = (store.materialize_cached(m.model_id) if buffers is None
                  else store.materialize(m.model_id, buffers))
        out[m.model_id] = float(m.accuracy_fn(params, m.val_batch))
    return out


def meets_targets(accs: dict, models: list) -> bool:
    by_id = {m.model_id: m for m in models}
    return all(accs[mid] >= by_id[mid].absolute_target for mid in accs)
