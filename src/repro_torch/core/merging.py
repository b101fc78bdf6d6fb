"""Joint retraining of a merging configuration (§5.3 "Accelerating
retraining"; the port of ``repro.core.merging``).

Given a :class:`ParamStore` whose bindings already reflect the candidate
configuration (shared keys in place), jointly train every involved model
end-to-end: the loss is the mean of the per-model losses, computed on
``materialize(..., buffers=)`` of leaf tensors that require grad, so
autograd sums every member's gradient into each shared buffer.

Adaptive behaviours from the paper:
* **early success** — once a model's accuracy is within ``es_threshold`` of
  its target, shrink the amount of data trained per epoch, inversely
  proportional to gap/lift;
* **early failure** — a model whose accuracy has not improved for
  ``ef_epochs`` consecutive epochs (while below target, and while other
  below-target models did improve) is evicted from the attempt and
  reported to the planner.

The CUDA kernels have no backward yet, so on the card the members' losses
must not pass through one (``kernels.ops`` raises if they do).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.store import ParamStore
from repro_torch.core.validation import meets_targets, validate
from repro_torch.train.optimizer import AdamW
from repro_torch.utils.tree import unflatten_paths


@dataclasses.dataclass
class MergeResult:
    success: bool
    accuracies: dict
    failed_models: set
    epochs_used: int
    wall_time: float
    data_fraction_log: list


def joint_loss(bindings: dict, loss_fns: dict, buffers: dict, batches: dict) -> torch.Tensor:
    """Mean over the models (sorted by id) of each model's loss on its
    batch, every model's params materialized from the one ``buffers``
    dict: a key bound by several models feeds all their losses."""
    total = 0.0
    for mid in sorted(bindings):
        params = unflatten_paths({p: buffers[k] for p, k in bindings[mid].items()})
        total = total + loss_fns[mid](params, batches[mid])
    return total / len(bindings)


def joint_grads(bindings: dict, loss_fns: dict, buffers: dict, batches: dict) -> tuple:
    """(loss, {key: gradient}) of :func:`joint_loss` with respect to every
    buffer; a buffer no loss reads gets zeros."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in buffers.items()}
    with torch.enable_grad():
        loss = joint_loss(bindings, loss_fns, leaves, batches)
        keys = sorted(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys], allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(leaves[k]) if g is None else g
                           for k, g in zip(keys, grads)}


@dataclasses.dataclass
class MergeTrainer:
    optimizer: Any = None
    max_epochs: int = 10
    es_threshold: float = 0.02  # start shrinking data within 2% of target
    ef_epochs: int = 2
    min_delta: float = 1e-3  # minimum accuracy lift that counts as progress
    min_data_fraction: float = 0.25
    clock: Callable[[], float] = time.monotonic  # injected for replay tests

    def __post_init__(self):
        if self.optimizer is None:
            self.optimizer = AdamW(lr=3e-4)

    def _step(self, bindings, loss_fns, buffers, opt_state, batches):
        loss, grads = joint_grads(bindings, loss_fns, buffers, batches)
        with torch.no_grad():
            buffers, opt_state = self.optimizer.update(grads, opt_state, buffers)
        return buffers, opt_state, loss

    def train(self, store: ParamStore, models: list) -> MergeResult:
        t0 = self.clock()
        active = list(models)
        failed: set = set()
        data_frac = {m.model_id: 1.0 for m in models}
        frac_log: list = []
        stall = {m.model_id: 0 for m in models}
        prev_acc = validate(store, models)
        last_accs = dict(prev_acc)

        epoch = 0
        opt_state = None
        active_ids: tuple = ()
        while epoch < self.max_epochs and active:
            # re-snapshot the bindings and the optimizer state only when the
            # set of active models changes — Adam moments persist across epochs
            if tuple(m.model_id for m in active) != active_ids:
                bindings = {m.model_id: dict(store.bindings[m.model_id]) for m in active}
                loss_fns = {m.model_id: m.loss_fn for m in active}
                trainable = sorted({k for b in bindings.values() for k in b.values()})
                buffers = {k: store.buffers[k] for k in trainable}
                opt_state = self.optimizer.init(buffers)
                active_ids = tuple(m.model_id for m in active)

            # one epoch: per-model batch streams, truncated by data_frac.
            # Models with reduced data cycle their shortened stream; the
            # epoch shrinks only when EVERY model is in early-success.
            streams = {}
            for m in active:
                batches = list(m.train_batches(epoch))
                n = max(1, int(len(batches) * data_frac[m.model_id]))
                streams[m.model_id] = batches[:n]
            n_steps = max(len(s) for s in streams.values())
            for i in range(n_steps):
                batch_dict = {mid: streams[mid][i % len(streams[mid])] for mid in streams}
                buffers, opt_state, _ = self._step(bindings, loss_fns, buffers, opt_state,
                                                   batch_dict)
            store.update_buffers(buffers)  # commit + invalidate cached trees
            epoch += 1

            accs = validate(store, active)
            last_accs.update(accs)
            frac_log.append(dict(data_frac))

            if meets_targets(accs, active):
                return MergeResult(True, last_accs, failed, epoch, self.clock() - t0, frac_log)

            # Early failure is *relative*: a model stalls only if it made no
            # progress while other below-target models did (paper: "not
            # improving at the same pace as the rest").
            lifts = {m.model_id: accs[m.model_id] - prev_acc.get(m.model_id, 0.0)
                     for m in active}
            below = [m for m in active if accs[m.model_id] < m.absolute_target]
            others_progress = {
                m.model_id: any(lifts[o.model_id] > self.min_delta
                                for o in below if o.model_id != m.model_id)
                for m in active
            }
            still_active = []
            for m in active:
                mid = m.model_id
                lift, gap = lifts[mid], m.absolute_target - accs[mid]
                if gap <= 0:
                    # met target: keep training (others may pull it down) but
                    # with minimal data
                    data_frac[mid] = self.min_data_fraction
                    still_active.append(m)
                elif gap <= self.es_threshold:
                    # early success: data inversely proportional to gap/lift,
                    # clipped in float32 as the JAX package's jnp.clip does
                    ratio = gap / max(lift, 1e-4)
                    data_frac[mid] = float(np.float32(
                        np.clip(ratio, self.min_data_fraction, 1.0)))
                    still_active.append(m)
                else:
                    if lift <= self.min_delta and others_progress[mid] and epoch > 1:
                        stall[mid] += 1
                    else:
                        stall[mid] = 0
                    if stall[mid] >= self.ef_epochs:
                        failed.add(mid)  # early failure: evict from attempt
                    else:
                        still_active.append(m)
                prev_acc[mid] = accs[mid]
            active = still_active
            if failed:
                break  # report to planner; it decides pruning vs. discard

        accs = validate(store, models)
        last_accs.update(accs)
        ok = meets_targets(
            {m.model_id: accs[m.model_id] for m in models if m.model_id not in failed},
            [m for m in models if m.model_id not in failed],
        ) and not failed
        return MergeResult(ok, last_accs, failed, epoch, self.clock() - t0, frac_log)
