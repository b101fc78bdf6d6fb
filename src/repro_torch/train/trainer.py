"""Training step + single-host driver (the port of ``repro.train.trainer``).

``make_train_step`` builds the step:

  * gradient accumulation over ``microbatches``: one forward and backward
    per microbatch, gradients summed in float32 in microbatch order (the
    (B, S) global batch's activations never live at once);
  * optional int8 gradient compression with error feedback
    (``distributed.compression.Int8Compressor``);
  * the optimizer update under ``torch.no_grad()``.

The JAX package jits its step and donates the state; this one runs eagerly,
one autograd pass per microbatch, and hands back a new state.

State: ``{"params": nested param tree, "opt": OptState, "step": int}``
plus ``"err"`` (the compressor's float32 feedback) with
``compress_grads``.  The optimizer's moments and the feedback are flat
``{path: tensor}`` dicts over the params' flat paths
(``utils.tree.flatten_paths``), the port's ``AdamW`` convention.

``Trainer`` is the orchestration shell: checkpoint restore and save,
heartbeat and straggler monitors, the data iterator, metrics.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.distributed.compression import Int8Compressor
from repro_torch.distributed.partitioning import (
    NamedSharding, _map_with_path, param_shardings, place_tree,
)
from repro_torch.distributed.sharding import LogicalRules, P, use_rules
from repro_torch.train.optimizer import OptState, global_norm
from repro_torch.utils.tree import flatten_paths


def _split_microbatches(batch: dict, microbatches: int) -> dict:
    def split(x):
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} % microbatches {microbatches}")
        return x.reshape(microbatches, b // microbatches, *x.shape[1:])

    return {k: split(v) for k, v in batch.items()}


def _with_leaves(params: Any, flat: dict) -> Any:
    """``params``' structure (empty subtrees kept) with the leaf at each
    flat path taken from ``flat``."""
    return _map_with_path(lambda path, _: flat[path], params)


def _value_and_grad(loss_fn: Callable, params: Any, batch: dict) -> tuple:
    """(loss, {path: gradient}) of ``loss_fn(params, batch)``; a leaf the
    loss does not read gets zeros, as ``jax.grad`` gives."""
    leaves = {p: t.detach().requires_grad_(True) for p, t in flatten_paths(params).items()}
    with torch.enable_grad():
        loss = loss_fn(_with_leaves(params, leaves), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {p: torch.zeros_like(leaves[p]) if g is None else g
                           for p, g in zip(leaves, grads)}


def make_train_step(loss_fn: Callable, optimizer: Any, microbatches: int = 1,
                    compress_grads: bool = False):
    """Returns ``step(state, batch) -> (state, metrics)`` (see the module
    docstring for ``state``); ``metrics`` holds the loss and the global
    norm of the (compressed) gradients, as 0-d tensors."""
    compressor = Int8Compressor() if compress_grads else None

    def step(state: dict, batch: dict) -> tuple:
        params = state["params"]
        if microbatches > 1:
            mb = _split_microbatches(batch, microbatches)
            gsum = {p: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                    for p, t in flatten_paths(params).items()}
            lsum = 0.0
            for i in range(microbatches):
                loss, grads = _value_and_grad(loss_fn, params, {k: v[i] for k, v in mb.items()})
                gsum = {p: a + grads[p].float() for p, a in gsum.items()}
                lsum = lsum + loss
            grads = {p: g / microbatches for p, g in gsum.items()}
            loss = lsum / microbatches
        else:
            loss, grads = _value_and_grad(loss_fn, params, batch)

        err = state.get("err")
        with torch.no_grad():
            if compressor is not None:
                grads, err = compressor.compress(grads, err)
            new_flat, opt_state = optimizer.update(grads, state["opt"], flatten_paths(params))
            gnorm = global_norm(grads)
        new_state = {"params": _with_leaves(params, new_flat), "opt": opt_state,
                     "step": state["step"] + 1}
        if err is not None:
            new_state["err"] = err
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step


def init_state(params: Any, optimizer: Any, compress_grads: bool = False) -> dict:
    flat = flatten_paths(params)
    state = {"params": params, "opt": optimizer.init(flat), "step": 0}
    if compress_grads:
        state["err"] = Int8Compressor().init(flat)
    return state


def state_shardings(state: dict, rules: Optional[LogicalRules]):
    """Shardings for the train state: params via the partitioning rules;
    the optimizer's moments and the feedback mirror them by flat path;
    scalars replicated."""
    if rules is None:
        return None
    p_sh = param_shardings(state["params"], rules)
    flat = flatten_paths(p_sh)
    repl = NamedSharding(rules.mesh, P())
    out = {"params": p_sh, "opt": OptState(repl, flat, flat), "step": repl}
    if "err" in state:
        out["err"] = flat
    return out


def batch_shardings(batch: dict, rules: Optional[LogicalRules]):
    if rules is None:
        return None
    return {k: rules.sharding(("batch",) + (None,) * (x.dim() - 1)) for k, x in batch.items()}


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Trainer:
    loss_fn: Callable
    optimizer: Any
    rules: Optional[LogicalRules] = None
    microbatches: int = 1
    compress_grads: bool = False
    ckpt_manager: Any = None  # repro_torch.ckpt.manager.CheckpointManager
    ckpt_every: int = 100
    monitors: tuple = ()  # runtime monitors with .tick(step, metrics)

    def fit(self, params: Any, data_iter, steps: int, log_every: int = 10) -> dict:
        """Train from the latest checkpoint (or ``params``) to ``steps``,
        taking ``next(data_iter)`` for each step.  ``step_time`` is the
        wall time of one step to its metrics on the host."""
        step_fn = make_train_step(self.loss_fn, self.optimizer, self.microbatches,
                                  self.compress_grads)
        state = init_state(params, self.optimizer, self.compress_grads)
        shardings = state_shardings(state, self.rules)
        start = 0
        if self.ckpt_manager is not None:
            device = next(iter(flatten_paths(params).values())).device
            restored = self.ckpt_manager.restore_latest(device=device, shardings=shardings)
            if restored is not None:
                state = restored
                start = int(state["step"])
        if shardings is not None:
            state = place_tree(state, shardings)

        history = []
        with use_rules(self.rules):
            for i in range(start, steps):
                batch = next(data_iter)
                t0 = time.monotonic()
                state, metrics = step_fn(state, batch)
                values = {k: float(v) for k, v in metrics.items()}
                dt = time.monotonic() - t0
                for mon in self.monitors:
                    mon.tick(i, {"step_time": dt, **values})
                if i % log_every == 0 or i == steps - 1:
                    history.append({"step": i, "loss": values["loss"],
                                    "grad_norm": values["grad_norm"]})
                if self.ckpt_manager is not None and (i + 1) % self.ckpt_every == 0:
                    self.ckpt_manager.save(state, step=i + 1)
        return {"state": state, "history": history}
