"""Optimizers over flat parameter dicts (the port of
``repro.train.optimizer``): AdamW with decoupled weight decay and
global-norm clipping, and SGD with momentum.

They are plain functions over tensors, not ``torch.optim``, so that their
arithmetic follows the JAX package's operation for operation: float32
moments, the clip scale, the bias corrections in float32, and the updated
parameter cast back to its dtype.  ``init`` / ``update`` take and return
``{name: tensor}`` dicts; the state mirrors the parameter dict.  Callers
run ``update`` under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch


class OptState(NamedTuple):
    step: int
    mu: dict
    nu: dict


def _zeros(params: dict) -> dict:
    return {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, leaves in sorted-key order
    (the order ``jax.tree_util.tree_leaves`` visits a dict)."""
    leaves = [tree[k] for k in sorted(tree)]
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves))


def _clip(grads: dict, clip_norm: Optional[float]) -> dict:
    """Scale every gradient by min(1, clip_norm / norm), in float32."""
    if clip_norm is None:
        return grads
    scale = torch.clamp(clip_norm / (global_norm(grads) + 1e-9), max=1.0)
    return {k: g.float() * scale for k, g in grads.items()}


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Any = 1e-3  # float or callable(step) -> float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0

    def init(self, params: dict) -> OptState:
        return OptState(0, _zeros(params), _zeros(params))

    def _lr(self, step: int, device) -> torch.Tensor:
        lr = self.lr(step) if callable(self.lr) else self.lr
        return torch.as_tensor(lr, dtype=torch.float32, device=device)

    def update(self, grads: dict, state: OptState, params: dict):
        step = state.step + 1
        grads = _clip(grads, self.clip_norm)
        b1, b2 = self.b1, self.b2
        mu = {k: b1 * state.mu[k] + (1 - b1) * g.float() for k, g in grads.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * torch.square(g.float())
              for k, g in grads.items()}
        device = next(iter(params.values())).device
        t = torch.tensor(step, dtype=torch.float32, device=device)
        mu_hat_scale = 1.0 / (1 - b1 ** t)
        nu_hat_scale = 1.0 / (1 - b2 ** t)
        lr = self._lr(step, device)

        def upd(p, m, v):
            u = (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        new = {k: upd(p, mu[k], nu[k]) for k, p in params.items()}
        return new, OptState(step, mu, nu)


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: float = 0.05
    momentum: float = 0.9
    clip_norm: Optional[float] = 5.0

    def init(self, params: dict) -> OptState:
        zeros = _zeros(params)
        return OptState(0, zeros, zeros)

    def update(self, grads: dict, state: OptState, params: dict):
        grads = _clip(grads, self.clip_norm)
        mu = {k: self.momentum * state.mu[k] + g.float() for k, g in grads.items()}
        new = {k: (p.float() - self.lr * mu[k]).to(p.dtype) for k, p in params.items()}
        return new, OptState(state.step + 1, mu, state.nu)
