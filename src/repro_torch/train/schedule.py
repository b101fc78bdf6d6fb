"""Learning-rate schedules as callables of the step counter (the port of
``repro.train.schedule``).

Each returns a float32 0-d tensor computed in float32 from the step, as
the JAX package's do; ``AdamW(lr=...)`` calls it with the optimizer's step.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * progress))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return fn


def inverse_sqrt(peak_lr: float, warmup_steps: int):
    def fn(step):
        step = torch.clamp(_step(step), min=1.0)
        warm = peak_lr * step / max(warmup_steps, 1)
        decay = peak_lr * torch.sqrt(warmup_steps / step)
        return torch.where(step < warmup_steps, warm, decay)

    return fn
