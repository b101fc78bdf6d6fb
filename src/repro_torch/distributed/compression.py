"""int8 quantization with a per-leaf amax scale (the port of
``repro.distributed.compression``).

* :class:`Int8Compressor` — gradient compression with error feedback: the
  trainer quantizes each gradient leaf (plus the error carried from the
  last step) to int8 before the optimizer, and carries what the rounding
  lost into the next step (EF-SGD style).  ``x / scale`` is computed in
  float32 and ``torch.round`` rounds half to even as ``jnp.round`` does,
  so the same float32 gradient and error give the same int8 values, scale
  and new error as the JAX package's.
* :func:`quantize_int8` / :func:`dequantize_int8` — the host-side numpy
  twins, through which the MergePlan wire codec (``core.signatures``) ships
  changed shared buffers as int8 residuals.
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch


def _quantize_leaf(g: torch.Tensor) -> tuple:
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def quantize_int8(x) -> tuple:
    """Per-leaf amax scale, int8 payload: ``(q int8 ndarray, scale float)``."""
    x = np.asarray(x, np.float32)
    amax = float(np.max(np.abs(x))) + 1e-12 if x.size else 1e-12
    scale = amax / 127.0
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8(q, scale: float, dtype="float32"):
    return (np.asarray(q, np.float32) * scale).astype(dtype)


@dataclasses.dataclass(frozen=True)
class Int8Compressor:
    """grads' = Q^-1(Q(grads + error)); error' = (grads + error) - grads'.
    Trees are flat ``{path: tensor}`` dicts; the error mirrors the gradients
    in float32."""

    def init(self, params: dict) -> dict:
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}

    def compress(self, grads: dict, error: dict) -> tuple:
        out, new_error = {}, {}
        for k, g in grads.items():
            x = g.float() + error[k]
            deq = _dequantize_leaf(*_quantize_leaf(x))
            out[k], new_error[k] = deq.to(g.dtype), x - deq
        return out, new_error

    @staticmethod
    def wire_bytes_fraction() -> float:
        """int8 vs bf16 on the wire."""
        return 0.5
