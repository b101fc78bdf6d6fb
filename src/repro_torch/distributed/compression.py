"""int8 quantization with a per-leaf amax scale (the port of the host-side
numpy twins in ``repro.distributed.compression``; the gradient compressor
with error feedback waits for the sharded-training slice).

The MergePlan wire codec (``core.signatures``) ships changed shared buffers
as int8 residuals through these two functions.  They are plain numpy, so
the same float32 input gives the same int8 bytes and the same ``scale`` as
the JAX package's.
"""
from __future__ import annotations

import numpy as np


def quantize_int8(x) -> tuple:
    """Per-leaf amax scale, int8 payload: ``(q int8 ndarray, scale float)``."""
    x = np.asarray(x, np.float32)
    amax = float(np.max(np.abs(x))) + 1e-12 if x.size else 1e-12
    scale = amax / 127.0
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8(q, scale: float, dtype="float32"):
    return (np.asarray(q, np.float32) * scale).astype(dtype)
