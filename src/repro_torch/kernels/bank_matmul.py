"""Wrapper of the hand-written Hopper suffix-bank GEMM (``csrc/bank_matmul.cu``).

    out[n] = x[n] @ w[n] (+ b[n])        n = 0..N-1 bank members

``x`` is banked ``(N, M, K)`` or broadcast ``(M, K)``; ``w`` is ``(N, K, F)``
and ``b`` ``(N, F)``; float32 or bfloat16 in, float32 out.  The CUDA kernel
masks ragged M, K and F, so any shape is taken (the Pallas version asserts
block divisibility).  This function takes CUDA tensors only; the ops layer
sends CPU tensors to ``ref.bank_matmul_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bank_matmul(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Returns (N, M, F) float32 with out[n] = x[n] @ w[n] (+ b[n])."""
    tensors = [x, w] + ([b] if b is not None else [])
    if not all(t.is_cuda for t in tensors):
        raise ValueError("bank_matmul kernel takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("bank_matmul: tensors on different devices")
    if w.dtype not in _DTYPES or any(t.dtype != w.dtype for t in tensors):
        raise TypeError(f"bank_matmul: float32 or bfloat16 inputs of one dtype, "
                        f"got {[t.dtype for t in tensors]}")
    if w.dim() != 3 or x.dim() not in (2, 3):
        raise ValueError(f"bank_matmul: x (N,M,K) or (M,K), w (N,K,F); "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    N, K, F = w.shape
    broadcast = x.dim() == 2
    M = x.shape[0] if broadcast else x.shape[1]
    if x.shape[-1] != K or (not broadcast and x.shape[0] != N):
        raise ValueError(f"bank_matmul: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (N, F):
        raise ValueError(f"bank_matmul: b {tuple(b.shape)} != {(N, F)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("bank_matmul: inputs must be contiguous")
    out = torch.empty((N, M, F), dtype=torch.float32, device=w.device)
    lib = _build.load_library()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bank_matmul_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr() if b is not None else None,
            out.data_ptr(), N, M, K, F, int(broadcast), _DTYPES[w.dtype], stream)
    _build.check(err, "bank_matmul")
    bank_matmul.launches += 1
    return out


bank_matmul.launches = 0  # kernel launches since the last ops.reset_kernel_launches()
