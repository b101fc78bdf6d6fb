"""Wrapper of the hand-written Hopper suffix-bank GEMM (``csrc/bank_matmul.cu``).

    out[n] = x[n] @ w[n] (+ b[n])        n = 0..N-1 bank members

``x`` is banked ``(N, M, K)`` or broadcast ``(M, K)``; ``w`` is ``(N, K, F)``
and ``b`` ``(N, F)``; float32 or bfloat16 in, float32 out.  Two kernels,
picked by :func:`route` from dtype and shape alone: bf16 with 16-byte rows
takes the tensor-core kernel (``"wgmma"``, TMA-fed), everything else the
CUDA-core one (``"simt"``, which masks any ragged M, K and F).  This
function takes CUDA tensors only; the ops layer sends CPU tensors to
``ref.bank_matmul_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("wgmma", "simt")


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """``"wgmma"`` for bf16 x and w whose rows the TMA can describe (K and F
    multiples of 8, i.e. 16-byte rows, and 16-byte aligned data, which a
    tensor of such rows has unless it is a view starting mid-row), else
    ``"simt"``.  float32 stays on CUDA cores: TF32 would keep about three
    digits where the reference sums exact f32 products."""
    K, F = w.shape[-2], w.shape[-1]
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    if w.dtype == torch.bfloat16 and x.dtype == torch.bfloat16 and K % 8 == 0 \
            and F % 8 == 0 and aligned:
        return "wgmma"
    return "simt"


def check_args(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> None:
    """Raise on what the kernel does not take: shapes, dtypes and layout,
    whatever the tensors' device (meta tensors do)."""
    tensors = [x, w] + ([b] if b is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("bank_matmul: tensors on different devices")
    if w.dtype not in _DTYPES or any(t.dtype != w.dtype for t in tensors):
        raise TypeError(f"bank_matmul: float32 or bfloat16 inputs of one dtype, "
                        f"got {[t.dtype for t in tensors]}")
    if w.dim() != 3 or x.dim() not in (2, 3):
        raise ValueError(f"bank_matmul: x (N,M,K) or (M,K), w (N,K,F); "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    N, K, F = w.shape
    if x.shape[-1] != K or (x.dim() == 3 and x.shape[0] != N):
        raise ValueError(f"bank_matmul: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (N, F):
        raise ValueError(f"bank_matmul: b {tuple(b.shape)} != {(N, F)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("bank_matmul: inputs must be contiguous")


def bank_matmul(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Returns (N, M, F) float32 with out[n] = x[n] @ w[n] (+ b[n])."""
    if not all(t.is_cuda for t in (x, w, b) if t is not None):
        raise ValueError("bank_matmul kernel takes CUDA tensors only")
    check_args(x, w, b)
    N, K, F = w.shape
    broadcast = x.dim() == 2
    M = x.shape[0] if broadcast else x.shape[1]
    path = route(x, w)
    out = torch.empty((N, M, F), dtype=torch.float32, device=w.device)
    lib = _build.load_library()
    bias = b.data_ptr() if b is not None else None
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        if path == "wgmma":
            err = lib.bank_matmul_wgmma_launch(
                x.data_ptr(), w.data_ptr(), bias, out.data_ptr(), N, M, K, F,
                int(broadcast), stream)
        else:
            err = lib.bank_matmul_simt_launch(
                x.data_ptr(), w.data_ptr(), bias, out.data_ptr(), N, M, K, F,
                int(broadcast), _DTYPES[w.dtype], stream)
    _build.check(err, f"bank_matmul ({path})")
    bank_matmul.launches += 1
    bank_matmul.route_launches[path] += 1
    return out


# kernel launches since the last ops.reset_kernel_launches(), in all and by route
bank_matmul.launches = 0
bank_matmul.route_launches = dict.fromkeys(ROUTES, 0)
