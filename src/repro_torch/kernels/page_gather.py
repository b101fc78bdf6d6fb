"""Wrapper of the hand-written Hopper page gather (``csrc/page_gather.cu``).

    out[i] = pool[table[i]]

``pool`` is ``(P, W)`` of any dtype, ``table`` ``(N,)`` int32 on the same
device; the output is ``(N, W)`` in the pool's dtype.  The kernel copies
bytes, so it is exact.  An index outside ``[0, P)`` gives a row of zeros.
This function takes CUDA tensors only; the ops layer sends CPU tensors to
``ref.page_gather_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def page_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Returns (N, W) with out[i] = pool[table[i]]."""
    if not (pool.is_cuda and table.is_cuda):
        raise ValueError("page_gather kernel takes CUDA tensors only")
    if pool.device != table.device:
        raise ValueError("page_gather: tensors on different devices")
    if table.dtype != torch.int32:
        raise TypeError(f"page_gather: table must be int32, got {table.dtype}")
    if pool.dim() != 2 or table.dim() != 1:
        raise ValueError(f"page_gather: pool (P, W), table (N,); got "
                         f"{tuple(pool.shape)}, {tuple(table.shape)}")
    if not (pool.is_contiguous() and table.is_contiguous()):
        raise ValueError("page_gather: inputs must be contiguous")
    P, W = pool.shape
    (N,) = table.shape
    out = torch.empty((N, W), dtype=pool.dtype, device=pool.device)
    lib = _build.load_library()
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.page_gather_launch(pool.data_ptr(), table.data_ptr(), out.data_ptr(),
                                     P, N, W * pool.element_size(), stream)
    _build.check(err, "page_gather")
    page_gather.launches += 1
    return out


page_gather.launches = 0  # kernel launches since the last ops.reset_kernel_launches()
