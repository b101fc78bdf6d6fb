"""Wrapper of the hand-written Hopper page gather (``csrc/page_gather.cu``).

    out[i] = pool[page_table[i]]

``pool`` is ``(P, W)`` of any dtype, ``page_table`` ``(N,)`` int32 on the same
device; the output is ``(N, W)`` in the pool's dtype.  The kernel copies
bytes, so it is exact.  An index outside ``[0, P)`` gives a row of zeros.
This function takes CUDA tensors only; the ops layer sends CPU tensors to
``ref.page_gather_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def check_args(pool: torch.Tensor, page_table: torch.Tensor) -> None:
    """Raise on what the kernel does not take: shapes, the table's dtype and
    layout, whatever the tensors' device (meta tensors do)."""
    if pool.device != page_table.device:
        raise ValueError("page_gather: tensors on different devices")
    if page_table.dtype != torch.int32:
        raise TypeError(f"page_gather: table must be int32, got {page_table.dtype}")
    if pool.dim() != 2 or page_table.dim() != 1:
        raise ValueError(f"page_gather: pool (P, W), table (N,); got "
                         f"{tuple(pool.shape)}, {tuple(page_table.shape)}")
    if not (pool.is_contiguous() and page_table.is_contiguous()):
        raise ValueError("page_gather: inputs must be contiguous")


def page_gather(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Returns (N, W) with out[i] = pool[page_table[i]]."""
    if not (pool.is_cuda and page_table.is_cuda):
        raise ValueError("page_gather kernel takes CUDA tensors only")
    check_args(pool, page_table)
    P, W = pool.shape
    (N,) = page_table.shape
    out = torch.empty((N, W), dtype=pool.dtype, device=pool.device)
    lib = _build.load_library()
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.page_gather_launch(pool.data_ptr(), page_table.data_ptr(), out.data_ptr(),
                                     P, N, W * pool.element_size(), stream)
    _build.check(err, "page_gather")
    page_gather.launches += 1
    return out


page_gather.launches = 0  # kernel launches since the last ops.reset_kernel_launches()
