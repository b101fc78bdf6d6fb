"""Wrapper of the hand-written Hopper selective scan (``csrc/mamba_scan.cu``).

    h_t = exp(dt_t ⊗ A) ⊙ h_{t-1} + dtx_t ⊗ B_t,      y_t = h_t · C_t

``dt``, ``dtx`` are ``(B, S, di)`` and ``Bmat``, ``Cmat`` ``(B, S, n)``, all
of one dtype (float32 or bfloat16); ``A`` ``(di, n)`` and ``h0``
``(B, di, n)`` are float32.  Returns ``(y (B, S, di), h_last (B, di, n))``,
both float32.  State dims 8 and 16 are compiled; any S >= 1 is taken, so
the caller pads nothing (the Pallas version needs S divisible by its
chunk).  This function takes CUDA tensors only; the ops layer sends CPU
tensors to ``ref.mamba_scan_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIMS = (8, 16)


def mamba_scan(dt: torch.Tensor, dtx: torch.Tensor, Bmat: torch.Tensor,
               Cmat: torch.Tensor, A: torch.Tensor, h0: torch.Tensor) -> tuple:
    tensors = (dt, dtx, Bmat, Cmat, A, h0)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("mamba_scan kernel takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("mamba_scan: tensors on different devices")
    if dt.dtype not in _DTYPES or any(t.dtype != dt.dtype for t in (dtx, Bmat, Cmat)):
        raise TypeError(f"mamba_scan: dt, dtx, Bmat, Cmat float32 or bfloat16 of one "
                        f"dtype, got {dt.dtype}, {dtx.dtype}, {Bmat.dtype}, {Cmat.dtype}")
    if A.dtype != torch.float32 or h0.dtype != torch.float32:
        raise TypeError(f"mamba_scan: A and h0 must be float32, got {A.dtype}, {h0.dtype}")
    if dt.dim() != 3 or A.dim() != 2:
        raise ValueError(f"mamba_scan: dt (B,S,di), A (di,n); got {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}")
    B, S, di = dt.shape
    n = A.shape[1]
    if (dtx.shape != dt.shape or Bmat.shape != (B, S, n) or Cmat.shape != (B, S, n)
            or A.shape != (di, n) or h0.shape != (B, di, n)):
        raise ValueError(
            f"mamba_scan: dt/dtx (B,S,di), Bmat/Cmat (B,S,n), A (di,n), h0 (B,di,n); got "
            f"{[tuple(t.shape) for t in tensors]}")
    if n not in STATE_DIMS:
        raise ValueError(f"mamba_scan: state dim {n} not compiled ({STATE_DIMS})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mamba_scan: inputs must be contiguous")
    y = torch.empty((B, S, di), dtype=torch.float32, device=dt.device)
    h_last = torch.empty((B, di, n), dtype=torch.float32, device=dt.device)
    lib = _build.load_library()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mamba_scan_launch(
            dt.data_ptr(), dtx.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(), A.data_ptr(),
            h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), B, S, di, n,
            _DTYPES[dt.dtype], stream)
    _build.check(err, "mamba_scan")
    mamba_scan.launches += 1
    return y, h_last


mamba_scan.launches = 0  # kernel launches since the last ops.reset_kernel_launches()
