"""Wrapper of the hand-written Hopper selective scan (``csrc/mamba_scan.cu``).

    h_t = exp(dt_t ⊗ A) ⊙ h_{t-1} + dtx_t ⊗ B_t,      y_t = h_t · C_t

``dt``, ``dtx`` are ``(B, S, di)`` and ``Bmat``, ``Cmat`` ``(B, S, n)``, all
of one dtype (float32 or bfloat16); ``A`` ``(di, n)`` and ``h0``
``(B, di, n)`` are float32.  Returns ``(y (B, S, di), h_last (B, di, n))``,
both float32.  State dims 8 and 16 are compiled; any S >= 1 is taken, so
the caller pads nothing (the Pallas version needs S divisible by its
chunk).  Two routes, picked by :func:`route` from S alone: ``"step"``
(S = 1, a decode step: a channel's states spread over lanes, no shared
memory) and ``"scan"`` (S > 1: one lane a channel, B and C staged through
shared memory).  Both run the same arithmetic in the same order, so a
scan of S steps and S chained S = 1 launches carrying ``h_last`` give
bitwise equal results.  This function takes CUDA tensors only; the ops
layer sends CPU tensors to ``ref.mamba_scan_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIMS = (8, 16)
ROUTES = ("step", "scan")  # csrc/mamba_scan.cu's route 0 and 1


def route(dt: torch.Tensor) -> str:
    """``"step"`` for one time step (dt ``(B, 1, di)``, a decode step),
    ``"scan"`` for more: a shape's route, whatever its device."""
    return "step" if dt.shape[1] == 1 else "scan"


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
    # the kernel reads these with 16-byte (bf16 B, C: 8-byte) vector loads; a
    # view starting mid-row (a (1, 1, n) slice of a wider projection) is copied
    Bmat, Cmat, A, h0 = (t if t.data_ptr() % 16 == 0 else t.clone()
                         for t in (Bmat, Cmat, A, h0))
    path = route(dt)
    y = torch.empty((B, S, di), dtype=torch.float32, device=dt.device)
    h_last = torch.empty((B, di, n), dtype=torch.float32, device=dt.device)
    lib = _build.load_library()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mamba_scan_launch(
            dt.data_ptr(), dtx.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(), A.data_ptr(),
            h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), B, S, di, n,
            _DTYPES[dt.dtype], ROUTES.index(path), stream)
    _build.check(err, f"mamba_scan ({path})")
    mamba_scan.launches += 1
    mamba_scan.route_launches[path] += 1
    return y, h_last


# kernel launches since the last ops.reset_kernel_launches(), in all and by route
mamba_scan.launches = 0
mamba_scan.route_launches = dict.fromkeys(ROUTES, 0)
