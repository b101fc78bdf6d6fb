"""Wrapper of the hand-written Hopper RG-LRU recurrence (``csrc/rg_lru.cu``).

    h_t = a_t ⊙ h_{t-1} + b_t,      y_t = h_t

``a``, ``b`` are ``(B, S, d)`` of one dtype (float32 or bfloat16), ``h0``
``(B, d)`` float32 or bfloat16, widened to float32 on load.  Returns ``(y (B, S, d), h_last (B, d))``, both
float32.  Any S >= 1 is taken, so the caller pads nothing (the Pallas
version needs S divisible by its chunk).  Three routes, picked by
:func:`route` from shape and alignment alone: ``"scan"`` (S > 1: TMA boxes
of a and b through a shared-memory ring), ``"step"`` (S = 1, a decode
step: 16-byte vector accesses, no loop) and ``"plain"`` (rows that are not
a multiple of 16 bytes, or data not 16-byte aligned: one thread a channel,
scalar accesses).  All three compute ``fma(a_t, h, b_t)`` in time order,
so a scan of S steps and S chained S = 1 launches carrying ``h_last`` give
bitwise equal results.  This function takes CUDA tensors only; the ops
layer sends CPU tensors to ``ref.rg_lru_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("scan", "step", "plain")  # csrc/rg_lru.cu's route 0, 1 and 2


def route(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> str:
    """``"plain"`` unless every row is a multiple of 16 bytes and ``a``,
    ``b`` and ``h0`` start on 16-byte boundaries (which such tensors do
    unless one is a view starting mid-row); else ``"step"`` for one time
    step (a ``(B, 1, d)``, a decode step) and ``"scan"`` for more: a
    shape's route, whatever its device."""
    aligned = (a.shape[2] * a.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (a, b, h0))
    if not aligned:
        return "plain"
    return "step" if a.shape[1] == 1 else "scan"


def check_args(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> None:
    """Raise on what the kernel does not take: shapes, dtypes and layout,
    whatever the tensors' device (meta tensors do)."""
    if len({a.device, b.device, h0.device}) != 1:
        raise ValueError("rg_lru_scan: tensors on different devices")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"rg_lru_scan: a, b float32 or bfloat16 of one dtype, got "
                        f"{a.dtype}, {b.dtype}")
    if h0.dtype not in _DTYPES:
        raise TypeError(f"rg_lru_scan: h0 float32 or bfloat16, got {h0.dtype}")
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"rg_lru_scan: a, b (B,S,d), h0 (B,d); got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(h0.shape)}")
    if not (a.is_contiguous() and b.is_contiguous() and h0.is_contiguous()):
        raise ValueError("rg_lru_scan: inputs must be contiguous")


def rg_lru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> tuple:
    if not (a.is_cuda and b.is_cuda and h0.is_cuda):
        raise ValueError("rg_lru_scan kernel takes CUDA tensors only")
    check_args(a, b, h0)
    # widened on load, as the Pallas kernel does: a float32 copy of a bf16
    # value is exact, so this equals the call with a float32 h0
    h0 = h0.float()
    B, S, d = a.shape
    path = route(a, b, h0)
    y = torch.empty((B, S, d), dtype=torch.float32, device=a.device)
    h_last = torch.empty((B, d), dtype=torch.float32, device=a.device)
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rg_lru_launch(a.data_ptr(), b.data_ptr(), h0.data_ptr(), y.data_ptr(),
                                h_last.data_ptr(), B, S, d, _DTYPES[a.dtype],
                                ROUTES.index(path), stream)
    _build.check(err, f"rg_lru_scan ({path})")
    rg_lru_scan.launches += 1
    rg_lru_scan.route_launches[path] += 1
    return y, h_last


# kernel launches since the last ops.reset_kernel_launches(), in all and by route
rg_lru_scan.launches = 0
rg_lru_scan.route_launches = dict.fromkeys(ROUTES, 0)
