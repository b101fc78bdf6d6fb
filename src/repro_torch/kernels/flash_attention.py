"""Wrapper of the hand-written Hopper flash attention (``csrc/flash_attention.cu``).

Causal or sliding-window grouped-query attention over q ``(B, S, Hq, D)``
and k, v ``(B, S, Hkv, D)``; the output has q's dtype.  Head dims 16, 64,
128 and 256 are compiled; ragged S is masked by the kernel.  Two kernels,
picked by :func:`route` from dtype and head dim alone: bf16 takes the
tensor-core kernel (``"mma"``), float32 the CUDA-core one (``"simt"``).
This function takes CUDA tensors only; the ops layer sends CPU tensors to
``ref.flash_attention_ref``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 64, 128, 256)
ROUTES = ("mma", "simt")


def route(q: torch.Tensor) -> str:
    """``"mma"`` (tensor cores, bf16 tiles) for bf16 q (k and v share its
    dtype) at a compiled head dim, else ``"simt"``.  float32 stays on CUDA
    cores: TF32 would keep about three digits where the reference sums f32
    products."""
    return "mma" if q.dtype == torch.bfloat16 and q.shape[-1] in HEAD_DIMS else "simt"


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
               window: Optional[int] = None, scale: Optional[float] = None) -> None:
    """Raise on what the kernel does not take: shapes, dtypes, head dims
    and layout, whatever the tensors' device (meta tensors do)."""
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: tensors on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: float32 or bfloat16 of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: q (B,S,Hq,D), k/v (B,S,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not compiled ({HEAD_DIMS})")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: inputs must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention kernel takes CUDA tensors only")
    check_args(q, k, v, causal, window, scale)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    path = route(q)
    out = torch.empty_like(q)
    lib = _build.load_library()
    launch = lib.flash_attention_mma_launch if path == "mma" else lib.flash_attention_simt_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B, S, Hq, Hkv, D, int(causal), 0 if window is None else int(window),
                     scale, stream)
    _build.check(err, f"flash_attention ({path})")
    flash_attention.launches += 1
    flash_attention.route_launches[path] += 1
    return out


# kernel launches since the last ops.reset_kernel_launches(), in all and by route
flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
