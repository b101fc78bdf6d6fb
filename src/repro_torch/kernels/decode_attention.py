"""Wrapper of the hand-written Hopper decode attention
(``csrc/decode_attention.cu``).

One query per row: q ``(B, Hq, D)`` attends to the caches k, v
``(B, Smax, Hkv, D)`` up to ``lengths[b]`` (int32 ``(B,)``, on the device);
the output has q's dtype.  Head dims 64 and 128 and up to 16 query heads per
kv head are compiled; a row of length 0 gives exact zeros.  This function
takes CUDA tensors only; the ops layer sends CPU tensors to
``ref.decode_attention_ref``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
MAX_GROUP = 16  # query heads per kv head


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    tensors = (q, k_cache, v_cache, lengths)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("decode_attention kernel takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("decode_attention: tensors on different devices")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention: float32 or bfloat16 of one dtype, got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"decode_attention: lengths must be int32, got {lengths.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: q (B,Hq,D), k/v (B,Smax,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    _, Smax, Hkv, _ = k_cache.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != D or Hq % Hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs k {tuple(k_cache.shape)}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"decode_attention: lengths {tuple(lengths.shape)} != {(B,)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not compiled ({HEAD_DIMS})")
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: {Hq // Hkv} query heads per kv head "
                         f"> {MAX_GROUP}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors[:3]):
        raise ValueError("decode_attention: q, k and v must be 16-byte aligned")
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    out = torch.empty_like(q)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, Smax, Hq, Hkv, D, scale, _DTYPES[q.dtype], stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0  # kernel launches since the last ops.reset_kernel_launches()
