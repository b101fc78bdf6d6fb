"""Wrapper of the hand-written Hopper decode attention
(``csrc/decode_attention.cu``).

One query per row: q ``(B, Hq, D)`` attends to the caches k, v
``(B, Smax, Hkv, D)`` up to ``lengths[b]`` (int32 ``(B,)``, on the device);
the output has q's dtype.  Head dims 64 and 128 and up to 16 query heads per
kv head are compiled; a row of length 0 gives exact zeros.  This function
takes CUDA tensors only; the ops layer sends CPU tensors to
``ref.decode_attention_ref``.

The kernel cuts each row's keys into chunks of :data:`CHUNK` keys
(:func:`row_chunks`), one block per chunk, and merges the chunks' partials
in chunk order inside the same launch.  The partials go to a workspace
sized by :func:`workspace_floats`; the last block of a (row, kv head) is
found through a counter in :func:`_counters`, a zeroed per-device buffer
that every launch leaves at zero.  Launches on one device must therefore be
ordered (one stream, as the port uses), and the first launch of a batch
shape must come before any CUDA-graph capture of it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
MAX_GROUP = 16  # query heads per kv head
CHUNK = 128  # keys per block; csrc/decode_attention.cu's CHUNK, checked at launch

_COUNTERS: dict = {}  # device -> zeroed int32 buffer; earlier, smaller ones stay alive


def row_chunks(length: int) -> list:
    """The ``[start, end)`` key ranges the kernel gives one block each for a
    row of ``length`` valid keys: fixed CHUNK-key cuts of key positions.  A
    row of length 0 has none (one block writes its zeros)."""
    return [(s, min(s + CHUNK, length)) for s in range(0, max(length, 0), CHUNK)]


def grid_chunks(Smax: int) -> int:
    """Blocks the launch gives each (row, kv head): enough for the longest
    row Smax allows, and one for an empty cache."""
    return max(1, -(-Smax // CHUNK))


def chunk_plan(lengths: torch.Tensor, Smax: int) -> list:
    """Per row, the key ranges of the blocks that do work, as the kernel's
    index arithmetic gives them: ``grid_chunks(Smax)`` blocks a (row, kv
    head), block c taking keys ``[c CHUNK, min((c + 1) CHUNK, L))`` of the
    row's length L clamped to ``[0, Smax]`` and returning at once when that
    is empty.  So a row's ranges are ``row_chunks(L)`` whatever B, Smax
    (>= L) and the other rows are."""
    plan = []
    for n in lengths.tolist():
        L = min(max(n, 0), Smax)
        plan.append([(c * CHUNK, min(c * CHUNK + CHUNK, L))
                     for c in range(grid_chunks(Smax)) if c * CHUNK < L])
    return plan


def workspace_floats(q: torch.Tensor, k_cache: torch.Tensor) -> int:
    """float32 words of the chunk partials for q ``(B, Hq, D)`` and a cache
    ``(B, Smax, Hkv, D)`` (acc, then max and sum, per (row, kv head, chunk,
    query head)); 0 when every row fits one chunk.  Shapes only: meta
    tensors do."""
    B, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    chunks = grid_chunks(Smax)
    return 0 if chunks == 1 else B * Hkv * chunks * (Hq // Hkv) * (D + 2)


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters on ``device``, cached.  A buffer
    made during CUDA-graph capture would belong to the graph's pool, so
    growing it there raises."""
    buf = _COUNTERS.get(device)
    if buf is None or buf[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_attention: launch this batch shape once before "
                               "capturing it in a CUDA graph (sizes its counters)")
        buf = (buf or []) + [torch.zeros(max(n, 4096), dtype=torch.int32, device=device)]
        _COUNTERS[device] = buf
    return buf[-1]


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
    nws = workspace_floats(q, k_cache)
    ws = torch.empty(nws, dtype=torch.float32, device=q.device) if nws else None
    counters = _counters(q.device, B * Hkv)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), ws.data_ptr() if ws is not None else None,
            counters.data_ptr(), B, Smax, Hq, Hkv, D, CHUNK, scale, _DTYPES[q.dtype],
            stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0  # kernel launches since the last ops.reset_kernel_launches()
