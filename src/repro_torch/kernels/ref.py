"""Plain PyTorch versions of the ported kernels (mirror ``repro.kernels.ref``).

Each is the semantic ground truth its Hopper kernel is held against: the
CPU tests use them, the ops layer dispatches CPU tensors to them, and
``chip_smoke.py`` compares every kernel with them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,  # (B, S, Hkv, D)
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = (1.0 / math.sqrt(D)) if scale is None else scale
    qg = q.reshape(B, S, Hkv, G, D).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= (qp - kp) < window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,  # (B, Hq, D) single-step query
    k_cache: torch.Tensor,  # (B, Smax, Hkv, D)
    v_cache: torch.Tensor,  # (B, Smax, Hkv, D)
    lengths: torch.Tensor,  # (B,) valid prefix length per row
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = (1.0 / math.sqrt(D)) if scale is None else scale
    qg = q.reshape(B, Hkv, G, D).float()
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale
    valid = (torch.arange(Smax, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])  # (B, Smax)
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    # softmax made safe for fully-masked rows (length 0): the kernel's online
    # softmax emits exact zeros there (l == 0 guard), so this version must
    # too -- torch.softmax would give NaN from exp(-inf - (-inf))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    probs = p / torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v_cache.float())
    return out.reshape(B, Hq, D).to(q.dtype)


def page_gather_ref(
    pool: torch.Tensor,  # (P, page)
    page_table: torch.Tensor,  # (N,) int32 indices into pool
) -> torch.Tensor:
    """out[i] = pool[page_table[i]], in the pool's dtype."""
    return pool.index_select(0, page_table)


def bank_matmul_ref(
    x: torch.Tensor,  # (N, M, K) banked, or (M, K) broadcast across the bank
    w: torch.Tensor,  # (N, K, F) stacked private weights
    b: Optional[torch.Tensor] = None,  # (N, F) stacked biases
) -> torch.Tensor:
    """Suffix-bank grouped GEMM: out[n] = x[n] @ w[n] (+ b[n]) in float32.
    Deliberately an UNROLLED loop of the exact per-member contraction (not
    one batched call): each member's product is the same ``matmul`` the
    per-member head runs, which keeps bank == per-member bitwise on the CPU.
    Inputs are widened to float32 first: bf16 products are exact in f32, so
    this is f32 accumulation, and a bf16 matmul would round the output."""
    outs = []
    for i in range(w.shape[0]):
        xi = x if x.dim() == 2 else x[i]
        o = torch.matmul(xi.float(), w[i].float())
        if b is not None:
            o = o + b[i].float()
        outs.append(o)
    return torch.stack(outs)


def rg_lru_ref(
    a: torch.Tensor,  # (B, S, d) per-step decay
    b: torch.Tensor,  # (B, S, d) per-step input
    h0: torch.Tensor,  # (B, d)
) -> tuple:
    """Diagonal recurrence h_t = a_t * h_{t-1} + b_t, a loop over S in
    float32.  Returns (y (B, S, d), h_last (B, d)), both float32."""
    a, b = a.float(), b.float()
    h = h0.float()
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1), h


def mamba_scan_ref(
    dt: torch.Tensor,  # (B, S, di)
    dtx: torch.Tensor,  # (B, S, di) == dt * x
    Bmat: torch.Tensor,  # (B, S, n)
    Cmat: torch.Tensor,  # (B, S, n)
    A: torch.Tensor,  # (di, n), negative
    h0: torch.Tensor,  # (B, di, n)
) -> tuple:
    """Selective scan h_t = exp(dt_t A) h_{t-1} + dtx_t B_t, y_t = C_t . h_t,
    a loop over S in float32 that forms one (B, di, n) step at a time.
    Returns (y (B, S, di), h_last (B, di, n)), both float32."""
    dt, dtx, Bmat, Cmat = dt.float(), dtx.float(), Bmat.float(), Cmat.float()
    A = A.float()
    h = h0.float()
    ys = []
    for t in range(dt.shape[1]):
        at = torch.exp(dt[:, t, :, None] * A)  # (B, di, n)
        h = at * h + dtx[:, t, :, None] * Bmat[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cmat[:, t]))
    return torch.stack(ys, dim=1), h
