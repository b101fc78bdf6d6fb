"""Shared primitive layers (the port of ``repro.models.layers``).

Pure functions over explicit parameter dicts, so the merging engine can
address every weight by its path.  Conventions follow the JAX package:

  * activations (batch, seq, d_model); heads as separate axes,
    q (B, S, Hq, D), kv (B, S, Hkv, D);
  * matmuls accumulate in float32.  ``dense`` rounds once to the
    activation dtype; ``unembed`` returns the float32 sums (logits).  A
    bf16 ``torch.matmul`` would round the logits to bf16, so on a CUDA
    tensor ``unembed`` asks cuBLAS for bf16 operands with a float32 output
    (a tensor-core GEMM that reads the table as it is stored), and on a CPU
    tensor, where that call does not exist, it widens both operands first.
    The two compute the same function: bf16 products are exact in f32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.utils.tree import torch_dtype

# ---------------------------------------------------------------------------
# Init helpers (explicit generators; ``meta`` builds shapes only)
# ---------------------------------------------------------------------------


def make_generator(seed: int, device: torch.device) -> Optional[torch.Generator]:
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(int(seed))


def normal(gen: Optional[torch.Generator], shape: tuple, scale: float, dtype,
           device: torch.device) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in float32, then cast to ``dtype``."""
    dtype = torch_dtype(dtype)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def uniform(gen: Optional[torch.Generator], shape: tuple, low: float, high: float,
            device: torch.device) -> torch.Tensor:
    """``U(low, high)`` in float32."""
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return low + (high - low) * torch.rand(shape, generator=gen, device=device)


def init_dense(gen, d_in: int, d_out: int, dtype, device, scale: float = 1.0):
    return normal(gen, (d_in, d_out), scale / math.sqrt(d_in), dtype, device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: Optional[torch.Tensor], eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())  # scale stored as gamma offset (1+g)
    return y.to(dt)


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float = 1e-5):
    """LayerNorm; pass ``scale=bias=None`` for non-parametric LN."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def apply_norm(kind: str, x: torch.Tensor, params: dict) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"])
    if kind == "layernorm":
        return layer_norm(x, params["scale"], params.get("bias"))
    if kind == "nonparam_ln":
        return layer_norm(x, None, None)
    raise ValueError(f"unknown norm kind: {kind}")


def init_norm(kind: str, d: int, dtype, device) -> dict:
    dtype = torch_dtype(dtype)
    if kind == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "nonparam_ln":
        return {}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Rotary position embedding (partial rotary, e.g. StableLM pct=0.25)
# ---------------------------------------------------------------------------


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_dim: int) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int. Rotates the first ``rotary_dim``."""
    dt = x.dtype
    d = x.shape[-1]
    rotary_dim = min(rotary_dim, d)
    exponents = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                             device=x.device) / rotary_dim
    freqs = 1.0 / (theta ** exponents)  # (rd/2,)
    angles = positions[..., None].float() * freqs  # (B, S, rd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :rotary_dim].float().chunk(2, dim=-1)
    out_rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dt)
    if rotary_dim < d:
        return torch.cat([out_rot, x[..., rotary_dim:]], dim=-1)
    return out_rot


# ---------------------------------------------------------------------------
# Attention (plain versions: multi-token decode steps against a cache,
# explicit positions, a prefill over explicit positions)
# ---------------------------------------------------------------------------


def attention_mask(q_positions: torch.Tensor, kv_positions: torch.Tensor,
                   causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Boolean mask (B, 1, Sq, Skv): True = attend.  ``window`` gives
    sliding-window attention: attend iff 0 <= q_pos - kv_pos < window."""
    qp = q_positions[:, None, :, None]
    kp = kv_positions[:, None, None, :]
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
                      device=qp.device)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (qp - kp < window)
    return mask


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, scale: Optional[float] = None,
                  logit_softcap: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), mask
    (B, 1, Sq, Skv).  Scores and P @ V accumulate in float32 (bf16 inputs are
    widened first: their products are exact in float32); the probabilities
    are rounded to v's dtype before P @ V, as the JAX package does.  Returns
    (B, Sq, Hq, D) in q's dtype."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    scale = (1.0 / math.sqrt(D)) if scale is None else scale
    qg = q.reshape(B, Sq, Hkv, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if logit_softcap is not None:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    if mask is not None:
        scores = scores.masked_fill(~mask[:, :, None, :, :], torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def blocked_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             positions: torch.Tensor, window: Optional[int] = None,
                             block_q: int = 1024) -> torch.Tensor:
    """Causal (optionally sliding-window) attention one query block at a
    time, so only (B, H, block_q, S_kv) scores are live: q (B, S, Hq, D),
    k/v (B, S, Hkv, D), positions (B, S).  With a ``window`` each block
    reads a key span of ``window + block_q`` (the last ``S`` at most).  When
    ``block_q`` does not divide S it is :func:`gqa_attention` with the full
    mask.  Plain torch, as the JAX package's is outside any Pallas kernel."""
    B, S, Hq, D = q.shape
    if S % block_q:
        return gqa_attention(q, k, v, attention_mask(positions, positions, True, window))
    span = S if window is None else min(window + block_q, S)
    outs = []
    for s0 in range(0, S, block_q):
        start = max(0, s0 + block_q - span)
        kv_pos = torch.arange(start, start + span, dtype=torch.int32,
                              device=q.device).expand(B, span)
        mask = attention_mask(positions[:, s0:s0 + block_q], kv_pos, causal=True,
                              window=window)
        outs.append(gqa_attention(q[:, s0:s0 + block_q], k[:, start:start + span],
                                  v[:, start:start + span], mask))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Dense projections / FFN
# ---------------------------------------------------------------------------


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
    """x @ w (+ b), float32 accumulation, one rounding to x's dtype — the
    reference's ``einsum(preferred_element_type=f32).astype(x.dtype)``.
    Without a bias one same-dtype GEMM does exactly that (float32 and bf16
    GEMMs accumulate in float32 on the card and on the CPU).  A weight of
    another dtype than x (a float32 buffer shipped to a bf16 model) is
    promoted as ``jnp`` promotes the pair: both widened to float32."""
    if b is None and w.dtype == x.dtype:
        return torch.matmul(x, w)
    out = torch.matmul(x.float(), w.float())
    return (out if b is None else out + b.float()).to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it (``logaddexp(x,
    0)``); ``F.softplus`` switches to x above a threshold instead."""
    return torch.logaddexp(x, torch.zeros_like(x))


_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def ffn(x: torch.Tensor, params: dict, act: str = "silu", gated: bool = True):
    a = _ACTS[act]
    if gated:
        g = dense(x, params["w_gate"])
        u = dense(x, params["w_up"])
        return dense(a(g) * u, params["w_down"])
    h = dense(x, params["w_up"], params.get("b_up"))
    return dense(a(h), params["w_down"], params.get("b_down"))


def init_ffn(gen, d_model: int, d_ff: int, dtype, device, gated: bool = True,
             bias: bool = False) -> dict:
    """Gated (``w_gate``, ``w_up``, ``w_down``) or plain (``w_up``,
    ``w_down``, with zero ``b_up`` / ``b_down`` when ``bias``) weights."""
    s_in, s_ff = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    p = {}
    if gated:
        p["w_gate"] = normal(gen, (d_model, d_ff), s_in, dtype, device)
    p["w_up"] = normal(gen, (d_model, d_ff), s_in, dtype, device)
    p["w_down"] = normal(gen, (d_ff, d_model), s_ff, dtype, device)
    if bias and not gated:
        p["b_up"] = torch.zeros((d_ff,), dtype=torch_dtype(dtype), device=device)
        p["b_down"] = torch.zeros((d_model,), dtype=torch_dtype(dtype), device=device)
    return p


# ---------------------------------------------------------------------------
# Embedding / unembedding with vocab padding
# ---------------------------------------------------------------------------


def padded_vocab(vocab_size: int, multiple: int = 256) -> int:
    return int(-(-vocab_size // multiple) * multiple)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table_or_head: torch.Tensor, transpose: bool):
    """float32 logits over the *padded* vocab; caller slices real vocab.
    ``transpose`` takes a tied (V, d) embedding table, else a (d, V) head.
    Half-precision operands on the card go through one cuBLAS GEMM with a
    float32 output on the 2-D view (no float32 copy of the table); that
    GEMM has no derivative in torch, so under autograd (training) the
    float32 product below runs on the card too.  ``meta`` tensors take the
    card's route (the dry run counts what the card runs)."""
    w = table_or_head.t() if transpose else table_or_head
    recorded = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if (x.device.type in ("cuda", "meta") and x.dtype in (torch.bfloat16, torch.float16) and w.dtype == x.dtype
            and not recorded):
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          valid_vocab: Optional[int] = None,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; padded vocab ids masked out of the
    partition by adding float32's lowest value to their logits."""
    logits = logits.float()
    V = logits.shape[-1]
    if valid_vocab is not None and valid_vocab < V:
        neg = torch.full((V - valid_vocab,), torch.finfo(torch.float32).min,
                         device=logits.device)
        logits = logits + torch.cat([torch.zeros(valid_vocab, device=logits.device), neg])
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
