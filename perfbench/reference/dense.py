"""Plain float32 reference of a dense decoder-only transformer
(stablelm-2 style): pre-norm blocks of LayerNorm, multi-head attention with
rotary position embedding on the first ``rotary_pct`` of each head
(rotate-half pairing, base ``rope_theta``), a causal softmax, the output
projection, and a SiLU-gated feed-forward; a final LayerNorm and an untied
unembedding.

Departure noted in the configuration file: the published stablelm-2-1.6b
has q/k/v biases (``use_qkv_bias``); the configuration as run has none.

Layer by layer: each block's weights are drawn again from the seed
(:mod:`perfbench.weights`), widened to float32, applied to every sequence
and freed, so the whole model is never held.  ``fp8=True`` is the
control: every matrix product takes fp8 e4m3 weights (per output column)
and activations (per row), dequantized into float32.
"""
from __future__ import annotations

import math

import torch

from perfbench.reference.common import linear, unit_weights


def layout(cfg: dict) -> dict:
    """{path: (shape, dtype)} of the configuration's parameters."""
    d, H, D, F = cfg["d_model"], cfg["n_heads"], cfg["head_dim"], cfg["d_ff"]
    Hkv = cfg["n_kv_heads"]
    V = -(-cfg["vocab_size"] // cfg["vocab_multiple"]) * cfg["vocab_multiple"]
    dt = getattr(torch, cfg["dtype"])
    out = {"embed/table": ((V, d), dt), "final_norm/scale": ((d,), dt),
           "final_norm/bias": ((d,), dt), "lm_head/w": ((d, V), dt)}
    for i in range(cfg["n_layers"]):
        b = f"blocks/{i}/"
        out.update({
            b + "attn/wq": ((d, H * D), dt), b + "attn/wk": ((d, Hkv * D), dt),
            b + "attn/wv": ((d, Hkv * D), dt), b + "attn/wo": ((H * D, d), dt),
            b + "mlp/w_gate": ((d, F), dt), b + "mlp/w_up": ((d, F), dt),
            b + "mlp/w_down": ((F, d), dt),
            b + "ln1/scale": ((d,), dt), b + "ln1/bias": ((d,), dt),
            b + "ln2/scale": ((d,), dt), b + "ln2/bias": ((d,), dt),
        })
    return out


def layer_norm(x, scale, bias, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def rope(x, positions, rotary_dim: int, theta: float):
    """Rotate the first ``rotary_dim`` channels of each head: the pairs
    (i, i + rotary_dim / 2) by angle position * theta^(-2i / rotary_dim)."""
    half = rotary_dim // 2
    freqs = theta ** (-torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                                    device=x.device) / rotary_dim)
    ang = positions[:, None].float() * freqs[None]  # (S, half)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:rotary_dim]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., rotary_dim:]], -1)


def attention(q, k, v):
    """Causal softmax attention of one sequence: q (S, H, D), k/v (S, Hkv, D)."""
    S, H, D = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(D)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)


def trunk(cfg: dict, seed: int, donor: int, seqs: list, device, fp8: bool = False) -> list:
    """The merged trunk (the donor's weights) over each token sequence:
    [(S_j, d) float32 hidden states before the final norm]."""
    lay = layout(cfg)
    H, Hkv, D = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    rd = int(cfg["rotary_pct"] * D)
    table = unit_weights(cfg, lay, seed, donor, "embed", device)["embed/table"]
    xs = [table[torch.as_tensor(s, device=device).long()] for s in seqs]
    del table
    for i in range(cfg["n_layers"]):
        w = unit_weights(cfg, lay, seed, donor, f"blocks/{i}", device)
        p = lambda name: w[f"blocks/{i}/{name}"]  # noqa: E731
        for j, x in enumerate(xs):
            S = x.shape[0]
            pos = torch.arange(S, device=device)
            h = layer_norm(x, p("ln1/scale"), p("ln1/bias"))
            q = rope(linear(h, p("attn/wq"), fp8).view(S, H, D), pos, rd, cfg["rope_theta"])
            k = rope(linear(h, p("attn/wk"), fp8).view(S, Hkv, D), pos, rd, cfg["rope_theta"])
            v = linear(h, p("attn/wv"), fp8).view(S, Hkv, D)
            x = x + linear(attention(q, k, v).reshape(S, H * D), p("attn/wo"), fp8)
            h = layer_norm(x, p("ln2/scale"), p("ln2/bias"))
            ff = torch.nn.functional.silu(linear(h, p("mlp/w_gate"), fp8)) * linear(
                h, p("mlp/w_up"), fp8)
            xs[j] = x + linear(ff, p("mlp/w_down"), fp8)
        del w
    return xs


def head(cfg: dict, seed: int, member: int, x, device, fp8: bool = False):
    """A member's final norm and unembedding: x (P, d) -> logits (P, V)."""
    w = unit_weights(cfg, layout(cfg), seed, member, "head", device)
    h = layer_norm(x, w["final_norm/scale"], w["final_norm/bias"])
    return linear(h, w["lm_head/w"], fp8)
