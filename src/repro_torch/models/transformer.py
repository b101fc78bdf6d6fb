"""Dense decoder-only transformer (GQA) — the port of
``repro.models.transformer`` for merge-and-serve (decode waits for a later
slice).

Parameters are nested dicts with per-layer blocks ``blocks/<i>/...`` (the
JAX package's ``scan_layers=False`` layout).  Attention goes through
``kernels.ops.flash_attention``: the Hopper kernel on a CUDA tensor, the
plain version on a CPU tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import flatten_paths, torch_dtype


@dataclasses.dataclass(frozen=True)
class DenseLMConfig:
    name: str = "dense-lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1000
    vocab_multiple: int = 256
    rope_theta: float = 1e4
    rotary_pct: float = 1.0  # stablelm uses 0.25
    qkv_bias: bool = False
    qk_norm: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"
    gated_ffn: bool = True
    tie_embeddings: bool = False
    window: Optional[int] = None  # sliding-window attention (all layers)
    logit_softcap: Optional[float] = None
    dtype: str = "float32"  # numpy dtype name

    @property
    def padded_vocab(self) -> int:
        return L.padded_vocab(self.vocab_size, self.vocab_multiple)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(cfg: DenseLMConfig, gen, device) -> dict:
    Hq, Hkv, D, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    dt = cfg.dtype
    p: dict = {
        "attn": {
            "wq": L.init_dense(gen, d, Hq * D, dt, device),
            "wk": L.init_dense(gen, d, Hkv * D, dt, device),
            "wv": L.init_dense(gen, d, Hkv * D, dt, device),
            "wo": L.init_dense(gen, Hq * D, d, dt, device),
        },
        "mlp": L.init_ffn(gen, d, cfg.d_ff, dt, device, gated=cfg.gated_ffn),
        "ln1": L.init_norm(cfg.norm, d, dt, device),
        "ln2": L.init_norm(cfg.norm, d, dt, device),
    }
    tdt = torch_dtype(dt)
    if cfg.qkv_bias:
        for name, width in (("bq", Hq * D), ("bk", Hkv * D), ("bv", Hkv * D)):
            p["attn"][name] = torch.zeros((width,), dtype=tdt, device=device)
    if cfg.qk_norm:
        p["attn"]["q_norm"] = torch.zeros((D,), dtype=tdt, device=device)
        p["attn"]["k_norm"] = torch.zeros((D,), dtype=tdt, device=device)
    return p


def init(cfg: DenseLMConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from ``seed``, generated on ``device`` (default
    ``cuda``; ``meta`` gives shapes only)."""
    device = resolve_device(device)
    gen = L.make_generator(seed, device)
    V = cfg.padded_vocab
    params: dict = {
        "embed": {"table": L.normal(gen, (V, cfg.d_model), 0.02, cfg.dtype, device)},
        "final_norm": L.init_norm(cfg.norm, cfg.d_model, cfg.dtype, device),
        "blocks": {str(i): _init_block(cfg, gen, device)
                   for i in range(cfg.n_layers)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": L.init_dense(gen, cfg.d_model, V, cfg.dtype, device)}
    return params


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def _qkv(cfg: DenseLMConfig, p_attn: dict, x: torch.Tensor, positions: torch.Tensor):
    B, S, _ = x.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.dense(x, p_attn["wq"], p_attn.get("bq")).reshape(B, S, Hq, D)
    k = L.dense(x, p_attn["wk"], p_attn.get("bk")).reshape(B, S, Hkv, D)
    v = L.dense(x, p_attn["wv"], p_attn.get("bv")).reshape(B, S, Hkv, D)
    if cfg.qk_norm:
        q = L.rms_norm(q, p_attn["q_norm"])
        k = L.rms_norm(k, p_attn["k_norm"])
    rd = int(cfg.rotary_pct * D)
    q = L.apply_rope(q, positions, cfg.rope_theta, rd)
    k = L.apply_rope(k, positions, cfg.rope_theta, rd)
    return q, k, v


def _block(cfg: DenseLMConfig, p: dict, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence block over contiguous positions; attention through
    ``ops.flash_attention``.  A non-parametric norm has no leaves, so its
    empty dict does not survive a flat-path round trip (store, bridge):
    norms are looked up with ``.get``."""
    h = L.apply_norm(cfg.norm, x, p.get("ln1", {}))
    q, k, v = _qkv(cfg, p["attn"], h, positions)
    attn = kops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=True, window=cfg.window)
    x = x + L.dense(attn.reshape(x.shape[0], x.shape[1], -1), p["attn"]["wo"])
    h = L.apply_norm(cfg.norm, x, p.get("ln2", {}))
    return x + L.ffn(h, p["mlp"], act=cfg.act, gated=cfg.gated_ffn)


def _softcap(cfg: DenseLMConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.logit_softcap is None:
        return logits
    return torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap


def trunk(cfg: DenseLMConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding + transformer blocks — the mergeable *prefix*.  Returns
    pre-final-norm hidden states (B, S, d)."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    x = L.embed(tokens, params["embed"]["table"])
    for i in range(cfg.n_layers):
        x = _block(cfg, params["blocks"][str(i)], x, positions)
    return x


def head(cfg: DenseLMConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm + unembedding — the private *suffix*.  float32 logits."""
    x = L.apply_norm(cfg.norm, x, params.get("final_norm", {}))
    if cfg.tie_embeddings:
        logits = L.unembed(x, params["embed"]["table"], transpose=True)
    else:
        logits = L.unembed(x, params["lm_head"]["w"], transpose=False)
    return _softcap(cfg, logits)


def forward(cfg: DenseLMConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab) float32.  Composed as
    ``head(trunk(x))`` so the serving split is bitwise identical to it."""
    return head(cfg, params, trunk(cfg, params, tokens))


# ---------------------------------------------------------------------------
# Mergeable split: trunk prefix / head suffix
# ---------------------------------------------------------------------------


def trunk_paths(params: dict) -> frozenset:
    """Flat param paths read by :func:`trunk` (everything outside the
    final-norm/lm-head suffix).  Works on ``meta`` trees."""
    return frozenset(p for p in flatten_paths(params)
                     if not p.startswith(("final_norm/", "lm_head/")))


def head_paths(params: dict) -> frozenset:
    """Flat param paths read by an untied :func:`head` — the private-suffix
    leaves the serving engine stacks into a bank."""
    return frozenset(p for p in flatten_paths(params)
                     if p.startswith(("final_norm/", "lm_head/")))


def bank_head(cfg: DenseLMConfig, bank_params: dict, x: torch.Tensor) -> torch.Tensor:
    """Every private head of a merged group in ONE ``ops.bank_matmul``.

    ``bank_params`` holds the head leaves stacked on a leading bank axis N
    (``ParamStore.materialize_bank``); ``x`` are the shared trunk hidden
    states (B, S, d).  Returns (N, B, S, V): row ``n`` equals :func:`head`
    on member ``n``'s params.  Each member's final norm runs exactly as in
    :func:`head`, then one grouped GEMM unembeds all members."""
    if cfg.tie_embeddings:
        raise ValueError("tied-embedding heads have no bank path")
    n_bank = bank_params["lm_head"]["w"].shape[0]
    fn = bank_params.get("final_norm") or {}
    xn = torch.stack([
        L.apply_norm(cfg.norm, x, {k: v[i] for k, v in fn.items()})
        for i in range(n_bank)])
    B, S, d = x.shape
    logits = kops.bank_matmul(xn.reshape(n_bank, B * S, d),
                              bank_params["lm_head"]["w"])
    return _softcap(cfg, logits.reshape(n_bank, B, S, -1))
