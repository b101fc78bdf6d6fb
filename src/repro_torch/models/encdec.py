"""Encoder-decoder transformer (seamless-m4t-medium's text backbone) — the
port of ``repro.models.encdec``.

The speech frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings (B, S_src, d_model).  The decoder is a causal
transformer with cross-attention; decode keeps a self-attention KV cache and
the cross-attention K/V computed once from the encoder output.  Every
attention here is ``layers.gqa_attention`` in plain torch: the JAX
package's is outside any Pallas kernel too.  Parameters are nested dicts
with per-layer blocks ``enc_blocks/<i>/...`` and ``dec_blocks/<i>/...``
(the JAX package's ``scan_layers=False`` layout).  Decode writes the
self-attention cache and advances ``length`` (a 0-d int32 tensor on the
cache's device) in place.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import torch_dtype


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str = "encdec-lm"
    n_enc_layers: int = 4
    n_dec_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1000
    vocab_multiple: int = 256
    rope_theta: float = 1e4
    norm: str = "layernorm"
    act: str = "relu"
    gated_ffn: bool = False
    tie_embeddings: bool = True
    dtype: str = "float32"  # numpy dtype name
    kv_repl: int = 1

    @property
    def padded_vocab(self) -> int:
        return L.padded_vocab(self.vocab_size, self.vocab_multiple)

    @property
    def n_layers(self) -> int:  # the decoder-only configs' name for the decode depth
        return self.n_dec_layers

    @property
    def kv_stored_heads(self) -> int:
        return self.n_kv_heads * self.kv_repl


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_attn(cfg: EncDecConfig, gen, device) -> dict:
    Hq, Hkv, D, d, dt = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model, cfg.dtype
    return {"wq": L.init_dense(gen, d, Hq * D, dt, device),
            "wk": L.init_dense(gen, d, Hkv * D, dt, device),
            "wv": L.init_dense(gen, d, Hkv * D, dt, device),
            "wo": L.init_dense(gen, Hq * D, d, dt, device)}


def _init_layer(cfg: EncDecConfig, gen, device, decoder: bool) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    attn = ("self_attn", "cross_attn") if decoder else ("attn",)
    p = {name: _init_attn(cfg, gen, device) for name in attn}
    p["mlp"] = L.init_ffn(gen, d, cfg.d_ff, dt, device, gated=cfg.gated_ffn, bias=True)
    for n in ("ln1", "ln2", "ln3") if decoder else ("ln1", "ln2"):
        p[n] = L.init_norm(cfg.norm, d, dt, device)
    return p


def init(cfg: EncDecConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from ``seed``, generated on ``device`` (default
    ``cuda``; ``meta`` gives shapes only)."""
    device = resolve_device(device)
    gen = L.make_generator(seed, device)
    V, d, dt = cfg.padded_vocab, cfg.d_model, cfg.dtype
    params: dict = {
        "embed": {"table": L.normal(gen, (V, d), 0.02, dt, device)},
        "enc_final_norm": L.init_norm(cfg.norm, d, dt, device),
        "final_norm": L.init_norm(cfg.norm, d, dt, device),
        "enc_blocks": {str(i): _init_layer(cfg, gen, device, decoder=False)
                       for i in range(cfg.n_enc_layers)},
        "dec_blocks": {str(i): _init_layer(cfg, gen, device, decoder=True)
                       for i in range(cfg.n_dec_layers)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": L.init_dense(gen, d, V, dt, device)}
    return params


# ---------------------------------------------------------------------------
# Encoder / decoder forward
# ---------------------------------------------------------------------------


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _mha(cfg: EncDecConfig, p: dict, xq: torch.Tensor, xkv: torch.Tensor,
         q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool) -> torch.Tensor:
    """Attention of xq (B, Sq, d) over xkv (B, Skv, d).  Only the causal
    (decoder self-attention) path rotates q and k by their positions and
    masks, as in the JAX package."""
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.dense(xq, p["wq"]).reshape(B, Sq, Hq, D)
    k = L.dense(xkv, p["wk"]).reshape(B, Skv, Hkv, D)
    v = L.dense(xkv, p["wv"]).reshape(B, Skv, Hkv, D)
    mask = None
    if causal:
        q = L.apply_rope(q, q_pos, cfg.rope_theta, D)
        k = L.apply_rope(k, kv_pos, cfg.rope_theta, D)
        mask = L.attention_mask(q_pos, kv_pos, causal=True)
    attn = L.gqa_attention(q, k, v, mask)
    return L.dense(attn.reshape(B, Sq, -1), p["wo"])


def _unembed(cfg: EncDecConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(cfg.norm, x, params.get("final_norm", {}))
    if cfg.tie_embeddings:
        return L.unembed(x, params["embed"]["table"], transpose=True)
    return L.unembed(x, params["lm_head"]["w"], transpose=False)


def encode(cfg: EncDecConfig, params: dict, src_embeds: torch.Tensor) -> torch.Tensor:
    """src_embeds (B, S_src, d_model) precomputed frontend features ->
    encoder output (B, S_src, d_model), bidirectional."""
    B, S, _ = src_embeds.shape
    pos = _positions(B, S, src_embeds.device)
    x = src_embeds.to(torch_dtype(cfg.dtype))
    for i in range(cfg.n_enc_layers):
        p = params["enc_blocks"][str(i)]
        h = L.apply_norm(cfg.norm, x, p.get("ln1", {}))
        x = x + _mha(cfg, p["attn"], h, h, pos, pos, causal=False)
        h = L.apply_norm(cfg.norm, x, p.get("ln2", {}))
        x = x + L.ffn(h, p["mlp"], act=cfg.act, gated=cfg.gated_ffn)
    return L.apply_norm(cfg.norm, x, params.get("enc_final_norm", {}))


def decode_train(cfg: EncDecConfig, params: dict, enc_out: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder pass: logits (B, S_tgt, V) float32."""
    B, S = tokens.shape
    pos = _positions(B, S, tokens.device)
    src_pos = _positions(B, enc_out.shape[1], tokens.device)
    x = L.embed(tokens, params["embed"]["table"])
    for i in range(cfg.n_dec_layers):
        p = params["dec_blocks"][str(i)]
        h = L.apply_norm(cfg.norm, x, p.get("ln1", {}))
        x = x + _mha(cfg, p["self_attn"], h, h, pos, pos, causal=True)
        h = L.apply_norm(cfg.norm, x, p.get("ln2", {}))
        x = x + _mha(cfg, p["cross_attn"], h, enc_out, pos, src_pos, causal=False)
        h = L.apply_norm(cfg.norm, x, p.get("ln3", {}))
        x = x + L.ffn(h, p["mlp"], act=cfg.act, gated=cfg.gated_ffn)
    return _unembed(cfg, params, x)


def forward(cfg: EncDecConfig, params: dict, src_embeds: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    return decode_train(cfg, params, encode(cfg, params, src_embeds), tokens)


def loss_fn(cfg: EncDecConfig, params: dict, batch: dict) -> torch.Tensor:
    logits = forward(cfg, params, batch["src_embeds"], batch["tokens"])
    return L.softmax_cross_entropy(logits, batch["labels"], valid_vocab=cfg.vocab_size,
                                   mask=batch.get("mask"))


# ---------------------------------------------------------------------------
# Incremental decode: self-attention KV cache + precomputed cross K/V
# ---------------------------------------------------------------------------


def _repl(cfg: EncDecConfig, t: torch.Tensor) -> torch.Tensor:
    return t.repeat_interleave(cfg.kv_repl, dim=2) if cfg.kv_repl > 1 else t


def init_cache(cfg: EncDecConfig, params: dict, enc_out: torch.Tensor, batch: int,
               max_len: int, dtype=None) -> dict:
    """The decode cache on ``enc_out``'s device: self-attention k/v (Ld, B,
    Smax, Hs, D) of zeros, the cross-attention K/V of every decoder layer
    from ``enc_out`` (Ld, B, S_src, Hs, D), and ``length`` 0."""
    dt = torch_dtype(dtype or cfg.dtype)
    Ld, Hkv, D = cfg.n_dec_layers, cfg.n_kv_heads, cfg.head_dim
    S_src, dev = enc_out.shape[1], enc_out.device
    ck, cv = [], []
    for i in range(Ld):
        p = params["dec_blocks"][str(i)]["cross_attn"]
        ck.append(_repl(cfg, L.dense(enc_out, p["wk"]).reshape(batch, S_src, Hkv, D)).to(dt))
        cv.append(_repl(cfg, L.dense(enc_out, p["wv"]).reshape(batch, S_src, Hkv, D)).to(dt))
    shape = (Ld, batch, max_len, cfg.kv_stored_heads, D)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "cross": {"k": torch.stack(ck), "v": torch.stack(cv)},
            "length": torch.zeros((), dtype=torch.int32, device=dev)}


def decode_step(cfg: EncDecConfig, params: dict, cache: dict,
                tokens: torch.Tensor) -> tuple:
    """tokens (B, S_new) -> (logits (B, S_new, V) float32, cache with the new
    self-attention k/v written and ``length`` advanced in place).  The cross
    K/V are reused."""
    B, Sn = tokens.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    length = cache["length"]
    pos = (length + torch.arange(Sn, dtype=torch.int32, device=tokens.device)).expand(B, Sn)
    x = L.embed(tokens, params["embed"]["table"])
    Smax = cache["k"].shape[2]
    kv_pos = _positions(B, Smax, tokens.device)
    mask = L.attention_mask(pos, kv_pos, causal=True)
    mask = mask & (kv_pos < (length + Sn))[:, None, None, :]
    for i in range(cfg.n_dec_layers):
        p = params["dec_blocks"][str(i)]
        ck, cv = cache["k"][i], cache["v"][i]
        h = L.apply_norm(cfg.norm, x, p.get("ln1", {}))
        sa = p["self_attn"]
        q = L.apply_rope(L.dense(h, sa["wq"]).reshape(B, Sn, Hq, D), pos, cfg.rope_theta, D)
        k = L.apply_rope(L.dense(h, sa["wk"]).reshape(B, Sn, Hkv, D), pos, cfg.rope_theta, D)
        v = L.dense(h, sa["wv"]).reshape(B, Sn, Hkv, D)
        idx = pos[0].long()
        ck.index_copy_(1, idx, _repl(cfg, k).to(ck.dtype))
        cv.index_copy_(1, idx, _repl(cfg, v).to(cv.dtype))
        attn = L.gqa_attention(q, ck, cv, mask)
        x = x + L.dense(attn.reshape(B, Sn, -1), sa["wo"])
        h = L.apply_norm(cfg.norm, x, p.get("ln2", {}))
        ca = p["cross_attn"]
        qc = L.dense(h, ca["wq"]).reshape(B, Sn, Hq, D)
        attn_c = L.gqa_attention(qc, cache["cross"]["k"][i], cache["cross"]["v"][i])
        x = x + L.dense(attn_c.reshape(B, Sn, -1), ca["wo"])
        h = L.apply_norm(cfg.norm, x, p.get("ln3", {}))
        x = x + L.ffn(h, p["mlp"], act=cfg.act, gated=cfg.gated_ffn)
    length.add_(Sn)
    return _unembed(cfg, params, x), cache


def prefill(cfg: EncDecConfig, params: dict, src_embeds: torch.Tensor,
            tokens: torch.Tensor, max_len: int) -> tuple:
    """Encode, build the cache, and run the prompt (B, S) through
    :func:`decode_step`: (logits (B, S, V), cache with ``length`` S)."""
    enc_out = encode(cfg, params, src_embeds)
    cache = init_cache(cfg, params, enc_out, tokens.shape[0], max_len)
    return decode_step(cfg, params, cache, tokens)
