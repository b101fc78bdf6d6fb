"""Dense decoder-only transformer (GQA) — the port of
``repro.models.transformer``: merge-and-serve, prefill and paged
streaming decode of qwen2-72b, qwen3-14b, olmo-1b, stablelm-1.6b and the
internvl2-2b language backbone.

Parameters are nested dicts with per-layer blocks ``blocks/<i>/...`` (the
JAX package's ``scan_layers=False`` layout).  Full-sequence attention over
positions 0..S-1 goes through ``kernels.ops.flash_attention``, one-token
decode attention through ``ops.decode_attention`` and the paged KV view
through ``ops.page_gather``: the Hopper kernel on a CUDA tensor, the plain
version on a CPU tensor; so does the prefill over 0..S-1.  Explicit
positions take the masked ``layers.gqa_attention``, and in a prefill
``layers.blocked_causal_attention``, plain torch as in the JAX package.

Where the JAX package returns updated copies of a KV cache or pool, this
port writes into it in place and returns the same tensors: updating the
stacked pool out of place would copy all of it (0.4 GB at stablelm-1.6b's
serving shape) once per layer per step.
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
    # decode-time KV head replication factor (1 = none): the cache stores
    # every kv head kv_repl times
    kv_repl: int = 1
    # the blocking of a prefill's attention over explicit positions: bounds
    # live scores to (block_q, S)
    prefill_block_q: int = 1024

    @property
    def padded_vocab(self) -> int:
        return L.padded_vocab(self.vocab_size, self.vocab_multiple)

    @property
    def kv_stored_heads(self) -> int:
        return self.n_kv_heads * self.kv_repl


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


def _dense_ffn(cfg: DenseLMConfig, p: dict):
    """The block's feed-forward as ``ffn(h, taps, tap_prefix) -> y``: the
    dense (gated) MLP, tapped as ``mlp``."""
    def ffn(h, taps=None, tap_prefix=""):
        ff = L.ffn(h, p["mlp"], act=cfg.act, gated=cfg.gated_ffn)
        if taps is not None:
            taps[tap_prefix + "mlp"] = ff
        return ff
    return ffn


def _block(cfg: DenseLMConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
           taps: Optional[dict] = None, tap_prefix: str = "", ffn=None,
           std_positions: bool = True) -> torch.Tensor:
    """Full-sequence block.  Over the standard positions 0..S-1
    (``std_positions``) attention goes through ``ops.flash_attention``; other
    positions take the masked ``layers.gqa_attention``, as in the JAX
    package.  A non-parametric norm has no leaves, so its
    empty dict does not survive a flat-path round trip (store, bridge):
    norms are looked up with ``.get``.  ``ffn`` (default :func:`_dense_ffn`)
    is the feed-forward; the moe family passes its routed experts.

    ``taps``, when given, collects each sub-layer's response keyed by the
    param-path prefix that produces it ("blocks/0/attn", "blocks/0/mlp",
    ...); parameter-free norms get no tap (no record path maps onto them)."""
    h = L.apply_norm(cfg.norm, x, p.get("ln1", {}))
    if taps is not None and p.get("ln1"):
        taps[tap_prefix + "ln1"] = h
    q, k, v = _qkv(cfg, p["attn"], h, positions)
    if std_positions:
        attn = kops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal=True, window=cfg.window)
    else:
        mask = L.attention_mask(positions, positions, causal=True, window=cfg.window)
        attn = L.gqa_attention(q, k, v, mask)
    a = L.dense(attn.reshape(x.shape[0], x.shape[1], -1), p["attn"]["wo"])
    if taps is not None:
        taps[tap_prefix + "attn"] = a
    x = x + a
    h = L.apply_norm(cfg.norm, x, p.get("ln2", {}))
    if taps is not None and p.get("ln2"):
        taps[tap_prefix + "ln2"] = h
    return x + (ffn or _dense_ffn(cfg, p))(h, taps, tap_prefix)


def _softcap(cfg: DenseLMConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.logit_softcap is None:
        return logits
    return torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap


def standard_positions(tokens: torch.Tensor) -> torch.Tensor:
    """The positions 0..S-1 of every row of ``tokens`` (B, S), int32."""
    B, S = tokens.shape[:2]
    return torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)


def trunk(cfg: DenseLMConfig, params: dict, tokens: torch.Tensor,
          positions: Optional[torch.Tensor] = None,
          taps: Optional[dict] = None) -> torch.Tensor:
    """Embedding + transformer blocks — the mergeable *prefix*.  Returns
    pre-final-norm hidden states (B, S, d).  ``positions`` (B, S), when
    given, take the masked attention (see :func:`_block`).  ``taps``
    collects per-layer probes keyed by param-path prefix."""
    std = positions is None
    if std:
        positions = standard_positions(tokens)
    x = L.embed(tokens, params["embed"]["table"])
    if taps is not None:
        taps["embed"] = x
    for i in range(cfg.n_layers):
        x = _block(cfg, params["blocks"][str(i)], x, positions, taps=taps,
                   tap_prefix=f"blocks/{i}/", std_positions=std)
    return x


def head(cfg: DenseLMConfig, params: dict, x: torch.Tensor,
         taps: Optional[dict] = None) -> torch.Tensor:
    """Final norm + unembedding — the private *suffix*.  float32 logits."""
    fn = params.get("final_norm", {})
    x = L.apply_norm(cfg.norm, x, fn)
    if taps is not None and fn:
        taps["final_norm"] = x
    if cfg.tie_embeddings:
        logits = L.unembed(x, params["embed"]["table"], transpose=True)
    else:
        logits = L.unembed(x, params["lm_head"]["w"], transpose=False)
    logits = _softcap(cfg, logits)
    if taps is not None and not cfg.tie_embeddings:
        taps["lm_head"] = logits
    return logits


def forward(cfg: DenseLMConfig, params: dict, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab) float32.  Composed as
    ``head(trunk(x))`` so the serving split is bitwise identical to it."""
    return head(cfg, params, trunk(cfg, params, tokens, positions))


def loss_fn(cfg: DenseLMConfig, params: dict, batch: dict) -> torch.Tensor:
    logits = forward(cfg, params, batch["tokens"])
    return L.softmax_cross_entropy(logits, batch["labels"], valid_vocab=cfg.vocab_size,
                                   mask=batch.get("mask"))


@torch.no_grad()
def layer_activations(cfg: DenseLMConfig, params: dict, tokens: torch.Tensor) -> dict:
    """Calibration-batch activations for every layer, keyed by param-path
    prefix, as float32 numpy on the host — the probes the
    representation-similarity scorer consumes."""
    taps: dict = {}
    head(cfg, params, trunk(cfg, params, tokens, taps=taps), taps=taps)
    return {k: v.float().cpu().numpy() for k, v in taps.items()}


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


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: DenseLMConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """Contiguous KV cache over layers: k/v (L, B, Smax, Hkv*kv_repl, D) of
    zeros, and ``length``, the tokens already cached: a 0-d int32 tensor on
    the cache's device (the JAX package traces it as a device value), so a
    captured decode step reads and advances it on the device."""
    device = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.kv_stored_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "length": torch.zeros((), dtype=torch.int32, device=device)}


def _write_kv(cache_k, cache_v, k, v, positions: torch.Tensor, kv_repl: int):
    """Write new k/v (B, S, Hkv, D) into one layer's cache at ``positions``
    (S,), in place."""
    if kv_repl > 1:
        k = k.repeat_interleave(kv_repl, dim=2)
        v = v.repeat_interleave(kv_repl, dim=2)
    idx = positions.long()
    cache_k.index_copy_(1, idx, k.to(cache_k.dtype))
    cache_v.index_copy_(1, idx, v.to(cache_v.dtype))
    return cache_k, cache_v


def _block_decode(cfg: DenseLMConfig, p: dict, cache_l: dict, x: torch.Tensor,
                  positions: torch.Tensor, length: torch.Tensor, ffn=None):
    """Single-step (or chunked) decode block against one cache layer.
    x (B, S_new, d); cache k/v (B, Smax, Hs, D).  One token without a window
    goes through ``ops.decode_attention``; more tokens through the plain
    masked attention.  ``ffn`` as in :func:`_block`.  Returns (x, cache_l)."""
    B, Sn, _ = x.shape
    h = L.apply_norm(cfg.norm, x, p.get("ln1", {}))
    q, k, v = _qkv(cfg, p["attn"], h, positions)
    ck, cv = _write_kv(cache_l["k"], cache_l["v"], k, v, positions[0], cfg.kv_repl)
    if Sn == 1 and cfg.window is None:
        lengths = (length + 1).to(torch.int32).repeat(B)
        attn = kops.decode_attention(q[:, 0].contiguous(), ck, cv, lengths)[:, None]
    else:
        Smax = ck.shape[1]
        kv_positions = torch.arange(Smax, dtype=torch.int32, device=x.device).expand(B, Smax)
        mask = L.attention_mask(positions, kv_positions, causal=True, window=cfg.window)
        # mask out cache slots beyond the written prefix
        valid = kv_positions < (length + Sn)
        mask = mask & valid[:, None, None, :]
        attn = L.gqa_attention(q, ck, cv, mask)
    x = x + L.dense(attn.reshape(B, Sn, -1), p["attn"]["wo"])
    h = L.apply_norm(cfg.norm, x, p.get("ln2", {}))
    return x + (ffn or _dense_ffn(cfg, p))(h), {"k": ck, "v": cv}


def decode_step(cfg: DenseLMConfig, params: dict, cache: dict,
                tokens: torch.Tensor) -> tuple:
    """One decode step, tokens (B, S_new) (S_new = 1 for autoregressive
    decode).  Writes the new k/v into ``cache`` and advances its ``length``,
    all in place; returns (logits (B, S_new, V) float32, cache)."""
    B, Sn = tokens.shape
    length = cache["length"]
    positions = (length + torch.arange(Sn, dtype=torch.int32,
                                       device=tokens.device)).expand(B, Sn)
    x = L.embed(tokens, params["embed"]["table"])
    ck, cv = cache["k"], cache["v"]
    for i in range(cfg.n_layers):
        x, _ = _block_decode(cfg, params["blocks"][str(i)], {"k": ck[i], "v": cv[i]},
                             x, positions, length)
    length.add_(Sn)
    return head(cfg, params, x), {"k": ck, "v": cv, "length": length}


# ---------------------------------------------------------------------------
# Paged KV decode: pool storage + per-request page tables
# ---------------------------------------------------------------------------


def init_kv_pool(cfg: DenseLMConfig, num_pages: int, page_size: int, dtype=None,
                 device=None) -> dict:
    """Paged KV pool shared by every in-flight request of one config:
    k/v (L, P, page, Hs, D).  Page ownership (tables, free list, epochs)
    lives with the serving layer (``serving.decode.PagedKVPool``)."""
    device = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    shape = (cfg.n_layers, num_pages, page_size, cfg.kv_stored_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _paged_write(pool_k, pool_v, k, v, tables, lengths, kv_repl: int):
    """Scatter one new token's k/v (B, 1, Hkv, D) into each row's current
    page slot of one pool layer (P, page, Hs, D), in place.  Padded batch
    rows may duplicate a real row: the duplicate write carries identical
    values, so the result is deterministic."""
    if kv_repl > 1:
        k = k.repeat_interleave(kv_repl, dim=2)
        v = v.repeat_interleave(kv_repl, dim=2)
    page = pool_k.shape[1]
    rows = torch.arange(tables.shape[0], device=tables.device)
    page_ix = tables[rows, lengths // page]
    slot = lengths % page
    pool_k.index_put_((page_ix, slot), k[:, 0].to(pool_k.dtype))
    pool_v.index_put_((page_ix, slot), v[:, 0].to(pool_v.dtype))
    return pool_k, pool_v


def _paged_view(pool_x: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Assemble per-row contiguous caches (B, maxp*page, Hs, D) from one pool
    layer in ONE ``ops.page_gather`` dispatch on the (P, page*Hs*D) flat
    view.  The row layout is exactly ``init_cache``'s with Smax =
    maxp*page; whatever a page holds beyond a row's valid length is masked
    by decode attention, so stale tenants of reused pages are invisible."""
    P, page, Hs, D = pool_x.shape
    B, maxp = tables.shape
    flat = pool_x.reshape(P, page * Hs * D)
    out = kops.page_gather(flat, tables.reshape(-1))
    return out.reshape(B, maxp * page, Hs, D)


def _block_decode_paged(cfg: DenseLMConfig, p: dict, pool_l: dict, x: torch.Tensor,
                        tables: torch.Tensor, lengths: torch.Tensor, ffn=None):
    """Single-token decode block against one paged pool layer.  x (B, 1, d);
    pool_l k/v (P, page, Hs, D); tables (B, maxp) int32; lengths (B,) int32
    tokens already cached per row (this token lands at index ``lengths``).
    Op for op the one-token path of :func:`_block_decode` on the gathered
    contiguous view; ``ffn`` as in :func:`_block`."""
    B, Sn, _ = x.shape
    h = L.apply_norm(cfg.norm, x, p.get("ln1", {}))
    q, k, v = _qkv(cfg, p["attn"], h, lengths[:, None])
    pk, pv = _paged_write(pool_l["k"], pool_l["v"], k, v, tables, lengths, cfg.kv_repl)
    ck = _paged_view(pk, tables)
    cv = _paged_view(pv, tables)
    attn = kops.decode_attention(q[:, 0].contiguous(), ck, cv, lengths + 1)[:, None]
    x = x + L.dense(attn.reshape(B, Sn, -1), p["attn"]["wo"])
    h = L.apply_norm(cfg.norm, x, p.get("ln2", {}))
    return x + (ffn or _dense_ffn(cfg, p))(h), {"k": pk, "v": pv}


def paged_trunk_step(cfg: DenseLMConfig, params: dict, pool: dict, tables: torch.Tensor,
                     lengths: torch.Tensor, tokens: torch.Tensor) -> tuple:
    """Shared-trunk paged decode step — embedding + blocks, ONE new token per
    row.  tokens (B,); pool from :func:`init_kv_pool`; tables (B, maxp) page
    indices per row; lengths (B,) tokens already cached.  Writes the pool in
    place; returns (hidden (B, 1, d), pool).  Every member of a merged group
    shares this step; private heads fan out via :func:`head` or
    :func:`bank_head`."""
    if cfg.window is not None:
        raise ValueError("paged decode requires full attention (window=None)")
    tables = tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32)
    x = L.embed(tokens[:, None], params["embed"]["table"])
    pk, pv = pool["k"], pool["v"]
    for i in range(cfg.n_layers):
        x, _ = _block_decode_paged(cfg, params["blocks"][str(i)],
                                   {"k": pk[i], "v": pv[i]}, x, tables, lengths)
    return x, {"k": pk, "v": pv}


def paged_prefill_chunk(cfg: DenseLMConfig, params: dict, pool: dict,
                        tables: torch.Tensor, lengths: torch.Tensor,
                        tokens: torch.Tensor) -> tuple:
    """Chunked prompt admission: ingest ``tokens`` (B, C) prompt tokens per
    row as C sequential :func:`paged_trunk_step` calls in one dispatch of
    the decoder, so tokens and logits stay identical to token-by-token
    prefill.  Returns (hidden (B, C, d), pool)."""
    C = tokens.shape[1]
    lengths = lengths.to(torch.int32)
    hs = []
    for c in range(C):
        h, pool = paged_trunk_step(cfg, params, pool, tables, lengths + c, tokens[:, c])
        hs.append(h)
    return torch.cat(hs, dim=1), pool


def paged_decode_step(cfg: DenseLMConfig, params: dict, pool: dict,
                      tables: torch.Tensor, lengths: torch.Tensor,
                      tokens: torch.Tensor) -> tuple:
    """Full paged decode step (shared trunk + this model's private head), the
    paged twin of :func:`decode_step`.  Returns (logits (B, 1, V), pool)."""
    x, pool = paged_trunk_step(cfg, params, pool, tables, lengths, tokens)
    return head(cfg, params, x), pool


# ---------------------------------------------------------------------------
# Blocked prefill: a padded KV cache and the last position's logits
# ---------------------------------------------------------------------------


def _block_prefill(cfg: DenseLMConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
                   cache_l: dict, ffn=None, std_positions: bool = True) -> torch.Tensor:
    """One layer of the prefill, with this layer's k/v written into slots
    0..S-1 of its cache layer ``cache_l`` (B, Smax, Hs, D), whatever the
    positions (as the JAX package pads), every kv head stored ``kv_repl``
    times.  Attention over the standard positions
    0..S-1 (``std_positions``) goes through ``ops.flash_attention``, as in
    :func:`_block`; other positions through
    ``layers.blocked_causal_attention`` (live scores bounded to
    (``prefill_block_q``, S)), as in the JAX package.  ``ffn`` as in
    :func:`_block`."""
    B, S, _ = x.shape
    h = L.apply_norm(cfg.norm, x, p.get("ln1", {}))
    q, k, v = _qkv(cfg, p["attn"], h, positions)
    _write_kv(cache_l["k"], cache_l["v"], k, v, torch.arange(S, device=x.device), cfg.kv_repl)
    if std_positions:
        attn = kops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal=True, window=cfg.window)
    else:
        # repro: allow[A103] prefill at explicit positions needs the blocked
        # flash-analogue; kernel routing lives in _block/_block_decode
        attn = L.blocked_causal_attention(q, k, v, positions, window=cfg.window,
                                          block_q=cfg.prefill_block_q)
    x = x + L.dense(attn.reshape(B, S, -1), p["attn"]["wo"])
    h = L.apply_norm(cfg.norm, x, p.get("ln2", {}))
    return x + (ffn or _dense_ffn(cfg, p))(h)


def prefill(cfg: DenseLMConfig, params: dict, tokens: torch.Tensor, max_len: int) -> tuple:
    """Prefill a cache from a whole prompt (B, S): returns (logits (B, 1, V)
    of the last position, cache) in :func:`init_cache`'s layout with
    ``length`` S, ready for :func:`decode_step`."""
    x = L.embed(tokens, params["embed"]["table"])
    return prefill_from_embeddings(cfg, params, x, None, max_len)


def prefill_from_embeddings(cfg: DenseLMConfig, params: dict, x: torch.Tensor,
                            positions: Optional[torch.Tensor], max_len: int) -> tuple:
    """:func:`prefill` from embeddings x (B, S, d) (the vlm family
    prepends its patch embeddings) at ``positions`` (B, S); ``None`` means
    0..S-1, whose attention goes through ``ops.flash_attention`` (see
    :func:`_block_prefill`)."""
    B, S, _ = x.shape
    std = positions is None
    if std:
        positions = standard_positions(x)
    cache = init_cache(cfg, B, max_len, device=x.device)
    for i in range(cfg.n_layers):
        x = _block_prefill(cfg, params["blocks"][str(i)], x, positions,
                           {"k": cache["k"][i], "v": cache["v"][i]}, std_positions=std)
    cache["length"].fill_(S)
    return head(cfg, params, x[:, -1:]), cache
