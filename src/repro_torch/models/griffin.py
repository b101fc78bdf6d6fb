"""Griffin-style hybrid LM (RG-LRU + local attention; recurrentgemma-9b) —
the port of ``repro.models.griffin`` for merge-and-serve.

RG-LRU recurrence (Griffin, arXiv:2402.19427):

    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    a_t = exp(-c * softplus(Lambda) * r_t)        per-channel decay in (0,1)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Parameters are nested dicts with per-repeat layers
``repeats/<r>/<i>_<kind>/...`` (the JAX package's ``scan_layers=False``
layout).  The recurrence goes through ``kernels.ops.rg_lru_scan`` and the
local attention through ``ops.flash_attention(window=...)``: the Hopper
kernels on CUDA tensors, the plain versions on CPU tensors.  The scan takes
any sequence length, so the JAX package's identity padding up to a chunk
multiple has no counterpart here.

Streaming decode keeps, per request, the recurrent ``(h, conv)`` state of
every recurrent layer and a ring buffer of ``window`` key/value slots per
attention layer (slot = position % window): the state does not grow with
the sequence.  The decode steps run the RG-LRU through the same
``rg_lru_scan`` at S = 1 with the carried h, and attend over the ring in
plain torch (``layers.gqa_attention``), as the JAX package does.  Where the
JAX package returns updated copies of a cache or state pool, this port
writes into it in place (recurrentgemma-9b's pool of 128 slots is 3.36 GB).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.ssm import _conv1d
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import flatten_paths, torch_dtype

_RGLRU_C = 8.0


@dataclasses.dataclass(frozen=True)
class GriffinConfig:
    name: str = "griffin-lm"
    n_layers: int = 6  # must be divisible by len(pattern)
    pattern: tuple = ("rec", "rec", "attn")
    d_model: int = 256
    d_rnn: int = 256  # lru width
    n_heads: int = 4
    n_kv_heads: int = 1  # MQA
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1000
    vocab_multiple: int = 256
    window: int = 128  # local attention window
    rope_theta: float = 1e4
    conv_width: int = 4
    rglru_blocks: int = 0  # 0 -> n_heads; block-diagonal gate weights
    norm: str = "rmsnorm"
    act: str = "gelu_tanh"
    gated_ffn: bool = True
    tie_embeddings: bool = True
    logit_softcap: Optional[float] = 30.0
    dtype: str = "float32"  # numpy dtype name
    kv_repl: int = 1  # the ring stores each kv head this many times

    @property
    def padded_vocab(self) -> int:
        return L.padded_vocab(self.vocab_size, self.vocab_multiple)

    @property
    def n_repeats(self) -> int:
        if self.n_layers % len(self.pattern):
            raise ValueError(f"n_layers {self.n_layers} is not a multiple of the "
                             f"pattern's {len(self.pattern)} layers")
        return self.n_layers // len(self.pattern)

    @property
    def kv_stored_heads(self) -> int:
        return self.n_kv_heads * self.kv_repl

    @property
    def gate_blocks(self) -> int:
        return self.rglru_blocks or self.n_heads


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_recurrent(cfg: GriffinConfig, gen, device) -> dict:
    d, dr, dt = cfg.d_model, cfg.d_rnn, cfg.dtype
    nb = cfg.gate_blocks
    bw = dr // nb
    # Lambda so that a^c lies in (0.9, 0.999) at r = 1 (Griffin appendix),
    # stored through the inverse softplus
    u = L.uniform(gen, (dr,), 0.9 ** 2, 0.999 ** 2, device)
    lam = torch.log(torch.expm1(-torch.log(u) / (2.0 * _RGLRU_C)))

    def zeros():
        return torch.zeros((dr,), dtype=torch_dtype(dt), device=device)

    return {
        "in_x": {"w": L.init_dense(gen, d, dr, dt, device)},
        "in_gate": {"w": L.init_dense(gen, d, dr, dt, device)},
        "conv": {"w": L.normal(gen, (cfg.conv_width, dr), 1.0 / math.sqrt(cfg.conv_width),
                               dt, device),
                 "b": zeros()},
        "rglru": {
            # block-diagonal gate weights, one (bw, bw) block per head
            "w_a": L.normal(gen, (nb, bw, bw), 0.5 / math.sqrt(bw), dt, device),
            "b_a": zeros(),
            "w_x": L.normal(gen, (nb, bw, bw), 0.5 / math.sqrt(bw), dt, device),
            "b_x": zeros(),
            "lam": lam,
        },
        "out_proj": {"w": L.init_dense(gen, dr, d, dt, device)},
    }


def _init_attn(cfg: GriffinConfig, gen, device) -> dict:
    Hq, Hkv, D, d, dt = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model, cfg.dtype
    return {
        "wq": L.init_dense(gen, d, Hq * D, dt, device),
        "wk": L.init_dense(gen, d, Hkv * D, dt, device),
        "wv": L.init_dense(gen, d, Hkv * D, dt, device),
        "wo": L.init_dense(gen, Hq * D, d, dt, device),
    }


def _init_layer(cfg: GriffinConfig, kind: str, gen, device) -> dict:
    p = {
        "ln1": L.init_norm(cfg.norm, cfg.d_model, cfg.dtype, device),
        "ln2": L.init_norm(cfg.norm, cfg.d_model, cfg.dtype, device),
        "mlp": L.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.dtype, device, gated=cfg.gated_ffn),
    }
    if kind == "rec":
        p["rec"] = _init_recurrent(cfg, gen, device)
    else:
        p["attn"] = _init_attn(cfg, gen, device)
    return p


def init(cfg: GriffinConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from ``seed``, generated on ``device`` (default
    ``cuda``; ``meta`` gives shapes only)."""
    device = resolve_device(device)
    gen = L.make_generator(seed, device)
    V = cfg.padded_vocab
    params: dict = {
        "embed": {"table": L.normal(gen, (V, cfg.d_model), 0.02, cfg.dtype, device)},
        "final_norm": L.init_norm(cfg.norm, cfg.d_model, cfg.dtype, device),
        "repeats": {str(r): {f"{i}_{kind}": _init_layer(cfg, kind, gen, device)
                             for i, kind in enumerate(cfg.pattern)}
                    for r in range(cfg.n_repeats)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": L.init_dense(gen, cfg.d_model, V, cfg.dtype, device)}
    return params


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _block_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Block-diagonal linear: x (B, S, dr), w (nb, bw, bw) -> (B, S, dr)
    float32 (inputs widened first: float32 sums of exact products)."""
    B, S, dr = x.shape
    nb, bw, _ = w.shape
    y = torch.einsum("bsnw,nwk->bsnk", x.reshape(B, S, nb, bw).float(), w.float())
    return y.reshape(B, S, dr) + b.float()


def _rglru_coeffs(p: dict, x: torch.Tensor) -> tuple:
    """x (B, S, dr) -> (a, b) of the diagonal recurrence h = a*h + b, both
    (B, S, dr) float32."""
    r = torch.sigmoid(_block_dense(x, p["w_a"], p["b_a"]))
    i = torch.sigmoid(_block_dense(x, p["w_x"], p["b_x"]))
    log_a = -_RGLRU_C * L.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))  # sqrt(1 - a^2), stably
    return a, beta * (i * x.float())


def _recurrent_mixer(cfg: GriffinConfig, p: dict, x: torch.Tensor,
                     state: Optional[dict] = None, taps: Optional[dict] = None,
                     tap_path: str = "") -> tuple:
    """Griffin recurrent block: x (B, S, d); state {"h": (B, dr) float32,
    "conv": (B, K-1, dr)} or None (zeros).  Returns (y (B, S, d), new
    state).  The recurrence goes through ``ops.rg_lru_scan`` at any S, a
    single decode token included.  ``taps`` collects the sub-layer
    responses keyed by param-path prefix, as the JAX package's do."""
    B = x.shape[0]
    xb = L.dense(x, p["in_x"]["w"])  # (B, S, dr) recurrent branch
    gate = F.gelu(L.dense(x, p["in_gate"]["w"]).float(), approximate="tanh")
    xc, new_conv = _conv1d(xb, p["conv"]["w"], p["conv"]["b"],
                           state["conv"] if state is not None else None)
    a, b = _rglru_coeffs(p["rglru"], xc)
    h0 = state["h"] if state is not None else torch.zeros(
        (B, cfg.d_rnn), dtype=torch.float32, device=x.device)
    h_all, h_last = kops.rg_lru_scan(a, b, h0.contiguous())
    y = L.dense((h_all * gate).to(x.dtype), p["out_proj"]["w"])
    if taps is not None:
        taps.update({tap_path + "/in_x": xb, tap_path + "/in_gate": gate,
                     tap_path + "/conv": xc, tap_path + "/rglru": h_all,
                     tap_path + "/out_proj": y})
    return y, {"h": h_last, "conv": new_conv}


# ---------------------------------------------------------------------------
# Local attention
# ---------------------------------------------------------------------------


# the query block of the blocked attention over explicit positions (the
# JAX package's griffin._attn_full)
ATTN_BLOCK_Q = 1024


def _attn_full(cfg: GriffinConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
               std_positions: bool = True) -> torch.Tensor:
    """Sliding-window MQA.  Over positions 0..S-1 (``std_positions``)
    through ``ops.flash_attention(window=cfg.window)``; other positions
    through ``layers.blocked_causal_attention``, as in the JAX package."""
    B, S, _ = x.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.apply_rope(L.dense(x, p["wq"]).reshape(B, S, Hq, D), positions, cfg.rope_theta, D)
    k = L.apply_rope(L.dense(x, p["wk"]).reshape(B, S, Hkv, D), positions, cfg.rope_theta, D)
    v = L.dense(x, p["wv"]).reshape(B, S, Hkv, D)
    if std_positions:
        attn = kops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal=True, window=cfg.window)
    else:
        attn = L.blocked_causal_attention(q, k, v, positions, window=cfg.window,
                                          block_q=ATTN_BLOCK_Q)
    return L.dense(attn.reshape(B, S, -1), p["wo"])


def _attn_decode(cfg: GriffinConfig, p: dict, cache_l: dict, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Ring-buffer local attention for decode: x (B, Sn, d) at ``positions``
    (B, Sn); cache k/v (B, W, Hs, D), written in place at slot = position %
    W.  Slot s then holds the largest position <= the last one with that
    remainder; slots never written (a negative stored position) and keys
    outside the window are masked.  Plain torch, as in the JAX package.
    Returns the block output (B, Sn, d)."""
    B, Sn, _ = x.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ck, cv = cache_l["k"], cache_l["v"]
    W = ck.shape[1]
    q = L.apply_rope(L.dense(x, p["wq"]).reshape(B, Sn, Hq, D), positions, cfg.rope_theta, D)
    k = L.apply_rope(L.dense(x, p["wk"]).reshape(B, Sn, Hkv, D), positions, cfg.rope_theta, D)
    v = L.dense(x, p["wv"]).reshape(B, Sn, Hkv, D)
    if cfg.kv_repl > 1:
        k = k.repeat_interleave(cfg.kv_repl, dim=2)
        v = v.repeat_interleave(cfg.kv_repl, dim=2)
    # of more than W new tokens only the last W stay in the ring
    keep = min(Sn, W)
    rows = torch.arange(B, device=x.device)[:, None]
    slots = (positions[:, Sn - keep:] % W).long()
    ck[rows, slots] = k[:, Sn - keep:].to(ck.dtype)
    cv[rows, slots] = v[:, Sn - keep:].to(cv.dtype)
    slot_ids = torch.arange(W, dtype=positions.dtype, device=x.device)[None, :]
    last = positions[:, -1:]
    stored_pos = last - ((last - slot_ids) % W)  # (B, W)
    mask = L.attention_mask(positions, stored_pos, causal=True, window=cfg.window)
    mask = mask & (stored_pos >= 0)[:, None, None, :]
    attn = L.gqa_attention(q, ck, cv, mask)
    return L.dense(attn.reshape(B, Sn, -1), p["wo"])


# ---------------------------------------------------------------------------
# Layers / forward
# ---------------------------------------------------------------------------


def _layer(cfg: GriffinConfig, kind: str, p: dict, x: torch.Tensor,
           positions: torch.Tensor, taps: Optional[dict] = None,
           tap_path: str = "", std_positions: bool = True) -> torch.Tensor:
    h = L.apply_norm(cfg.norm, x, p.get("ln1", {}))
    if taps is not None:
        taps[tap_path + "/ln1"] = h
    if kind == "rec":
        y, _ = _recurrent_mixer(cfg, p["rec"], h, taps=taps, tap_path=tap_path + "/rec")
    else:
        y = _attn_full(cfg, p["attn"], h, positions, std_positions)
        if taps is not None:
            taps[tap_path + "/attn"] = y
    x = x + y
    h = L.apply_norm(cfg.norm, x, p.get("ln2", {}))
    f = L.ffn(h, p["mlp"], act=cfg.act, gated=cfg.gated_ffn)
    if taps is not None:
        taps[tap_path + "/ln2"] = h
        taps[tap_path + "/mlp"] = f
    return x + f


def _embed(cfg: GriffinConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding scaled by sqrt(d_model), as gemma does.  The scale is
    rounded to the embedding's dtype on the host and enters as a CPU
    scalar, so the step copies nothing to the device (a CUDA-graph capture
    of it would refuse the copy)."""
    x = L.embed(tokens, params["embed"]["table"])
    return x * torch.sqrt(torch.tensor(float(cfg.d_model), dtype=x.dtype))


def trunk(cfg: GriffinConfig, params: dict, tokens: torch.Tensor,
          positions: Optional[torch.Tensor] = None,
          taps: Optional[dict] = None) -> torch.Tensor:
    """Embedding (scaled by sqrt(d_model), as gemma does) + griffin repeats —
    the mergeable *prefix*.  Returns pre-final-norm hidden states (B, S, d).
    ``positions`` (B, S), when given (packed or offset sequences), take the
    blocked attention (see :func:`_attn_full`)."""
    std = positions is None
    if std:
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    x = _embed(cfg, params, tokens)
    if taps is not None:
        taps["embed"] = x
    for r in range(cfg.n_repeats):
        rep = params["repeats"][str(r)]
        for i, kind in enumerate(cfg.pattern):
            x = _layer(cfg, kind, rep[f"{i}_{kind}"], x, positions, taps=taps,
                       tap_path=f"repeats/{r}/{i}_{kind}", std_positions=std)
    return x


def _softcap(cfg: GriffinConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.logit_softcap is None:
        return logits
    return torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap


def head(cfg: GriffinConfig, params: dict, x: torch.Tensor,
         taps: Optional[dict] = None) -> torch.Tensor:
    """Final norm + softcapped unembedding — the private *suffix*."""
    fn = params.get("final_norm", {})
    x = L.apply_norm(cfg.norm, x, fn)
    if taps is not None and fn:
        taps["final_norm"] = x
    if cfg.tie_embeddings:
        return _softcap(cfg, L.unembed(x, params["embed"]["table"], transpose=True))
    logits = _softcap(cfg, L.unembed(x, params["lm_head"]["w"], transpose=False))
    if taps is not None:
        taps["lm_head"] = logits
    return logits


def forward(cfg: GriffinConfig, params: dict, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab) float32, composed as
    ``head(trunk(x))`` so the serving split is bitwise identical to it."""
    return head(cfg, params, trunk(cfg, params, tokens, positions))


def loss_fn(cfg: GriffinConfig, params: dict, batch: dict) -> torch.Tensor:
    logits = forward(cfg, params, batch["tokens"])
    return L.softmax_cross_entropy(logits, batch["labels"], valid_vocab=cfg.vocab_size,
                                   mask=batch.get("mask"))


@torch.no_grad()
def layer_activations(cfg: GriffinConfig, params: dict, tokens: torch.Tensor) -> dict:
    """Calibration-batch activations for every layer, keyed by param-path
    prefix, as float32 numpy on the host."""
    taps: dict = {}
    head(cfg, params, trunk(cfg, params, tokens, taps=taps), taps=taps)
    return {k: v.float().cpu().numpy() for k, v in taps.items()}


def trunk_paths(params: dict) -> frozenset:
    """Flat param paths read by :func:`trunk` (a tied head also reads the
    embedding table).  Works on ``meta`` trees."""
    return frozenset(p for p in flatten_paths(params)
                     if not p.startswith(("final_norm/", "lm_head/")))


def head_paths(params: dict) -> frozenset:
    """Flat param paths read by an untied :func:`head` — the private-suffix
    leaves the serving engine stacks into a bank."""
    return frozenset(p for p in flatten_paths(params)
                     if p.startswith(("final_norm/", "lm_head/")))


def bank_head(cfg: GriffinConfig, bank_params: dict, x: torch.Tensor) -> torch.Tensor:
    """Every private head of a merged untied group in ONE ``ops.bank_matmul``
    (each member's final norm as in :func:`head`), then the softcap.
    Returns (N, B, S, V)."""
    if cfg.tie_embeddings:
        raise ValueError("tied-embedding heads have no bank path")
    n_bank = bank_params["lm_head"]["w"].shape[0]
    fn = bank_params.get("final_norm") or {}
    xn = torch.stack([
        L.apply_norm(cfg.norm, x, {k: v[i] for k, v in fn.items()})
        for i in range(n_bank)])
    B, S, d = x.shape
    logits = kops.bank_matmul(xn.reshape(n_bank, B * S, d), bank_params["lm_head"]["w"])
    return _softcap(cfg, logits.reshape(n_bank, B, S, -1))


# ---------------------------------------------------------------------------
# Stateful decode: (h, conv) per recurrent layer, a KV ring per attention layer
# ---------------------------------------------------------------------------


def _layer_decode(cfg: GriffinConfig, kind: str, p: dict, x: torch.Tensor, state: dict,
                  positions: torch.Tensor) -> tuple:
    """One layer of a decode step against its state: a recurrent layer's
    {"h", "conv"} (returned anew) or an attention layer's ring {"k", "v"}
    (written in place and returned as it is).  Returns (x, state)."""
    h = L.apply_norm(cfg.norm, x, p.get("ln1", {}))
    if kind == "rec":
        y, state = _recurrent_mixer(cfg, p["rec"], h, state)
    else:
        y = _attn_decode(cfg, p["attn"], state, h, positions)
    x = x + y
    h = L.apply_norm(cfg.norm, x, p.get("ln2", {}))
    return x + L.ffn(h, p["mlp"], act=cfg.act, gated=cfg.gated_ffn), state


def init_cache(cfg: GriffinConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """Per pattern position ``"{i}_{kind}"``, over the repeats: a recurrent
    layer's h (R, B, dr) float32 and conv history (R, B, K-1, dr), an
    attention layer's ring k/v (R, B, W, Hs, D) with W = min(window,
    max_len); and ``length``, a 0-d int32 tensor on the cache's device."""
    device = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    R, W, Hs = cfg.n_repeats, min(cfg.window, max_len), cfg.kv_stored_heads
    cache: dict = {}
    for i, kind in enumerate(cfg.pattern):
        if kind == "rec":
            cache[f"{i}_{kind}"] = {
                "h": torch.zeros((R, batch, cfg.d_rnn), dtype=torch.float32, device=device),
                "conv": torch.zeros((R, batch, cfg.conv_width - 1, cfg.d_rnn), dtype=dt,
                                    device=device)}
        else:
            cache[f"{i}_{kind}"] = {
                kv: torch.zeros((R, batch, W, Hs, cfg.head_dim), dtype=dt, device=device)
                for kv in ("k", "v")}
    cache["length"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def decode_step(cfg: GriffinConfig, params: dict, cache: dict,
                tokens: torch.Tensor) -> tuple:
    """tokens (B, S_new) -> (logits (B, S_new, V) float32, cache with the new
    state written and ``length`` advanced, all in place).  Works for a
    prompt too: the scan carries the state over every new token."""
    B, Sn = tokens.shape
    length = cache["length"]
    positions = (length + torch.arange(Sn, dtype=torch.int32,
                                       device=tokens.device)).expand(B, Sn)
    x = _embed(cfg, params, tokens)
    for r in range(cfg.n_repeats):
        rep = params["repeats"][str(r)]
        for i, kind in enumerate(cfg.pattern):
            key = f"{i}_{kind}"
            st = cache[key]
            x, new = _layer_decode(cfg, kind, rep[key], x, {n: t[r] for n, t in st.items()},
                                   positions)
            if kind == "rec":  # the ring was written in place
                st["h"][r], st["conv"][r] = new["h"], new["conv"]
    length.add_(Sn)
    return head(cfg, params, x), cache


def prefill(cfg: GriffinConfig, params: dict, tokens: torch.Tensor, max_len: int) -> tuple:
    """A fresh cache on the tokens' device, then :func:`decode_step` over
    the whole prompt."""
    cache = init_cache(cfg, tokens.shape[0], max_len, device=tokens.device)
    return decode_step(cfg, params, cache, tokens)


# ---------------------------------------------------------------------------
# Paged decode: O(window) state per request in the serving pool
# ---------------------------------------------------------------------------


def init_state_pool(cfg: GriffinConfig, num_pages: int, page_size: int, dtype=None,
                    device=None) -> dict:
    """Pool for ``serving.decode.PagedKVPool``: dicts under "k" and "v"
    keyed by pattern position, each (R, num_pages, ...) — a recurrent
    layer's h under "k" and conv history under "v", an attention layer's
    ring k/v of the full ``window`` slots.  A request's whole state lives in
    its FIRST page slot (``tables[:, 0]``); ``page_size`` only shapes the
    admission ledger.  Paged == unpaged therefore needs ``window <=
    max_len`` (the unpaged ring has min(window, max_len) slots): the
    adapter's decode split enforces it."""
    del page_size
    device = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    R, W, Hs = cfg.n_repeats, cfg.window, cfg.kv_stored_heads
    k, v = {}, {}
    for i, kind in enumerate(cfg.pattern):
        key = f"{i}_{kind}"
        if kind == "rec":
            k[key] = torch.zeros((R, num_pages, cfg.d_rnn), dtype=torch.float32, device=device)
            v[key] = torch.zeros((R, num_pages, cfg.conv_width - 1, cfg.d_rnn), dtype=dt,
                                 device=device)
        else:
            k[key] = torch.zeros((R, num_pages, W, Hs, cfg.head_dim), dtype=dt, device=device)
            v[key] = torch.zeros((R, num_pages, W, Hs, cfg.head_dim), dtype=dt, device=device)
    return {"k": k, "v": v}


def paged_trunk_step(cfg: GriffinConfig, params: dict, pool: dict, tables: torch.Tensor,
                     lengths: torch.Tensor, tokens: torch.Tensor) -> tuple:
    """One decode step over the paged state pool, layer by layer: read each
    row's state from its page-0 slot, run the same layer as
    :func:`decode_step` at the row's own position, write the whole state
    back in place.  A row with ``lengths == 0`` (a fresh admission, possibly
    onto a recycled slot) reads exact zeros, so the write-back clears what
    the slot's last tenant left.  Padded batch rows may duplicate a real
    row; the duplicate writes carry the same values.  tokens (B,) ->
    (hidden (B, 1, d), pool)."""
    sid = tables[:, 0].long()
    lengths = lengths.to(torch.int32)
    fresh = lengths == 0
    positions = lengths[:, None]
    x = _embed(cfg, params, tokens[:, None])
    for r in range(cfg.n_repeats):
        rep = params["repeats"][str(r)]
        for i, kind in enumerate(cfg.pattern):
            key = f"{i}_{kind}"
            # (P, ...) views of the pool; "k" holds h or the ring's keys,
            # "v" the conv history or the ring's values
            slabs = {n: pool[kv][key][r] for n, kv in
                     zip(("h", "conv") if kind == "rec" else ("k", "v"), ("k", "v"))}
            state = {}
            for n, slab in slabs.items():
                g = slab.index_select(0, sid)
                state[n] = g.masked_fill(fresh.view((-1,) + (1,) * (g.dim() - 1)), 0.0)
            x, state = _layer_decode(cfg, kind, rep[key], x, state, positions)
            for n, slab in slabs.items():
                slab.index_copy_(0, sid, state[n].to(slab.dtype))
    return x, pool


def paged_prefill_chunk(cfg: GriffinConfig, params: dict, pool: dict,
                        tables: torch.Tensor, lengths: torch.Tensor,
                        tokens: torch.Tensor) -> tuple:
    """Chunked prompt admission: C sequential :func:`paged_trunk_step` calls
    in one dispatch of the decoder, so it is the token-by-token path.
    tokens (B, C) -> (hidden (B, C, d), pool)."""
    hs = []
    for c in range(tokens.shape[1]):
        h, pool = paged_trunk_step(cfg, params, pool, tables, lengths + c, tokens[:, c])
        hs.append(h)
    return torch.cat(hs, dim=1), pool


def paged_decode_step(cfg: GriffinConfig, params: dict, pool: dict, tables: torch.Tensor,
                      lengths: torch.Tensor, tokens: torch.Tensor) -> tuple:
    """Full paged step for a singleton (unmerged) program: trunk + head."""
    x, pool = paged_trunk_step(cfg, params, pool, tables, lengths, tokens)
    return head(cfg, params, x), pool
