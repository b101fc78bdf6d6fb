"""Mamba-1 selective state-space LM (falcon-mamba-7b) — the port of
``repro.models.ssm`` for merge-and-serve and paged streaming decode.

Recurrence (per channel c, state dim n):

    h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t x_t
    y_t = C_t · h_t + D x_t

Parameters are nested dicts with per-layer blocks ``blocks/<i>/...`` (the
JAX package's ``scan_layers=False`` layout).  The recurrence goes through
``kernels.ops.mamba_scan``: the Hopper kernel on a CUDA tensor, the plain
version on a CPU tensor.  Both take any sequence length, so the identity
padding up to a chunk multiple that the JAX package's ``_run_scan`` does
for its Pallas kernel has no counterpart here.

Where the JAX package returns updated copies of a cache or state pool,
this port writes into it in place and returns the same tensors: the pool of
falcon-mamba-7b's decode is 4.7 GB.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import flatten_paths, torch_dtype


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    name: str = "mamba-lm"
    n_layers: int = 4
    d_model: int = 256
    d_inner: int = 512  # 2 * d_model
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 16  # d_model / 16
    vocab_size: int = 1000
    vocab_multiple: int = 256
    norm: str = "rmsnorm"
    tie_embeddings: bool = True
    dtype: str = "float32"  # numpy dtype name

    @property
    def padded_vocab(self) -> int:
        return L.padded_vocab(self.vocab_size, self.vocab_multiple)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_mixer(cfg: MambaConfig, gen, device) -> dict:
    d, di, n, r, dt = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.dtype
    # A = -[1..n] per channel (S4D-real), stored as its log
    A = torch.arange(1, n + 1, dtype=torch.float32, device=device).expand(di, n)
    u = L.uniform(gen, (di,), 0.0, 1.0, device)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    inv_softplus = torch.log(torch.expm1(dt_init))
    return {
        "in_proj": {"w": L.init_dense(gen, d, 2 * di, dt, device)},
        "conv": {
            "w": L.normal(gen, (cfg.d_conv, di), 1.0 / math.sqrt(cfg.d_conv), dt, device),
            "b": torch.zeros((di,), dtype=torch_dtype(dt), device=device),
        },
        "x_proj": {"w": L.init_dense(gen, di, r + 2 * n, dt, device)},
        "dt_proj": {"w": L.init_dense(gen, r, di, dt, device),
                    "b": inv_softplus.to(torch_dtype(dt))},
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": {"w": L.init_dense(gen, di, d, dt, device)},
    }


def init(cfg: MambaConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from ``seed``, generated on ``device`` (default
    ``cuda``; ``meta`` gives shapes only)."""
    device = resolve_device(device)
    gen = L.make_generator(seed, device)
    V = cfg.padded_vocab
    params: dict = {
        "embed": {"table": L.normal(gen, (V, cfg.d_model), 0.02, cfg.dtype, device)},
        "final_norm": L.init_norm(cfg.norm, cfg.d_model, cfg.dtype, device),
        "blocks": {str(i): {"ln": L.init_norm(cfg.norm, cfg.d_model, cfg.dtype, device),
                            "mixer": _init_mixer(cfg, gen, device)}
                   for i in range(cfg.n_layers)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": L.init_dense(gen, cfg.d_model, V, cfg.dtype, device)}
    return params


# ---------------------------------------------------------------------------
# Selective scan
# ---------------------------------------------------------------------------


def _ssm_coeffs(cfg: MambaConfig, p: dict, xc: torch.Tensor,
                taps: Optional[dict] = None, tap_path: str = "") -> tuple:
    """xc (B, S, di) post-conv activations -> the compact coefficients
    (dt, dtx, Bmat, Cmat, A), all float32; the (B, S, di, n) decay and input
    tensors are formed only inside the scan, one step at a time."""
    r, n = cfg.dt_rank, cfg.d_state
    dbc = L.dense(xc, p["x_proj"]["w"])  # (B, S, r + 2n)
    if taps is not None:
        taps[tap_path + "/x_proj"] = dbc
    dt_r, Bmat, Cmat = torch.split(dbc, [r, n, n], dim=-1)
    dt = L.softplus(L.dense(dt_r, p["dt_proj"]["w"]).float()
                    + p["dt_proj"]["b"].float())  # (B, S, di)
    if taps is not None:
        taps[tap_path + "/dt_proj"] = dt
    A = -torch.exp(p["A_log"])  # (di, n)
    dtx = dt * xc.float()
    return dt, dtx, Bmat.float(), Cmat.float(), A


def _conv1d(xz: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            history: Optional[torch.Tensor] = None) -> tuple:
    """Depthwise causal conv: xz (B, S, di), w (K, di), history (B, K-1, di)
    or None (zeros).  Returns (out in xz's dtype, the new history)."""
    B, S, di = xz.shape
    K = w.shape[0]
    if history is None:
        history = torch.zeros((B, K - 1, di), dtype=xz.dtype, device=xz.device)
    xpad = torch.cat([history, xz], dim=1)  # (B, S + K - 1, di)
    out = torch.zeros((B, S, di), dtype=torch.float32, device=xz.device)
    for j in range(K):
        out = out + xpad[:, j:j + S].float() * w[j].float()
    out = out + b.float()
    new_hist = xpad[:, S:] if K > 1 else history
    return out.to(xz.dtype), new_hist


def _mixer(cfg: MambaConfig, p: dict, x: torch.Tensor,
           state: Optional[dict] = None, taps: Optional[dict] = None,
           tap_path: str = "") -> tuple:
    """x (B, S, d); state {"h": (B, di, n), "conv": (B, K-1, di)} or None.
    Returns (y (B, S, d), new state).  ``taps`` collects the sub-layer
    responses keyed by param-path prefix, as the JAX package's do."""
    B = x.shape[0]
    xz = L.dense(x, p["in_proj"]["w"])  # (B, S, 2 di)
    if taps is not None:
        taps[tap_path + "/in_proj"] = xz
    x_ssm, z = xz.chunk(2, dim=-1)
    xc, new_conv = _conv1d(x_ssm, p["conv"]["w"], p["conv"]["b"],
                           state["conv"] if state is not None else None)
    xc = F.silu(xc.float()).to(x.dtype)
    if taps is not None:
        taps[tap_path + "/conv"] = xc
    dt, dtx, Bmat, Cmat, A = _ssm_coeffs(cfg, p, xc, taps, tap_path)
    h0 = state["h"] if state is not None else torch.zeros(
        (B, cfg.d_inner, cfg.d_state), dtype=torch.float32, device=x.device)
    y, h_last = kops.mamba_scan(dt, dtx, Bmat.contiguous(), Cmat.contiguous(), A,
                                h0.contiguous())
    y = y + p["D"].float() * xc.float()
    if taps is not None:
        # keyed on the mixer prefix itself: the direct leaves A_log and D
        # map here under core.policy.default_layer_key
        taps[tap_path] = y
    y = y * F.silu(z.float())
    out = L.dense(y.to(x.dtype), p["out_proj"]["w"])
    if taps is not None:
        taps[tap_path + "/out_proj"] = out
    return out, {"h": h_last, "conv": new_conv}


def _block(cfg: MambaConfig, p: dict, x: torch.Tensor,
           state: Optional[dict] = None, taps: Optional[dict] = None,
           tap_path: str = "") -> tuple:
    h = L.apply_norm(cfg.norm, x, p.get("ln", {}))
    if taps is not None:
        taps[tap_path + "/ln"] = h
    y, new_state = _mixer(cfg, p["mixer"], h, state, taps, tap_path + "/mixer")
    return x + y, new_state


# ---------------------------------------------------------------------------
# Forward, and the mergeable split: trunk prefix / head suffix
# ---------------------------------------------------------------------------


def trunk(cfg: MambaConfig, params: dict, tokens: torch.Tensor,
          taps: Optional[dict] = None) -> torch.Tensor:
    """Embedding + mamba blocks — the mergeable *prefix*.  Returns
    pre-final-norm hidden states (B, S, d).  The recurrence is position-aware
    by construction: no rope, no positions.  ``taps`` collects per-layer
    probes keyed by param-path prefix."""
    x = L.embed(tokens, params["embed"]["table"])
    if taps is not None:
        taps["embed"] = x
    for i in range(cfg.n_layers):
        x, _ = _block(cfg, params["blocks"][str(i)], x, taps=taps, tap_path=f"blocks/{i}")
    return x


def head(cfg: MambaConfig, params: dict, x: torch.Tensor,
         taps: Optional[dict] = None) -> torch.Tensor:
    """Final norm + unembedding — the private *suffix*.  float32 logits."""
    fn = params.get("final_norm", {})
    x = L.apply_norm(cfg.norm, x, fn)
    if taps is not None and fn:
        taps["final_norm"] = x
    if cfg.tie_embeddings:
        return L.unembed(x, params["embed"]["table"], transpose=True)
    logits = L.unembed(x, params["lm_head"]["w"], transpose=False)
    if taps is not None:
        taps["lm_head"] = logits
    return logits


def forward(cfg: MambaConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab) float32, composed as
    ``head(trunk(x))`` so the serving split is bitwise identical to it."""
    return head(cfg, params, trunk(cfg, params, tokens))


def loss_fn(cfg: MambaConfig, params: dict, batch: dict) -> torch.Tensor:
    logits = forward(cfg, params, batch["tokens"])
    return L.softmax_cross_entropy(logits, batch["labels"], valid_vocab=cfg.vocab_size,
                                   mask=batch.get("mask"))


@torch.no_grad()
def layer_activations(cfg: MambaConfig, params: dict, tokens: torch.Tensor) -> dict:
    """Calibration-batch activations for every layer, keyed by param-path
    prefix, as float32 numpy on the host."""
    taps: dict = {}
    head(cfg, params, trunk(cfg, params, tokens, taps=taps), taps=taps)
    return {k: v.float().cpu().numpy() for k, v in taps.items()}


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


def bank_head(cfg: MambaConfig, bank_params: dict, x: torch.Tensor) -> torch.Tensor:
    """Every private head of a merged group in ONE ``ops.bank_matmul``:
    each member's final norm as in :func:`head`, then one grouped GEMM.
    Returns (N, B, S, V); row ``n`` equals :func:`head` on member ``n``."""
    if cfg.tie_embeddings:
        raise ValueError("tied-embedding heads have no bank path")
    n_bank = bank_params["lm_head"]["w"].shape[0]
    fn = bank_params.get("final_norm") or {}
    xn = torch.stack([
        L.apply_norm(cfg.norm, x, {k: v[i] for k, v in fn.items()})
        for i in range(n_bank)])
    B, S, d = x.shape
    logits = kops.bank_matmul(xn.reshape(n_bank, B * S, d), bank_params["lm_head"]["w"])
    return logits.reshape(n_bank, B, S, -1)


# ---------------------------------------------------------------------------
# Stateful decode: O(1) recurrent state per request
# ---------------------------------------------------------------------------


def init_cache(cfg: MambaConfig, batch: int, max_len: int = 0, dtype=None,
               device=None) -> dict:
    """Recurrent state over layers: h (L, B, di, n) float32, conv history
    (L, B, K-1, di), and ``length`` (a Python int).  ``max_len`` is unused:
    the state does not grow with the sequence."""
    del max_len
    device = resolve_device(device)
    return {
        "h": torch.zeros((cfg.n_layers, batch, cfg.d_inner, cfg.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.d_conv - 1, cfg.d_inner),
                            dtype=torch_dtype(dtype or cfg.dtype), device=device),
        "length": 0,
    }


def decode_step(cfg: MambaConfig, params: dict, cache: dict,
                tokens: torch.Tensor) -> tuple:
    """tokens (B, S_new) -> (logits (B, S_new, V) float32, cache with the new
    state written in place and ``length`` advanced).  Works for a prompt
    too: the scan carries the state over every new token."""
    x = L.embed(tokens, params["embed"]["table"])
    h, conv = cache["h"], cache["conv"]
    for i in range(cfg.n_layers):
        x, st = _block(cfg, params["blocks"][str(i)], x, {"h": h[i], "conv": conv[i]})
        h[i] = st["h"]
        conv[i] = st["conv"]
    return head(cfg, params, x), {"h": h, "conv": conv,
                                  "length": cache["length"] + tokens.shape[1]}


# ---------------------------------------------------------------------------
# Paged decode: the recurrent state in the serving pool
# ---------------------------------------------------------------------------


def init_state_pool(cfg: MambaConfig, num_pages: int, page_size: int, dtype=None,
                    device=None) -> dict:
    """Pool of recurrent states for ``serving.decode.PagedKVPool``.  A
    request's whole state lives in its FIRST page slot (``tables[:, 0]``);
    ``page_size`` only shapes the admission ledger.  The keys mirror the KV
    pools' ("k" = scan state h, "v" = conv history), so the decode loop's
    pool plumbing is family-agnostic."""
    del page_size
    device = resolve_device(device)
    return {
        "k": torch.zeros((cfg.n_layers, num_pages, cfg.d_inner, cfg.d_state),
                         dtype=torch.float32, device=device),
        "v": torch.zeros((cfg.n_layers, num_pages, cfg.d_conv - 1, cfg.d_inner),
                         dtype=torch_dtype(dtype or cfg.dtype), device=device),
    }


def paged_trunk_step(cfg: MambaConfig, params: dict, pool: dict, tables: torch.Tensor,
                     lengths: torch.Tensor, tokens: torch.Tensor) -> tuple:
    """One decode step over the paged state pool, layer by layer: read each
    row's state from its page-0 slot, run the same block as
    :func:`decode_step`, write the new state back in place.  A row with
    ``lengths == 0`` (a fresh admission, possibly onto a recycled page)
    reads exact zeros, and the write-back then clears the recycled slot.
    Padded batch rows may duplicate a real row; the duplicate writes carry
    the same values.  tokens (B,) -> (hidden (B, 1, d), pool)."""
    sid = tables[:, 0].long()
    fresh = lengths == 0
    x = L.embed(tokens[:, None], params["embed"]["table"])
    pk, pv = pool["k"], pool["v"]
    for i in range(cfg.n_layers):
        state = {"h": pk[i].index_select(0, sid).masked_fill(fresh[:, None, None], 0.0),
                 "conv": pv[i].index_select(0, sid).masked_fill(fresh[:, None, None], 0.0)}
        x, st = _block(cfg, params["blocks"][str(i)], x, state)
        pk[i].index_copy_(0, sid, st["h"])
        pv[i].index_copy_(0, sid, st["conv"].to(pv.dtype))
    return x, {"k": pk, "v": pv}


def paged_prefill_chunk(cfg: MambaConfig, params: dict, pool: dict,
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


def paged_decode_step(cfg: MambaConfig, params: dict, pool: dict, tables: torch.Tensor,
                      lengths: torch.Tensor, tokens: torch.Tensor) -> tuple:
    """Full paged step for a singleton (unmerged) program: trunk + head."""
    x, pool = paged_trunk_step(cfg, params, pool, tables, lengths, tokens)
    return head(cfg, params, x), pool
