"""Mixture-of-Experts decoder LM (olmoe-1b-7b: 64 routed experts, top-8;
deepseek-moe-16b's shared experts and dense first layers are in the config
too) — the port of ``repro.models.moe`` for merge-and-serve,
prefill and paged streaming decode.

Routing is the GShard/Switch capacity formulation written as dense
products, as the JAX package writes it:

    tokens (B, S, d) -> groups (G, s, d)
    router -> top-k -> dispatch (G, s, E, C) / combine (G, s, E, C)
    expert_in  = dispatch^T x           : (E, G, C, d)
    expert_out = per-expert gated FFN   : (E, G, C, d)
    y          = combine expert_out     : (G, s, d)

Every shape is static and nothing reads a value back to the host (no
``.item()``, ``nonzero`` or boolean indexing), so a decode step stays
capturable in a CUDA graph (``serving.graphs``).  The expert products are
plain batched GEMMs (the JAX package leaves them to XLA's einsum, outside
any Pallas kernel); they keep its float32 points: the gate and up products
are float32 sums of bf16 operands, the down product and the combine round
once to the activation dtype.  The attention half of each block is the
dense family's (``transformer._block`` with this module's ``ffn``), so
full-sequence attention goes through ``ops.flash_attention`` and one-token
decode attention through ``ops.decode_attention``.  One device: the JAX
package's sharding hints (``constrain``) have no counterpart.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import torch_dtype


@dataclasses.dataclass(frozen=True)
class MoELMConfig(T.DenseLMConfig):
    name: str = "moe-lm"
    n_experts: int = 8
    top_k: int = 2
    n_shared_experts: int = 0  # deepseek: 2
    d_ff_expert: int = 128  # per-expert hidden (the spec's d_ff)
    d_ff_dense: int = 512  # dense-FFN layers (deepseek layer 0)
    first_dense_layers: int = 0  # deepseek: 1
    capacity_factor: float = 1.25
    group_size: int = 512  # routing group (tokens)
    norm_topk_prob: bool = False
    router_aux_weight: float = 0.01

    def capacity(self, s: int) -> int:
        return max(int(math.ceil(s * self.top_k * self.capacity_factor / self.n_experts)), 1)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_moe_ffn(cfg: MoELMConfig, gen, device) -> dict:
    d, fe, E, dt = cfg.d_model, cfg.d_ff_expert, cfg.n_experts, cfg.dtype
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(fe)
    p = {
        "router": {"w": L.normal(gen, (d, E), s_in, "float32", device)},
        "experts": {
            "w_gate": L.normal(gen, (E, d, fe), s_in, dt, device),
            "w_up": L.normal(gen, (E, d, fe), s_in, dt, device),
            "w_down": L.normal(gen, (E, fe, d), s_out, dt, device),
        },
    }
    if cfg.n_shared_experts > 0:
        p["shared"] = L.init_ffn(gen, d, cfg.n_shared_experts * fe, dt, device, gated=True)
    return p


def _init_block(cfg: MoELMConfig, gen, device, dense_ffn: bool) -> dict:
    p = T._init_block(dataclasses.replace(cfg, d_ff=cfg.d_ff_dense), gen, device)
    if not dense_ffn:
        del p["mlp"]
        p["moe"] = _init_moe_ffn(cfg, gen, device)
    return p


def init(cfg: MoELMConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from ``seed``, generated on ``device`` (default
    ``cuda``; ``meta`` gives shapes only).  The first ``first_dense_layers``
    blocks live under ``dense_blocks/<i>``, the moe blocks under
    ``blocks/<i>``, as in the JAX package."""
    device = resolve_device(device)
    gen = L.make_generator(seed, device)
    V = cfg.padded_vocab
    params: dict = {
        "embed": {"table": L.normal(gen, (V, cfg.d_model), 0.02, cfg.dtype, device)},
        "final_norm": L.init_norm(cfg.norm, cfg.d_model, cfg.dtype, device),
    }
    if cfg.first_dense_layers:
        params["dense_blocks"] = {str(i): _init_block(cfg, gen, device, dense_ffn=True)
                                  for i in range(cfg.first_dense_layers)}
    params["blocks"] = {str(i): _init_block(cfg, gen, device, dense_ffn=False)
                        for i in range(cfg.n_layers - cfg.first_dense_layers)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": L.init_dense(gen, cfg.d_model, V, cfg.dtype, device)}
    return params


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot over the last axis; an index outside [0, n) gives a
    row of zeros, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k(cfg: MoELMConfig, probs: torch.Tensor) -> tuple:
    """(values, indices) of the ``top_k`` largest router probabilities over
    the last axis, the lower index first among equal ones
    (``jax.lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :cfg.top_k], idx[..., :cfg.top_k]


def route(cfg: MoELMConfig, router_w: torch.Tensor, x: torch.Tensor) -> tuple:
    """x (G, s, d) -> (dispatch (G, s, E, C), combine (G, s, E, C), aux).

    The top k experts of each token by router probability (:func:`top_k`).
    A token's place in an expert's queue counts the
    (token, k) pairs ahead of it k-major (lower k first, then token order);
    pairs at or past the capacity C are dropped.  ``aux`` is the
    Switch-style load-balance loss."""
    G, s, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = cfg.capacity(s)
    logits = torch.einsum("gsd,de->gse", x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)  # (G, s, E)
    gate_vals, expert_idx = top_k(cfg, probs)  # (G, s, K)
    if cfg.norm_topk_prob:
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    sel = _one_hot(expert_idx, E)  # (G, s, K, E)
    flat = sel.transpose(1, 2).reshape(G, K * s, E)  # k-major
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, K, s, E).transpose(1, 2)
    kept = (pos < C).float() * sel  # (G, s, K, E): routed and within capacity
    pos_oh = _one_hot((pos * sel).sum(-1).to(torch.int32), C)  # (G, s, K, C)
    dispatch = torch.einsum("gske,gskc->gsec", kept, pos_oh)
    combine = torch.einsum("gske,gskc,gsk->gsec", kept, pos_oh, gate_vals)
    density = sel.sum(2).mean(dim=1)  # (G, E) fraction routed
    density_probs = probs.mean(dim=1)  # (G, E)
    aux = (density * density_probs).mean() * (E ** 2) / K
    return dispatch, combine, aux


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (n, m, k) @ b (n, k, f) as float32 sums: half-precision operands
    on the card through one GEMM with a float32 output (as ``unembed``),
    else both widened first."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) and b.dtype == a.dtype:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def moe_ffn(cfg: MoELMConfig, p: dict, x: torch.Tensor, taps: Optional[dict] = None,
            tap_path: str = "") -> tuple:
    """x (B, S, d) -> (y (B, S, d), aux).  Tokens are routed in groups of
    ``min(group_size, B S)``.  ``taps`` receives the routing decision
    (``<tap_path>/router``, the combine weights (B, S, E, C)), the routed
    experts' output (``/experts``) and the shared experts' (``/shared``)."""
    B, S, d = x.shape
    N = B * S
    s = min(cfg.group_size, N)
    if N % s:
        raise ValueError(f"moe: tokens {N} not divisible by group {s}")
    G = N // s
    E = cfg.n_experts
    xg = x.reshape(G, s, d)
    dispatch, combine, aux = route(cfg, p["router"]["w"], xg)
    C = dispatch.shape[-1]
    if taps is not None:
        taps[tap_path + "/router"] = combine.reshape(B, S, E, -1)
    # expert_in (E, G C, d): each slot copies one token (a one-hot sum, exact)
    ein = torch.bmm(dispatch.to(x.dtype).reshape(G, s, E * C).transpose(1, 2), xg)
    ein = ein.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    w = p["experts"]
    h = (F.silu(_bmm_f32(ein, w["w_gate"])) * _bmm_f32(ein, w["w_up"])).to(x.dtype)
    eout = torch.bmm(h, w["w_down"])  # (E, G C, d), one rounding to x's dtype
    eout = eout.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)
    y = torch.bmm(combine.to(x.dtype).reshape(G, s, E * C), eout).reshape(B, S, d)
    if taps is not None:
        taps[tap_path + "/experts"] = y
    if cfg.n_shared_experts > 0:
        sh = L.ffn(x, p["shared"], act=cfg.act, gated=True)
        if taps is not None:
            taps[tap_path + "/shared"] = sh
        y = y + sh
    return y, aux


# ---------------------------------------------------------------------------
# Blocks / forward
# ---------------------------------------------------------------------------


def _moe_ffn(cfg: MoELMConfig, p: dict, auxes: Optional[list] = None):
    """The moe block's feed-forward for ``transformer._block`` and the
    decode blocks; each call's aux goes to ``auxes`` when given."""
    def ffn(h, taps=None, tap_prefix=""):
        y, aux = moe_ffn(cfg, p["moe"], h, taps=taps, tap_path=tap_prefix + "moe")
        if auxes is not None:
            auxes.append(aux)
        return y
    return ffn


def _stack(cfg: MoELMConfig, params: dict, tokens: torch.Tensor,
           taps: Optional[dict] = None) -> tuple:
    """Embedding + dense and moe blocks over positions 0..S-1.  Returns
    (hidden (B, S, d), the summed router aux loss)."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    x = L.embed(tokens, params["embed"]["table"])
    if taps is not None:
        taps["embed"] = x
    for i in range(cfg.first_dense_layers):
        x = T._block(cfg, params["dense_blocks"][str(i)], x, positions, taps=taps,
                     tap_prefix=f"dense_blocks/{i}/")
    auxes: list = []
    for i in range(cfg.n_layers - cfg.first_dense_layers):
        p = params["blocks"][str(i)]
        x = T._block(cfg, p, x, positions, taps=taps, tap_prefix=f"blocks/{i}/",
                     ffn=_moe_ffn(cfg, p, auxes))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in auxes:
        aux = aux + a
    return x, aux


def trunk(cfg: MoELMConfig, params: dict, tokens: torch.Tensor,
          taps: Optional[dict] = None) -> torch.Tensor:
    """The serving *prefix*: :func:`_stack` without the router aux loss
    (inference never consumes it).  ``head(trunk(x))`` is
    ``forward(x)[0]``."""
    return _stack(cfg, params, tokens, taps=taps)[0]


# the suffix is the dense family's: moe-ness lives in the trunk, so the
# head, its bank and the path partitioners are shared
head = T.head
bank_head = T.bank_head
trunk_paths = T.trunk_paths
head_paths = T.head_paths


def forward(cfg: MoELMConfig, params: dict, tokens: torch.Tensor) -> tuple:
    """tokens (B, S) -> (logits (B, S, padded_vocab) float32, aux loss)."""
    x, aux = _stack(cfg, params, tokens)
    return head(cfg, params, x), aux


@torch.no_grad()
def layer_activations(cfg: MoELMConfig, params: dict, tokens: torch.Tensor) -> dict:
    """Calibration-batch activations keyed by param-path prefix (the
    router's combine weights among them), as float32 numpy on the host."""
    taps: dict = {}
    head(cfg, params, trunk(cfg, params, tokens, taps=taps), taps=taps)
    return {k: v.float().cpu().numpy() for k, v in taps.items()}


def loss_fn(cfg: MoELMConfig, params: dict, batch: dict) -> torch.Tensor:
    logits, aux = forward(cfg, params, batch["tokens"])
    ce = L.softmax_cross_entropy(logits, batch["labels"], valid_vocab=cfg.vocab_size,
                                 mask=batch.get("mask"))
    return ce + cfg.router_aux_weight * aux


# ---------------------------------------------------------------------------
# KV cache + decode (written in place, as the dense family's)
# ---------------------------------------------------------------------------


def init_cache(cfg: MoELMConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """Contiguous KV caches: k/v (L_moe, B, Smax, Hs, D) for the moe blocks,
    k_dense/v_dense for the dense first blocks (when there are any), and
    ``length`` (a 0-d int32 tensor on the cache's device)."""
    device = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    nd = cfg.first_dense_layers
    tail = (batch, max_len, cfg.kv_stored_heads, cfg.head_dim)
    out = {"k": torch.zeros((cfg.n_layers - nd, *tail), dtype=dt, device=device),
           "v": torch.zeros((cfg.n_layers - nd, *tail), dtype=dt, device=device),
           "length": torch.zeros((), dtype=torch.int32, device=device)}
    if nd:
        out["k_dense"] = torch.zeros((nd, *tail), dtype=dt, device=device)
        out["v_dense"] = torch.zeros((nd, *tail), dtype=dt, device=device)
    return out


def decode_step(cfg: MoELMConfig, params: dict, cache: dict, tokens: torch.Tensor) -> tuple:
    """tokens (B, S_new) -> (logits (B, S_new, V) float32, cache with the new
    k/v written and ``length`` advanced in place).  The router aux loss is
    discarded."""
    B, Sn = tokens.shape
    length = cache["length"]
    positions = (length + torch.arange(Sn, dtype=torch.int32,
                                       device=tokens.device)).expand(B, Sn)
    x = L.embed(tokens, params["embed"]["table"])
    for i in range(cfg.first_dense_layers):
        x, _ = T._block_decode(cfg, params["dense_blocks"][str(i)],
                               {"k": cache["k_dense"][i], "v": cache["v_dense"][i]},
                               x, positions, length)
    for i in range(cfg.n_layers - cfg.first_dense_layers):
        p = params["blocks"][str(i)]
        x, _ = T._block_decode(cfg, p, {"k": cache["k"][i], "v": cache["v"][i]}, x,
                               positions, length, ffn=_moe_ffn(cfg, p))
    length.add_(Sn)
    return head(cfg, params, x), cache


def prefill(cfg: MoELMConfig, params: dict, tokens: torch.Tensor, max_len: int) -> tuple:
    """Prefill the caches of :func:`init_cache` from a whole prompt (B, S)
    through ``transformer._block_prefill`` (flash attention) with the
    dense or routed feed-forward.  Returns (logits (B, 1, V) of the last
    position, cache with ``length`` S)."""
    B, S = tokens.shape
    positions = T.standard_positions(tokens)
    x = L.embed(tokens, params["embed"]["table"])
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    for i in range(cfg.first_dense_layers):
        x = T._block_prefill(cfg, params["dense_blocks"][str(i)], x, positions,
                             {"k": cache["k_dense"][i], "v": cache["v_dense"][i]})
    for i in range(cfg.n_layers - cfg.first_dense_layers):
        p = params["blocks"][str(i)]
        x = T._block_prefill(cfg, p, x, positions, {"k": cache["k"][i], "v": cache["v"][i]},
                             ffn=_moe_ffn(cfg, p))
    cache["length"].fill_(S)
    return head(cfg, params, x[:, -1:]), cache


# ---------------------------------------------------------------------------
# Paged decode: pool storage + per-request page tables
# ---------------------------------------------------------------------------


def _check_paged(cfg: MoELMConfig) -> None:
    if cfg.first_dense_layers:
        raise ValueError("moe: paged decode supports first_dense_layers=0 only "
                         f"(got {cfg.first_dense_layers})")
    if cfg.window is not None:
        raise ValueError("paged decode requires full attention (window=None)")


def init_kv_pool(cfg: MoELMConfig, num_pages: int, page_size: int, dtype=None,
                 device=None) -> dict:
    """Paged KV pool k/v (L, P, page, Hs, D) of the moe blocks.  Paged moe
    serving takes ``first_dense_layers == 0`` (olmoe-style) and per-token
    routing: the serving adapter decodes with ``group_size=1``, so each token
    is its own routing group and capacity never drops it."""
    _check_paged(cfg)
    return T.init_kv_pool(cfg, num_pages, page_size, dtype=dtype, device=device)


def paged_trunk_step(cfg: MoELMConfig, params: dict, pool: dict, tables: torch.Tensor,
                     lengths: torch.Tensor, tokens: torch.Tensor) -> tuple:
    """Shared-trunk paged decode step, ONE new token per row: tokens (B,);
    tables (B, maxp); lengths (B,).  Writes the pool in place; returns
    (hidden (B, 1, d), pool)."""
    _check_paged(cfg)
    tables = tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32)
    x = L.embed(tokens[:, None], params["embed"]["table"])
    pk, pv = pool["k"], pool["v"]
    for i in range(cfg.n_layers):
        p = params["blocks"][str(i)]
        x, _ = T._block_decode_paged(cfg, p, {"k": pk[i], "v": pv[i]}, x, tables, lengths,
                                     ffn=_moe_ffn(cfg, p))
    return x, {"k": pk, "v": pv}


def paged_prefill_chunk(cfg: MoELMConfig, params: dict, pool: dict, tables: torch.Tensor,
                        lengths: torch.Tensor, tokens: torch.Tensor) -> tuple:
    """Chunked prompt admission: C sequential :func:`paged_trunk_step` calls
    in one dispatch of the decoder.  tokens (B, C) -> (hidden (B, C, d),
    pool)."""
    lengths = lengths.to(torch.int32)
    hs = []
    for c in range(tokens.shape[1]):
        h, pool = paged_trunk_step(cfg, params, pool, tables, lengths + c, tokens[:, c])
        hs.append(h)
    return torch.cat(hs, dim=1), pool


def paged_decode_step(cfg: MoELMConfig, params: dict, pool: dict, tables: torch.Tensor,
                      lengths: torch.Tensor, tokens: torch.Tensor) -> tuple:
    """Paged twin of :func:`decode_step` (logits only)."""
    x, pool = paged_trunk_step(cfg, params, pool, tables, lengths, tokens)
    return head(cfg, params, x), pool
