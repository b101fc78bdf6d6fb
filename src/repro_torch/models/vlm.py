"""Vision-language model (internvl2-2b: InternViT + InternLM2) — the port of
``repro.models.vlm``.

The ViT frontend is a stub, as in the JAX package: the model takes
precomputed patch embeddings (B, n_patches, d_model) and prepends them to
the text-token embeddings before the dense LM stack (InternLM2 is a GQA
transformer, ``repro_torch.models.transformer``).  The positions of the
joined sequence are 0..P+S-1, so every block's attention goes through
``ops.flash_attention`` (the JAX package's masked attention over the same
positions computes the same function), in the forward and in the dense
family's prefill alike.  After the prefill, decode is the dense LM's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class VLMConfig(T.DenseLMConfig):
    name: str = "vlm"
    n_patches: int = 256  # stub frontend output length


init = T.init  # same parameter structure as the dense LM backbone
init_cache = T.init_cache
decode_step = T.decode_step


def _embed(params: dict, tokens: torch.Tensor, patch_embeds: torch.Tensor) -> torch.Tensor:
    """[patch embeddings, text embeddings] (B, P + S, d) in the table's dtype."""
    x_txt = L.embed(tokens, params["embed"]["table"])
    return torch.cat([patch_embeds.to(x_txt.dtype), x_txt], dim=1)


def forward(cfg: VLMConfig, params: dict, tokens: torch.Tensor,
            patch_embeds: torch.Tensor) -> torch.Tensor:
    """tokens (B, S_txt); patch_embeds (B, P, d_model) from the (stubbed)
    ViT.  Returns float32 logits over the WHOLE sequence (B, P + S_txt, V);
    callers slice the text span.  No logit softcap, as in the JAX package."""
    x = _embed(params, tokens, patch_embeds)
    positions = T.standard_positions(x)
    for i in range(cfg.n_layers):
        x = T._block(cfg, params["blocks"][str(i)], x, positions)
    x = L.apply_norm(cfg.norm, x, params.get("final_norm", {}))
    if cfg.tie_embeddings:
        return L.unembed(x, params["embed"]["table"], transpose=True)
    return L.unembed(x, params["lm_head"]["w"], transpose=False)


def loss_fn(cfg: VLMConfig, params: dict, batch: dict) -> torch.Tensor:
    logits = forward(cfg, params, batch["tokens"], batch["patch_embeds"])
    P = batch["patch_embeds"].shape[1]
    return L.softmax_cross_entropy(logits[:, P:], batch["labels"], valid_vocab=cfg.vocab_size,
                                   mask=batch.get("mask"))


def prefill(cfg: VLMConfig, params: dict, tokens: torch.Tensor, patch_embeds: torch.Tensor,
            max_len: int) -> tuple:
    """Prefill patches + prompt in one pass of the dense prefill at
    positions 0..P+S-1: (logits (B, 1, V) of the last position, cache with
    ``length`` P + S)."""
    x = _embed(params, tokens, patch_embeds)
    return T.prefill_from_embeddings(cfg, params, x, None, max_len)
