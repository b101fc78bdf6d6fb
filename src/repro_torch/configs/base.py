"""Shared architecture-config machinery (the port of ``repro.configs.base``).

Every ``configs/<arch_id>.py`` exposes:

    ARCH_ID, FAMILY            identifiers ("dense" | "moe" | "ssm" | ...)
    full_config()              the published config
    smoke_config()             reduced same-family config (CPU-runnable)
    SHAPES                     {shape_name: ShapeSpec}
    SKIP                       {shape_name: reason} for inapplicable cells

``input_specs(cfg, family, shape)`` and ``cache_specs`` return ``meta``
tensors where the JAX package returns ``ShapeDtypeStruct`` stand-ins: shape
and dtype, no allocation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.utils.tree import torch_dtype


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The assigned LM shape set (identical across the 10 archs).
LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

FULL_ATTENTION_SKIP = (
    "long_500k needs sub-quadratic attention; this arch is pure full "
    "attention (O(S^2) prefill, O(S) KV per decode step) — skipped per the "
    "assignment; see DESIGN.md §4."
)


def _spec(shape: tuple, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=torch_dtype(dtype), device="meta")


def token_specs(batch: int, seq: int) -> dict:
    return {"tokens": _spec((batch, seq), "int32"), "labels": _spec((batch, seq), "int32")}


def input_specs(cfg: Any, family: str, shape: ShapeSpec) -> dict:
    """``meta`` inputs of the step for this (cfg, shape): the batch of
    ``loss_fn`` (train), the prompt of ``prefill`` (prefill), or the tokens
    of ``decode_step`` (decode, its cache from :func:`cache_specs`)."""
    B, S = shape.global_batch, shape.seq_len
    if family == "encdec":
        if shape.kind == "decode":
            return {"tokens": _spec((B, 1), "int32")}
        half = S // 2
        out = {"src_embeds": _spec((B, half, cfg.d_model), cfg.dtype),
               "tokens": _spec((B, half), "int32")}
        if shape.kind == "train":
            out["labels"] = _spec((B, half), "int32")
        return out

    if family == "vlm":
        if shape.kind == "decode":
            return {"tokens": _spec((B, 1), "int32")}
        P = cfg.n_patches
        out = {"patch_embeds": _spec((B, P, cfg.d_model), cfg.dtype),
               "tokens": _spec((B, S - P), "int32")}
        if shape.kind == "train":
            out["labels"] = _spec((B, S - P), "int32")
        return out

    # decoder-only LM families
    if shape.kind == "train":
        return token_specs(B, S)
    if shape.kind == "prefill":
        return {"tokens": _spec((B, S), "int32")}
    return {"tokens": _spec((B, 1), "int32")}


def cache_specs(cfg: Any, family: str, shape: ShapeSpec) -> Optional[dict]:
    """``meta`` stand-in for the decode cache (``shape.kind == 'decode'``)."""
    if shape.kind != "decode":
        return None
    B, S = shape.global_batch, shape.seq_len
    length = _spec((), "int32")

    if family in ("dense", "vlm"):
        kv = (cfg.n_layers, B, S, cfg.kv_stored_heads, cfg.head_dim)
        return {"k": _spec(kv, cfg.dtype), "v": _spec(kv, cfg.dtype), "length": length}
    if family == "moe":
        nd = cfg.first_dense_layers
        tail = (B, S, cfg.kv_stored_heads, cfg.head_dim)
        out = {"k": _spec((cfg.n_layers - nd, *tail), cfg.dtype),
               "v": _spec((cfg.n_layers - nd, *tail), cfg.dtype), "length": length}
        if nd:
            out["k_dense"] = _spec((nd, *tail), cfg.dtype)
            out["v_dense"] = _spec((nd, *tail), cfg.dtype)
        return out
    if family == "ssm":
        return {"h": _spec((cfg.n_layers, B, cfg.d_inner, cfg.d_state), "float32"),
                "conv": _spec((cfg.n_layers, B, cfg.d_conv - 1, cfg.d_inner), cfg.dtype),
                "length": length}
    if family == "hybrid":
        R = cfg.n_repeats
        W = min(cfg.window, S)
        out: dict = {}
        for i, kind in enumerate(cfg.pattern):
            if kind == "rec":
                out[f"{i}_{kind}"] = {
                    "h": _spec((R, B, cfg.d_rnn), "float32"),
                    "conv": _spec((R, B, cfg.conv_width - 1, cfg.d_rnn), cfg.dtype)}
            else:
                kv = (R, B, W, cfg.kv_stored_heads, cfg.head_dim)
                out[f"{i}_{kind}"] = {"k": _spec(kv, cfg.dtype), "v": _spec(kv, cfg.dtype)}
        out["length"] = length
        return out
    if family == "encdec":
        Ld, Hs, D = cfg.n_dec_layers, cfg.kv_stored_heads, cfg.head_dim
        S_src = 1024  # cached cross-attn span
        kv = (Ld, B, S, Hs, D)
        cross = (Ld, B, S_src, Hs, D)
        return {"k": _spec(kv, cfg.dtype), "v": _spec(kv, cfg.dtype),
                "cross": {"k": _spec(cross, cfg.dtype), "v": _spec(cross, cfg.dtype)},
                "length": length}
    raise ValueError(family)
