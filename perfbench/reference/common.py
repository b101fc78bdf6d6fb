"""What the plain references share: a unit's weights drawn again from the
seed and widened to float32, and the matrix product in float32 or, for the
control, in fp8 e4m3, the precision below the configurations' bf16."""
from __future__ import annotations

import torch

from perfbench.weights import draw_unit, units


def unit_weights(cfg: dict, layout: dict, seed: int, member: int, unit: str, device) -> dict:
    """{path: float32 tensor} of one member's unit, drawn as the run drew it."""
    leaves = units(layout)[unit]
    return {p: t.float() for p, t in
            draw_unit(seed, member, unit, leaves, cfg["norm"], device).items()}


def quantize_fp8(x, dim: int):
    """fp8 e4m3 along ``dim`` (one scale per slice of the other axis, the
    slice's largest magnitude at the format's 448), returned dequantized in
    float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x, w, fp8: bool = False):
    """x (..., K) @ w (K, N) in float32; with ``fp8`` the weight is
    quantized per output column and the activation per row first."""
    if fp8:
        x = quantize_fp8(x, -1)
        w = quantize_fp8(w, 0)
    return x @ w
