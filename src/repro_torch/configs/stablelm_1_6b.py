"""stablelm-1.6b [dense] — MHA, partial rotary (25%), LayerNorm.
[hf:stabilityai/stablelm-2-1_6b; unverified]  Same widths as
``repro.configs.stablelm_1_6b``; blocks are per layer (``blocks/<i>/...``)."""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, LM_SHAPES
from repro_torch.models.transformer import DenseLMConfig

ARCH_ID = "stablelm-1.6b"
FAMILY = "dense"


def full_config() -> DenseLMConfig:
    return DenseLMConfig(
        name=ARCH_ID, n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        head_dim=64, d_ff=5632, vocab_size=100352, rotary_pct=0.25,
        norm="layernorm", act="silu", gated_ffn=True, dtype="bfloat16",
    )


def smoke_config() -> DenseLMConfig:
    return DenseLMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        rotary_pct=0.25, norm="layernorm", dtype="float32",
    )


SHAPES = dict(LM_SHAPES)
SKIP = {"long_500k": FULL_ATTENTION_SKIP}
