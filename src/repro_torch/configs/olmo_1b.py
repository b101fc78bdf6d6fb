"""olmo-1b [dense] — non-parametric LayerNorm, tied embeddings.
[arXiv:2402.00838]  Same widths as
``repro.configs.olmo_1b``; blocks are per layer (``blocks/<i>/...``)."""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, LM_SHAPES
from repro_torch.models.transformer import DenseLMConfig

ARCH_ID = "olmo-1b"
FAMILY = "dense"


def full_config() -> DenseLMConfig:
    return DenseLMConfig(
        name=ARCH_ID, n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        head_dim=128, d_ff=8192, vocab_size=50304, norm="nonparam_ln",
        act="silu", gated_ffn=True, tie_embeddings=True, dtype="bfloat16",
    )


def smoke_config() -> DenseLMConfig:
    return DenseLMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        norm="nonparam_ln", tie_embeddings=True, dtype="float32",
    )


SHAPES = dict(LM_SHAPES)
SKIP = {"long_500k": FULL_ATTENTION_SKIP}
