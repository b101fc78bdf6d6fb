"""internvl2-2b [vlm] — InternViT frontend (a stub: precomputed patch
embeddings) + InternLM2-1.8b backbone.  [arXiv:2404.16821; hf]  Same widths
as ``repro.configs.internvl2_2b``; blocks are per layer
(``blocks/<i>/...``)."""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, LM_SHAPES
from repro_torch.models.vlm import VLMConfig

ARCH_ID = "internvl2-2b"
FAMILY = "vlm"


def full_config() -> VLMConfig:
    return VLMConfig(
        name=ARCH_ID, n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=92553, norm="rmsnorm",
        act="silu", gated_ffn=True, n_patches=256, dtype="bfloat16", kv_repl=2,
    )


def smoke_config() -> VLMConfig:
    return VLMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512, n_patches=8,
        dtype="float32",
    )


SHAPES = dict(LM_SHAPES)
SKIP = {"long_500k": FULL_ATTENTION_SKIP}
