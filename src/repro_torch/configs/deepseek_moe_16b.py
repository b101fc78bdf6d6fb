"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6 fine-grained experts,
first layer dense.  [arXiv:2401.06066; hf]  Same widths as
``repro.configs.deepseek_moe_16b``; the dense first layer under
``dense_blocks/0``, the moe blocks under ``blocks/<i>``."""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, LM_SHAPES
from repro_torch.models.moe import MoELMConfig

ARCH_ID = "deepseek-moe-16b"
FAMILY = "moe"


def full_config() -> MoELMConfig:
    return MoELMConfig(
        name=ARCH_ID, n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        head_dim=128, d_ff=1408, vocab_size=102400,
        n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408,
        d_ff_dense=10944, first_dense_layers=1, capacity_factor=1.25,
        group_size=4096, norm="rmsnorm", act="silu", dtype="bfloat16",
    )


def smoke_config() -> MoELMConfig:
    return MoELMConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=32, vocab_size=512,
        n_experts=8, top_k=2, n_shared_experts=1, d_ff_expert=32,
        d_ff_dense=128, first_dense_layers=1, group_size=64,
        dtype="float32",
    )


SHAPES = dict(LM_SHAPES)
SKIP = {"long_500k": FULL_ATTENTION_SKIP}
