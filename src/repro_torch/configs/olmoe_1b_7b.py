"""olmoe-1b-7b [moe] — 64 routed experts, top-8, qk-norm.
[arXiv:2409.02060]  Same widths as
``repro.configs.olmoe_1b_7b``; blocks are per layer (``blocks/<i>/...``)."""
from repro_torch.models.moe import MoELMConfig

ARCH_ID = "olmoe-1b-7b"
FAMILY = "moe"


def full_config() -> MoELMConfig:
    return MoELMConfig(
        name=ARCH_ID, n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        head_dim=128, d_ff=1024, vocab_size=50304,
        n_experts=64, top_k=8, n_shared_experts=0, d_ff_expert=1024,
        first_dense_layers=0, capacity_factor=1.25, group_size=4096,
        qk_norm=True, norm="rmsnorm", act="silu", dtype="bfloat16",
    )


def smoke_config() -> MoELMConfig:
    return MoELMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=32, vocab_size=512,
        n_experts=8, top_k=2, d_ff_expert=32, group_size=64, qk_norm=True,
        dtype="float32",
    )
