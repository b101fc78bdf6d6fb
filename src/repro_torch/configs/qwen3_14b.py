"""qwen3-14b [dense] — qk_norm, GQA kv=8.  [hf:Qwen/Qwen3-8B; hf]  Same widths
as ``repro.configs.qwen3_14b``; blocks are per layer (``blocks/<i>/...``)."""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, LM_SHAPES
from repro_torch.models.transformer import DenseLMConfig

ARCH_ID = "qwen3-14b"
FAMILY = "dense"


def full_config() -> DenseLMConfig:
    return DenseLMConfig(
        name=ARCH_ID, n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        head_dim=128, d_ff=17408, vocab_size=151936, rope_theta=1e6,
        qk_norm=True, norm="rmsnorm", act="silu", gated_ffn=True,
        dtype="bfloat16",
        # kv_repl=1: Hq=40 admits stored-head counts {8, 40}, neither a
        # multiple of the reference's TP=16 (it shards the KV sequence instead)
        kv_repl=1,
        # block_q=256 bounds the live scores of a prefill over explicit positions
        prefill_block_q=256,
    )


def smoke_config() -> DenseLMConfig:
    return DenseLMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=128, vocab_size=512, qk_norm=True,
        dtype="float32",
    )


SHAPES = dict(LM_SHAPES)
SKIP = {"long_500k": FULL_ATTENTION_SKIP}
