"""qwen2-72b [dense] — 80L GQA kv=8, QKV bias.  [arXiv:2407.10671; hf]  Same
widths as ``repro.configs.qwen2_72b``; blocks are per layer
(``blocks/<i>/...``).  ``kv_repl=2``: the decode cache stores each kv head
twice."""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, LM_SHAPES
from repro_torch.models.transformer import DenseLMConfig

ARCH_ID = "qwen2-72b"
FAMILY = "dense"


def full_config() -> DenseLMConfig:
    return DenseLMConfig(
        name=ARCH_ID, n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=29568, vocab_size=152064, rope_theta=1e6,
        qkv_bias=True, norm="rmsnorm", act="silu", gated_ffn=True,
        dtype="bfloat16", kv_repl=2,
    )


def smoke_config() -> DenseLMConfig:
    return DenseLMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=128, vocab_size=512, qkv_bias=True,
        dtype="float32",
    )


SHAPES = dict(LM_SHAPES)
SKIP = {"long_500k": FULL_ATTENTION_SKIP}
