"""seamless-m4t-medium [audio] — encoder-decoder text backbone; the speech
frontend is a stub (``input_specs`` gives precomputed frame embeddings).
[arXiv:2308.11596; hf]  Same widths as
``repro.configs.seamless_m4t_medium``; layers are per layer
(``enc_blocks/<i>/...``, ``dec_blocks/<i>/...``)."""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, LM_SHAPES
from repro_torch.models.encdec import EncDecConfig

ARCH_ID = "seamless-m4t-medium"
FAMILY = "encdec"


def full_config() -> EncDecConfig:
    return EncDecConfig(
        name=ARCH_ID, n_enc_layers=12, n_dec_layers=12, d_model=1024,
        n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096,
        vocab_size=256206, norm="layernorm", act="relu", gated_ffn=False,
        tie_embeddings=True, dtype="bfloat16",
    )


def smoke_config() -> EncDecConfig:
    return EncDecConfig(
        name=ARCH_ID + "-smoke", n_enc_layers=2, n_dec_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        dtype="float32",
    )


SHAPES = dict(LM_SHAPES)
SKIP = {"long_500k": FULL_ATTENTION_SKIP}
