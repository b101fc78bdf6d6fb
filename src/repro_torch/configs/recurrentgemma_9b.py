"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, ~1:2 attn:rec.

38 layers: a pattern of 19 = 6 x (rec, rec, attn) + a trailing rec,
repeated twice -> 26 recurrent + 12 local-attention layers, MQA (one kv
head), window 2048, tied embeddings.  [arXiv:2402.19427;
hf:google/recurrentgemma-9b; unverified]  Same widths as
``repro.configs.recurrentgemma_9b``; layers are per repeat
(``repeats/<r>/<i>_<kind>/...``).
"""
from repro_torch.configs.base import LM_SHAPES
from repro_torch.models.griffin import GriffinConfig

ARCH_ID = "recurrentgemma-9b"
FAMILY = "hybrid"

_PATTERN = ("rec", "rec", "attn") * 6 + ("rec",)  # 19 layers x 2 repeats = 38


def full_config() -> GriffinConfig:
    return GriffinConfig(
        name=ARCH_ID, n_layers=38, pattern=_PATTERN,
        d_model=4096, d_rnn=4096, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, vocab_size=256000, window=2048, conv_width=4,
        norm="rmsnorm", act="gelu_tanh", tie_embeddings=True,
        logit_softcap=30.0, dtype="bfloat16",
    )


def smoke_config() -> GriffinConfig:
    return GriffinConfig(
        name=ARCH_ID + "-smoke", n_layers=6, pattern=("rec", "rec", "attn"),
        d_model=64, d_rnn=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, window=16, dtype="float32",
    )


SHAPES = dict(LM_SHAPES)
SKIP: dict = {}  # sub-quadratic (window 2048 + O(1) recurrent state): all run
