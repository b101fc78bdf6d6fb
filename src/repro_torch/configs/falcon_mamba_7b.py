"""falcon-mamba-7b [ssm] — Mamba-1, attention-free, 64 layers.
[arXiv:2410.05355; hf:tiiuae/falcon-mamba-7b; unverified]  Same widths as
``repro.configs.falcon_mamba_7b``; blocks are per layer (``blocks/<i>/...``).
The JAX config's scan ``chunk`` is a tiling knob of its Pallas kernel; the
port's scan takes any sequence length and has none."""
from repro_torch.configs.base import LM_SHAPES
from repro_torch.models.ssm import MambaConfig

ARCH_ID = "falcon-mamba-7b"
FAMILY = "ssm"


def full_config() -> MambaConfig:
    return MambaConfig(
        name=ARCH_ID, n_layers=64, d_model=4096, d_inner=8192, d_state=16,
        d_conv=4, dt_rank=256, vocab_size=65024, norm="rmsnorm",
        tie_embeddings=False, dtype="bfloat16",
    )


def smoke_config() -> MambaConfig:
    return MambaConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, d_inner=128,
        d_state=8, dt_rank=4, vocab_size=512, dtype="float32",
    )


SHAPES = dict(LM_SHAPES)
SKIP: dict = {}  # attention-free: O(1)-state decode, long_500k runs
