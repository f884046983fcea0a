"""Mamba2-130M [arXiv:2405.21060].

24L d_model=768, attention-free SSD (state-space duality), ssm_state=128,
vocab=50280.  Constant-size decode state -> long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=12,            # unused by ssd blocks
    num_kv_heads=12,
    d_ff=0,                  # no FFN: mamba2 backbone is mixer-only...
    vocab_size=50280,
    block_pattern=("ssd",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=128,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-130m-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=128,
    block_pattern=("ssd",),
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=16,
    tie_embeddings=True,
)
