"""StableLM-3B class config [hf:stabilityai/stablelm-2-1_6b family].

32L d_model=2560 32H (MHA kv=32) d_ff=6912 vocab=50304.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    block_pattern=("attn",),
)

SMOKE = ModelConfig(
    name="stablelm-3b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=128,
    block_pattern=("attn",),
)
