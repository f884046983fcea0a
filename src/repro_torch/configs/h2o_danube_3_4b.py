"""H2O-Danube3-4B [arXiv:2401.16818 family].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000; llama+mistral mix
with sliding-window attention (window 4096) — sub-quadratic decode, so
long_500k runs (DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    block_pattern=("attn_sliding",),
    window=4096,
)

SMOKE = ModelConfig(
    name="h2o-danube-3-4b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=128,
    block_pattern=("attn_sliding",),
    window=16,
)
