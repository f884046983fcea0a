"""RecurrentGemma-9B [arXiv:2402.19427 (Griffin); hf].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; hybrid 2:1
RG-LRU : local-attention pattern (window 2048), GeGLU, logit softcap,
tied embeddings.  38 = (rglru, rglru, attn_local) x 12 + (rglru, rglru)
remainder.  Bounded state -> long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "attn_local"),
    window=2048,
    act="gelu",
    lru_width=4096,
    logit_softcap=30.0,
    tie_embeddings=True,
    ssm_conv=4,
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    num_layers=5,              # exercises the remainder path (5 = 3 + 2)
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=128,
    block_pattern=("rglru", "rglru", "attn_local"),
    window=16,
    act="gelu",
    lru_width=64,
    logit_softcap=30.0,
    tie_embeddings=True,
    ssm_conv=4,
)
