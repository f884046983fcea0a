"""Moonshot Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (MHA kv=16) vocab=163840; fine-grained MoE: 64 experts
top-6 with expert d_ff=1408, plus 2 always-on shared experts (DeepSeek-MoE
style, 2*1408=2816 shared hidden).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    block_pattern=("attn",),
    num_experts=64,
    experts_per_token=6,
    moe_dff=1408,
    shared_expert_dff=2816,
    capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="moonshot-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=64,
    vocab_size=128,
    block_pattern=("attn",),
    num_experts=8,
    experts_per_token=2,
    moe_dff=64,
    shared_expert_dff=64,
)
