"""Qwen2-VL-2B text backbone [arXiv:2409.12191; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936; M-RoPE; QKV bias.
The vision tower is a stub: input_specs provide precomputed patch embeddings
merged early-fusion style (DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    block_pattern=("attn",),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    pos_type="mrope",
    mrope_sections=(16, 24, 24),
    tie_embeddings=True,          # qwen2-vl-2b ties embeddings
    modality="vision_stub",
    frontend_tokens=1024,
)

SMOKE = ModelConfig(
    name="qwen2-vl-2b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=128,
    block_pattern=("attn",),
    qkv_bias=True,
    pos_type="mrope",
    mrope_sections=(4, 2, 2),
    tie_embeddings=True,
    modality="vision_stub",
    frontend_tokens=4,
)
