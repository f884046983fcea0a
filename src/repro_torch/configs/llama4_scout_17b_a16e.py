"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) vocab=202048; MoE 16 experts top-1 with an
always-on shared expert (d_ff=8192 each, A17B active); iRoPE layout —
3 of 4 layers use chunked local attention (chunk 8192, RoPE), every 4th
layer is global attention with NoPE.  The chunked layout is what makes
long_500k feasible (global layers use sequence-sharded decode attention,
DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=("attn_chunked", "attn_chunked", "attn_chunked",
                   "attn_global"),
    chunk_size=8192,
    rope_theta=500_000.0,
    num_experts=16,
    experts_per_token=1,
    moe_dff=8192,
    shared_expert_dff=8192,
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke",
    family="moe",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=128,
    block_pattern=("attn_chunked", "attn_chunked", "attn_chunked",
                   "attn_global"),
    chunk_size=16,
    num_experts=4,
    experts_per_token=1,
    moe_dff=128,
    shared_expert_dff=128,
)
