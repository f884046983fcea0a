"""HuBERT X-Large [arXiv:2106.07447].

48L d_model=1280 16H d_ff=5120 vocab=504 (k-means cluster targets);
encoder-only (bidirectional), masked-prediction objective.  The conv
waveform frontend is a stub: input_specs provide precomputed 512-d frame
features.  No decode step (DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    block_pattern=("attn_bidir",),
    causal=False,
    act="gelu",
    modality="audio_stub",
)

SMOKE = ModelConfig(
    name="hubert-xlarge-smoke",
    family="encoder",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=32,
    block_pattern=("attn_bidir",),
    causal=False,
    act="gelu",
    modality="audio_stub",
)
