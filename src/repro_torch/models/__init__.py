"""repro_torch.models — the PyTorch model stack: attention, RG-LRU and SSD
mixers with dense or MoE FFNs, RoPE and M-RoPE, and the vision and audio
stub frontends."""
from .config import ATTN_KINDS, MIXER_KINDS, ModelConfig
from .layers import cross_entropy
from .model import (decode_step, forward_train, init_cache, init_params,
                    param_specs, prefill)

__all__ = [
    "ATTN_KINDS", "MIXER_KINDS", "ModelConfig", "cross_entropy",
    "decode_step", "forward_train", "init_cache", "init_params",
    "param_specs", "prefill",
]
