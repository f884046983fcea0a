"""repro_torch.models — the PyTorch model stack (attention and RG-LRU
mixers with dense FFNs, so far)."""
from .config import ATTN_KINDS, MIXER_KINDS, ModelConfig
from .model import decode_step, forward_train, init_cache, init_params, prefill

__all__ = [
    "ATTN_KINDS", "MIXER_KINDS", "ModelConfig", "decode_step",
    "forward_train", "init_cache", "init_params", "prefill",
]
