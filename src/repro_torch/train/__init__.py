"""repro_torch.train — the serving steps (training waits for a later
slice)."""
from .steps import make_decode_step, make_prefill_step

__all__ = ["make_decode_step", "make_prefill_step"]
