"""repro_torch.data — the synthetic corpus and the prefetcher."""
from .pipeline import Prefetcher, SyntheticLM

__all__ = ["Prefetcher", "SyntheticLM"]
