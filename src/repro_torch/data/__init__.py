"""repro_torch.data — the synthetic corpus, the CannyFS shard writer and
reader, and the prefetcher."""
from .pipeline import Prefetcher, SyntheticLM, read_shards, write_shards

__all__ = ["Prefetcher", "SyntheticLM", "read_shards", "write_shards"]
