"""repro_torch.parallel — activation-checkpoint (remat) policies."""
from .remat import POLICIES, wrap_remat

__all__ = ["POLICIES", "wrap_remat"]
