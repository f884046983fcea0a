"""repro_torch.optim — AdamW and the learning-rate schedules."""
from .adamw import AdamWConfig, adamw_update, global_norm, init_opt_state
from .schedule import constant, cosine_with_warmup

__all__ = ["AdamWConfig", "adamw_update", "constant", "cosine_with_warmup",
           "global_norm", "init_opt_state"]
