"""repro_torch.checkpoint — transactional checkpoints on the engine."""
from .manager import (COMMIT_FILE, MANIFEST_FILE, SaveResult,
                      TransactionalCheckpointManager)

__all__ = ["COMMIT_FILE", "MANIFEST_FILE", "SaveResult",
           "TransactionalCheckpointManager"]
