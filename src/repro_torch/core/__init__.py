"""repro_torch.core — the port's own copy of the CannyFS engine.

Every module here but this one is a byte-identical copy of its original
in the JAX package's ``core`` (``tests/test_torch_train.py`` holds them
so); they import only each other and the standard library, so the port
needs nothing of the JAX package to checkpoint through the engine.  This
file exports what the port's checkpoint manager, training loop,
launchers and shard reader use, and the two remote backends (an object
store, an SFTP-like stream) that stage data; the other names stay
reachable through their modules.
"""
from .backend import (InMemoryBackend, LatencyBackend, LatencyModel,
                      LocalBackend, StorageBackend, is_under, norm_path)
from .errors import CannyError
from .flags import EagerFlags
from .fs import CannyFS
from .objectstore import ObjectStoreBackend, ObjectStoreModel
from .remote import RemoteStreamBackend, RemoteStreamModel

__all__ = ["CannyError", "CannyFS", "EagerFlags", "InMemoryBackend",
           "LatencyBackend", "LatencyModel", "LocalBackend",
           "ObjectStoreBackend", "ObjectStoreModel", "RemoteStreamBackend",
           "RemoteStreamModel", "StorageBackend", "is_under", "norm_path"]
