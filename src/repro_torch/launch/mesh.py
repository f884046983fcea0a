"""Production and debug meshes: named ``DeviceMesh``es over the default
process group.

Functions, never module-level constants, so that importing this module
starts no process group.  The process group comes from ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
or, without it, is one rank on an in-process store.  The device is
explicit: ``cuda`` runs NCCL, ``cpu`` (only when the caller asks) gloo.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def init_distributed(device="cuda") -> None:
    """The default process group, once: NCCL on ``cuda``, gloo on ``cpu``;
    from ``torchrun``'s environment where it is set, else world size 1."""
    if dist.is_initialized():
        return
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def _fake_group() -> bool:
    """Whether the default group is a ``"fake"`` one (the dry-run's: ranks
    that exist as numbers only, no card behind them)."""
    return dist.is_initialized() and dist.get_backend() == "fake"


def _mesh(shape: tuple, axes: tuple, device):
    # over a fake group the mesh only names its device: no card is asked
    device = torch.device(device) if _fake_group() else resolve_device(device)
    init_distributed(device)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh {axes} needs {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """Single pod: 16x16 = 256 ranks (data, model).
    Multi-pod: 2 pods x 256 = 512 ranks (pod, data, model); 'pod' carries
    only gradient reduction (or pipeline stages) over the slow links."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_debug_mesh(n_devices: int | None = None, *, multi_pod: bool = False,
                    device="cuda"):
    """A small mesh over the ranks there are (tests / examples)."""
    init_distributed(device)
    n = n_devices or dist.get_world_size()
    if multi_pod and n >= 8:
        return _mesh((2, 2, n // 4), ("pod", "data", "model"), device)
    if n == 1:
        return _mesh((1, 1), ("data", "model"), device)
    d = 2 if n % 2 == 0 else 1
    return _mesh((d, n // d), ("data", "model"), device)
