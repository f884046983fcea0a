"""Tree <-> bytes codec for checkpoints, in the reference's on-disk format.

Leaves are stored raw (the bytes of the CPU tensor) with their numpy dtype
name and shape in a JSON manifest; keys are the '/'-joined tree paths that
``jax.tree_util`` builds (dict keys sorted, list indices as numbers), so a
checkpoint written by either package restores in the other, bit for bit.
bfloat16 moves as its raw 16 bits (``view(torch.int16)`` and
``torch.frombuffer``): numpy has no such dtype without ``ml_dtypes``, and
the port needs nothing beyond numpy and torch.
"""
from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from repro_torch.tree import (key_str, tree_flatten_with_path,
                              tree_map_with_path)

# numpy dtype name <-> torch dtype, for every dtype a state can hold
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
           "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def _host(leaf) -> torch.Tensor:
    """The leaf as a contiguous CPU tensor (device tensors are copied to the
    host here: the only blocking device interaction of a save)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu").contiguous()
    a = np.asarray(leaf)
    return torch.from_numpy(a if a.flags.c_contiguous and a.flags.writeable
                            else a.copy())


def leaf_bytes(t: torch.Tensor) -> bytes:
    """The raw bytes of a contiguous CPU tensor."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def flatten_for_save(tree: Any) -> tuple[dict, list[tuple[str, torch.Tensor]]]:
    """-> (manifest dict, [(key, CPU tensor)])."""
    manifest = {"leaves": {}, "version": 1}
    out = []
    for path, leaf in tree_flatten_with_path(tree, _is_leaf):
        key = key_str(path)
        t = _host(leaf)
        if t.dtype not in _NAMES:
            raise TypeError(f"checkpoint leaf {key}: dtype {t.dtype}")
        manifest["leaves"][key] = {
            "dtype": _NAMES[t.dtype],
            "shape": list(t.shape),
            "nbytes": t.numel() * t.element_size(),
        }
        out.append((key, t))
    return manifest, out


def from_bytes(blob: bytes, meta: dict) -> torch.Tensor:
    """A CPU tensor of the manifest entry ``meta`` from its raw bytes."""
    dtype = _DTYPES[meta["dtype"]]
    if not blob:
        return torch.empty(meta["shape"], dtype=dtype)
    return torch.frombuffer(bytearray(blob), dtype=dtype).reshape(
        meta["shape"])


def unflatten_from(manifest: dict, blobs: dict[str, bytes], like: Any,
                   device=None):
    """Rebuild a tree with the structure of ``like`` from manifest + raw
    blobs, its tensors on ``device`` (None: the CPU)."""
    def leaf(path, _):
        key = key_str(path)
        t = from_bytes(blobs[key], manifest["leaves"][key])
        return t if device is None else t.to(device)

    return tree_map_with_path(leaf, like, _is_leaf)


def manifest_bytes(manifest: dict) -> bytes:
    return json.dumps(manifest, indent=1).encode()


def parse_manifest(raw: bytes) -> dict:
    return json.loads(raw.decode())
