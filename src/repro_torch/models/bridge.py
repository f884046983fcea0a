"""Weight bridge: a parameter tree as numpy arrays -> the port's parameters.

The JAX ``init_params`` tree, turned into numpy (``jax.tree.map(np.asarray,
params)``), has the same keys, the same stacked-superblock layout and the
same shapes as the port's tree, so the bridge only moves each leaf to a
tensor.  This is how the tests give both packages identical weights:
``jax.random`` and ``torch.Generator`` draw different numbers from one seed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from .layers import cast_tree


def params_from_numpy(tree, *, device="cuda", dtype=torch.float32):
    """Same tree of tensors on ``device``; floating leaves cast to ``dtype``
    (bf16 arrays are read through fp32), integer leaves kept as they are."""
    device = resolve_device(device)

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(conv(v) for v in a)
        a = np.asarray(a)
        if a.dtype.kind not in "biu":
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(device)  # a writable copy

    return cast_tree(conv(tree), dtype)
