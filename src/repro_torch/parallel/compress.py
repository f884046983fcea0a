"""Cross-pod gradient compression.

The 'pod' mesh axis rides the slowest links, and the only traffic that
must cross it in data-parallel training is the gradient sum.
``int8_psum`` quantizes each leaf to int8 against a pod-consistent scale
(the largest magnitude over the whole leaf and every pod, a ``MAX``
all-reduce, as the reference's ``pmax``) and sums the int8 values
exactly: 1/127 relative, valid up to 258 pods (127 · 258 < 2¹⁵).

The reference sums int16 on the wire (``psum`` of int16).  Neither NCCL
nor gloo reduces int16, so the port sums by hand, in two exchanges that
each carry at most 2 B an element:

1. ``all_to_all_single`` of the int8 values: rank j receives chunk j of
   every rank's leaf (1 B an element);
2. rank j sums those n chunks in int32 (exact), stores the sum as int16
   (|sum| <= 127 · n <= 2¹⁵ - 1 for n <= 258), and the sums are
   all-gathered as their bytes (2 B an element).

So every rank ends with the same exact integer sum, as the reference's
psum gives it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map
from . import collectives as C

MAX_RANKS = 258          # 127 · 258 = 32766 <= int16's largest value


def int8_psum(x: torch.Tensor, mesh, axis: str,
              scale_axes: tuple = ()) -> torch.Tensor:
    """Compressed sum of a float tensor across ``axis`` (fp32 result).
    ``scale_axes``: axes over which ``x`` is itself a shard of one leaf
    (``model`` for a model-sharded gradient), so that the scale is the
    whole leaf's largest magnitude, as the reference takes it."""
    n = C.axis_size(mesh, axis)
    if n > MAX_RANKS:
        raise ValueError(f"int8_psum sums exactly over at most {MAX_RANKS} "
                         f"ranks, not {n}")
    xf = x.float()
    scale = (xf.abs().max() / 127.0).reshape(1)
    C.all_reduce(scale, mesh, tuple(scale_axes) + (axis,), dist.ReduceOp.MAX)
    scale = scale.clamp(min=1e-30)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    flat = q.reshape(-1)
    size = flat.numel()
    chunk = -(-size // n)
    flat = torch.nn.functional.pad(flat, (0, chunk * n - size))
    group = mesh.get_group(axis)
    got = torch.empty_like(flat)                           # int8 on the wire
    dist.all_to_all_single(got, flat, group=group)
    part = got.reshape(n, chunk).to(torch.int32).sum(0).to(torch.int16)
    sums = C.all_gather(part.view(torch.uint8), 0, mesh, (axis,))
    s = sums.view(torch.int16)[:size].reshape(x.shape)     # int16 bytes
    return s.float() * scale


def compressed_grad_psum(grads, mesh, axis: str, n: int, scale_axes):
    """Mean of per-pod gradients via int8 psum.  ``scale_axes``: a tree of
    the axes each leaf is sharded over besides ``axis``."""
    return tree_map(lambda g, a: int8_psum(g, mesh, axis, a) / n, grads,
                    scale_axes)
