"""Pipeline parallelism over the pod axis (GPipe schedule), forward.

When the ``pod`` axis is a pipeline axis, each pod holds a contiguous
slice of the superblock stack (the stacked leaves split ``P(axis)`` along
their leading axis) and microbatches flow stage to stage: only (mb, S, D)
activations cross the slow links, against a full gradient sum under pod
data parallelism.

The reference runs every stage in lockstep under a ``shard_map`` and
moves the carries with a ring ``ppermute``; here each stage sends its
output to the next with ``isend`` and the next receives it with
``irecv``, in the same schedule: at tick t stage s runs microbatch t - s.
The last stage's outputs are then broadcast to every stage (the
reference's psum of the last stage's outputs and zeros elsewhere).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from . import collectives as C


def pp_forward(mesh, stage_body: Callable, local_params, x_micro, *,
               axis: str = "pod"):
    """GPipe forward.

    stage_body(local_params, x) -> x   applies this stage's layer slice
    local_params: this stage's slice of the stacked superblock tree
    x_micro: (n_micro, mb, S, D) microbatched embeddings (the same on every
    stage; only stage 0 consumes them)
    returns (n_micro, mb, S, D) outputs, the same on every stage."""
    n_stages = C.axis_size(mesh, axis)
    n_micro = x_micro.shape[0]
    assert n_micro >= n_stages, "need >= n_stages microbatches to fill"
    stage = C.axis_index(mesh, axis)
    group = mesh.get_group(axis)
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    nxt = dist.get_global_rank(group, stage + 1) \
        if stage < n_stages - 1 else None
    outs = torch.zeros_like(x_micro)
    sends = []
    for t in range(n_micro + n_stages - 1):
        k = t - stage
        if not 0 <= k < n_micro:
            continue
        if prev is None:
            x_in = x_micro[k]
        else:
            x_in = torch.empty_like(x_micro[0])
            dist.irecv(x_in, src=prev, group=group).wait()
        y = stage_body(local_params, x_in).contiguous()
        if nxt is not None:
            sends.append((dist.isend(y, dst=nxt, group=group), y))
        else:
            outs[k] = y
    for work, _ in sends:
        work.wait()
    if n_stages > 1:
        dist.broadcast(outs, src=dist.get_global_rank(group, n_stages - 1),
                       group=group)
    return outs


def pp_stage_body(cfg, ctx, dtype):
    """stage_body for a uniform-pattern decoder: this stage's superblocks
    in order, each layer of the pattern by ``apply_block``."""
    from repro_torch.models import blocks as B
    from repro_torch.models.layers import cast_tree
    from repro_torch.models.model import _layer
    from repro_torch.tree import tree_leaves

    pattern = cfg.block_pattern

    def body(params_local, x):
        n_local = tree_leaves(params_local)[0].shape[0]
        for i in range(n_local):
            for pos, kind in enumerate(pattern):
                p = cast_tree(_layer(params_local[pos], i), dtype)
                x, _ = B.apply_block(kind, p, x, ctx, None)
        return x

    return body
