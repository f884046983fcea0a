"""AdamW with fp32 moments and global-norm clipping, function for function
as the reference.  Parameter trees are nested dicts and lists of tensors;
the update is functional, as in the reference: new parameters and
moments, the old ones untouched.

On a mesh each rank holds its shards (``parallel.sharding``): the norm is
the whole gradient tree's, and a moment that ZeRO-1 splits over ``data``
(its local shape smaller than the parameter's along one dim) updates this
rank's slice of the parameter, the slices then gathered over ``data``."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.parallel import collectives as C
from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init_opt_state(params) -> dict:
    def z():
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
    return {"m": z(), "v": z(),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device)}


def global_norm(tree, mesh=None, sharded=None) -> torch.Tensor:
    """The L2 norm of the tree's leaves.  On a ``mesh``, ``tree`` holds this
    rank's shards and ``sharded`` (a matching tree of bools; None: no leaf)
    marks the leaves split over ``model``: their squares are summed over
    ``model``, a replicated leaf's counted once, so the norm is the whole
    tree's."""
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    flags = tree_leaves(sharded) if sharded is not None else \
        [False] * len(leaves)
    whole = [x for x, f in zip(leaves, flags) if not f]
    split = [x for x, f in zip(leaves, flags) if f]
    if split:
        whole.append(C.all_reduce(torch.stack(split).sum().reshape(1), mesh,
                                  ("model",))[0])
    return torch.stack(whole).sum().sqrt()


def _zero_dim(m: torch.Tensor, p: torch.Tensor):
    """The dim along which ZeRO-1 split the moment ``m`` of ``p``."""
    for i, (a, b) in enumerate(zip(m.shape, p.shape)):
        if a != b:
            return i
    return None


def adamw_update(grads, opt, params, lr, cfg: AdamWConfig = AdamWConfig(),
                 *, mesh=None, sharded=None):
    """Returns (new_params, new_opt, {"grad_norm", "clip_scale"}).  On a
    ``mesh``: this rank's shards, ``sharded`` as in ``global_norm``."""
    gnorm = global_norm(grads, mesh, sharded)
    scale = (cfg.clip_norm / (gnorm + 1e-9)).clamp(max=1.0)
    count = opt["count"] + 1
    c = count.float()
    bc1 = 1.0 - cfg.b1 ** c
    bc2 = 1.0 - cfg.b2 ** c

    def upd(g, m, v, p):
        # the reference's operations in its order; each temporary is freed
        # (or written in place) as soon as it is used, since a leaf may be
        # gigabytes (recurrentgemma-9b's tied 256000-word embedding: 4.2 GB)
        dim = None if mesh is None else _zero_dim(m, p)
        if dim is not None:     # this rank's ZeRO-1 slice
            i, n = C.axis_index(mesh, "data"), C.axis_size(mesh, "data")
            g, p = C.local_slice(g, dim, i, n), C.local_slice(p, dim, i, n)
        g = g.float() * scale
        m = (cfg.b1 * m).add_((1 - cfg.b1) * g)
        v = (cfg.b2 * v).add_(g.square().mul_(1 - cfg.b2))
        del g
        step = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if p.ndim >= 2:  # decay matrices only (norms/bias exempt)
            step.add_(cfg.weight_decay * p.float())
        new = (p.float() - step.mul_(lr)).to(p.dtype)
        if dim is not None:
            new = C.all_gather(new, dim, mesh, ("data",))
        return new, m, v

    out = tree_map(upd, grads, opt["m"], opt["v"], params)
    pick = lambda i: tree_map(lambda o: o[i], out,  # noqa: E731
                              is_leaf=lambda o: isinstance(o, tuple))
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}, {
        "grad_norm": gnorm, "clip_scale": scale}
