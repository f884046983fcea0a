"""AdamW with fp32 moments and global-norm clipping, function for function
as the reference (which also shards the moments over a mesh: one card has
none).  Parameter trees are nested dicts and lists of tensors; the update
is functional, as in the reference: new parameters and moments, the old
ones untouched."""
from __future__ import annotations

from dataclasses import dataclass

import torch

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


def global_norm(tree) -> torch.Tensor:
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.stack(leaves).sum().sqrt()


def adamw_update(grads, opt, params, lr, cfg: AdamWConfig = AdamWConfig()):
    """Returns (new_params, new_opt, {"grad_norm", "clip_scale"})."""
    gnorm = global_norm(grads)
    scale = (cfg.clip_norm / (gnorm + 1e-9)).clamp(max=1.0)
    count = opt["count"] + 1
    c = count.float()
    bc1 = 1.0 - cfg.b1 ** c
    bc2 = 1.0 - cfg.b2 ** c

    def upd(g, m, v, p):
        # the reference's operations in its order; each temporary is freed
        # (or written in place) as soon as it is used, since a leaf may be
        # gigabytes (recurrentgemma-9b's tied 256000-word embedding: 4.2 GB)
        g = g.float() * scale
        m = (cfg.b1 * m).add_((1 - cfg.b1) * g)
        v = (cfg.b2 * v).add_(g.square().mul_(1 - cfg.b2))
        del g
        step = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if p.ndim >= 2:  # decay matrices only (norms/bias exempt)
            step.add_(cfg.weight_decay * p.float())
        return (p.float() - step.mul_(lr)).to(p.dtype), m, v

    out = tree_map(upd, grads, opt["m"], opt["v"], params)
    pick = lambda i: tree_map(lambda o: o[i], out,  # noqa: E731
                              is_leaf=lambda o: isinstance(o, tuple))
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}, {
        "grad_norm": gnorm, "clip_scale": scale}
