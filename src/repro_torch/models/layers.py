"""Shared layer primitives: norms, gated MLPs, embeddings.

Plain functions over tensors and parameter dicts; the compute dtype is the
dtype of the activations passed in.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32 (the CUDA kernel on the card)."""
    return kops.rmsnorm(x, scale, eps=eps)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def act_fn(name: str):
    return {"silu": F.silu, "gelu": partial(F.gelu, approximate="tanh")}[name]


def gated_mlp(x: torch.Tensor, p: dict, act: str = "silu") -> torch.Tensor:
    """SwiGLU/GeGLU: down( act(x @ gate) * (x @ up) )."""
    g = act_fn(act)(dense(x, p["gate"]))
    u = dense(x, p["up"])
    return dense(g * u, p["down"])


def embed(tokens: torch.Tensor, table: torch.Tensor, dtype) -> torch.Tensor:
    return F.embedding(tokens, table).to(dtype)


def unembed(x: torch.Tensor, table_or_head: torch.Tensor, *,
            tied: bool, softcap: float = 0.0) -> torch.Tensor:
    w = table_or_head.to(x.dtype)
    logits = x @ (w.T if tied else w)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def cast_tree(tree, dtype):
    """Cast the floating tensors of a parameter tree to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
