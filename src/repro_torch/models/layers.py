"""Shared layer primitives: norms, gated MLPs, embeddings, the loss.

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


def token_nll(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 0.0,
              compute_dtype=torch.float32, vocab=None) -> torch.Tensor:
    """Per-token CE (with z-loss) in fp32, as ``cross_entropy`` reduces it.

    ``vocab``: the ``Constrainer`` of a mesh whose ``model`` ranks each hold
    a contiguous slice of the vocabulary's logits (the vocabulary-parallel
    head): the max, the sum of exponentials and the gold logit are then
    reduced over ``model``, so the log-sum-exp (and the z-loss on it) is
    the whole vocabulary's, and no rank holds (B, S, V)."""
    logits = logits.to(compute_dtype)
    m = logits.amax(dim=-1, keepdim=True).detach()
    if vocab is not None:
        m = vocab.max(m)
    sumexp = torch.exp(logits - m).sum(dim=-1, dtype=torch.float32)
    if vocab is not None:
        sumexp = vocab.reduce(sumexp)
    lse = torch.log(sumexp) + m[..., 0].float()
    ids = torch.arange(logits.shape[-1], device=logits.device)
    if vocab is not None:
        ids = ids + vocab.index * logits.shape[-1]
    gold = torch.where(ids == labels[..., None], logits, 0.0).sum(
        dim=-1, dtype=torch.float32)
    if vocab is not None:
        gold = vocab.reduce(gold)
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    return nll


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None, z_loss: float = 0.0,
                  compute_dtype=torch.float32):
    """Token-mean CE with fp32 reductions (default) and optional z-loss;
    returns (loss, denominator).

    logits (..., V) any float dtype; labels (...) int; mask (...) bool.  As
    in the reference, the max is held out of the gradient and the gold logit
    is taken by a masked reduction over the vocabulary, not a gather.
    compute_dtype=bfloat16 skips the fp32 copy of the (B,S,V) logits; the
    reductions still accumulate in fp32."""
    nll = token_nll(logits, labels, z_loss, compute_dtype)
    if mask is None:
        return nll.mean(), nll.numel()
    mask = mask.float()
    denom = mask.sum().clamp(min=1.0)
    return (nll * mask).sum() / denom, denom


def cast_tree(tree, dtype):
    """Cast the floating tensors of a parameter tree to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
