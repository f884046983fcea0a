"""Distributed flash-decode: single-token attention over a KV cache whose
*sequence* dimension is sharded across mesh axes.

Why: tensor-parallel decode with few KV heads (GQA kv=4 on a model axis
of 8, or MQA kv=1) cannot shard heads; sharding the cache sequence
instead keeps memory balanced and turns the softmax into a two-pass
distributed reduction (local partial max, then the sums of the
exp-rescaled numerators and denominators): flash-decoding / split-KV.
Cost: one ``MAX`` and two ``SUM`` all-reduces of (B, H, dh)-sized tensors
per layer, against gathering the whole cache.

Plain torch on each rank's local shard, as the reference's body is plain
``jnp`` inside its ``shard_map``; not a kernel.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import collectives as C

NEG_INF = -1e30


def _local_decode_attn(q, k, v, k_pos, q_pos, *, mesh, axes, causal, window,
                       chunk, scale):
    """q (B,1,H,dh) whole; k/v (B,Sl,K,dh) this rank's slots; k_pos (Sl,)
    their global positions (-1: empty); q_pos the query's position."""
    B, _, H, dh = q.shape
    Sl, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.reshape(B, K, G, dh).float()
    kf = k.float()
    logits = torch.einsum("bkgd,bskd->bkgs", qf, kf) * scale   # (B,K,G,Sl)

    valid = k_pos >= 0
    if causal:
        valid &= q_pos >= k_pos
    if window:
        valid &= (q_pos - k_pos) < window
    if chunk:
        valid &= (q_pos // chunk) == (k_pos // chunk)
    logits = torch.where(valid[None, None, None, :], logits, NEG_INF)

    m = logits.amax(-1, keepdim=True).contiguous()             # (B,K,G,1)
    C.all_reduce(m, mesh, axes, dist.ReduceOp.MAX)
    p = torch.exp(logits - m)
    p = torch.where(valid[None, None, None, :], p, 0.0)
    num = torch.einsum("bkgs,bskd->bkgd", p, v.float()).contiguous()
    den = p.sum(-1, keepdim=True).contiguous()                 # (B,K,G,1)
    C.all_reduce(num, mesh, axes)
    C.all_reduce(den, mesh, axes)
    out = num / den.clamp(min=1e-30)
    return out.reshape(B, 1, H, dh).to(q.dtype)


def seq_sharded_decode_attention(mesh, axes: tuple, q, k, v, k_pos, q_pos, *,
                                 batch_axes=(), causal=True, window=0,
                                 chunk=0, scale=None):
    """q (B,1,H,dh), the same on every rank of ``axes``; k/v (B,Sl,K,dh)
    and k_pos (Sl,): this rank's slots of a cache whose sequence is split
    over ``axes``; q_pos the query's position (an int or a 0-d tensor).
    ``batch_axes`` (the reference's, which splits B over them) need no
    collective here: each rank's B rows are its own."""
    dh = q.shape[-1]
    scale = scale if scale is not None else dh ** -0.5
    q_pos = torch.as_tensor(q_pos, dtype=torch.int32, device=q.device)
    return _local_decode_attn(q, k, v, k_pos, q_pos, mesh=mesh,
                              axes=tuple(axes), causal=causal, window=window,
                              chunk=chunk, scale=scale)
