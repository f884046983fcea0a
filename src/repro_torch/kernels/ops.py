"""Dispatch wrappers: the models call these.

Dispatch is by the tensor's device and nothing else: a CUDA tensor goes to
the Hopper kernel (which launches or raises), a CPU tensor to the plain
PyTorch version.  No environment switch routes the card to the plain
versions.
"""
from __future__ import annotations

import torch

from .flash_attention.kernel import flash_attention_cuda
from .flash_attention.ref import mha_ref
from .rglru.kernel import rglru_cuda
from .rglru.ref import rglru_sequential
from .rmsnorm.kernel import rmsnorm_cuda
from .rmsnorm.ref import rmsnorm_ref


def _on_cuda(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, *, eps: float = 1e-6, residual=None):
    if _on_cuda(x):
        return rmsnorm_cuda(x, scale, eps=eps, residual=residual)
    return rmsnorm_ref(x, scale, eps=eps, residual=residual)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal=True, window=0, chunk=0,
                    q_positions=None, k_positions=None, softcap=0.0,
                    scale=None):
    """q (B,Sq,H,dh), k/v (B,Sk,K,dh) -> (B,Sq,H,dh).

    The kernel takes the self-attention layout (Sq == Sk, positions
    defaulted, no softcap) at any S: training and prefill.  Everything else
    (decode over the cache, explicit positions, softcap) is ``mha_ref``, on
    the card too, as the JAX package sends it to its jnp reference."""
    self_attn = (q_positions is None and k_positions is None
                 and q.shape[1] == k.shape[1] and softcap == 0.0)
    if self_attn and _on_cuda(q):
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    chunk=chunk, scale=scale)
    return mha_ref(q, k, v, causal=causal, window=window, chunk=chunk,
                   q_positions=q_positions, k_positions=k_positions,
                   softcap=softcap, scale=scale)


# ---------------------------------------------------------------------------
# RG-LRU scan
# ---------------------------------------------------------------------------

def rglru_scan(log_a, gx, h0=None):
    """log_a, gx (B,S,W) -> (y (B,S,W) in ``gx.dtype``, h_last (B,W) fp32).

    The kernel computes ``rglru_sequential``'s function at every S, so the
    card sends prefill and decode (S = 1) alike to it."""
    if _on_cuda(gx):
        return rglru_cuda(log_a, gx, h0)
    return rglru_sequential(log_a, gx, h0)
