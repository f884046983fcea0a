"""Dispatch wrappers: the models call these.

Dispatch is by the tensor's device and nothing else: a CUDA tensor goes to
the Hopper kernel (which launches or raises), a CPU tensor to the plain
PyTorch version.  No environment switch routes the card to the plain
versions.  A fake CUDA tensor (the dry-run's ``FakeTensorMode``: shapes and
dtypes, no data) goes the card's way too, and its wrapper takes its
shape-only twin (``kernels/_twin.py``): the outputs the launch allocates,
its cost charged to the dry-run's ``KernelCosts``, nothing launched and
nothing added to the wrapper's launch counts.  That is shape
inference for tensors that hold no data, not a fallback: a real CUDA
tensor always launches or raises, and a CPU tensor, fake or not, goes to
the plain version.

Gradients: on the CPU autograd differentiates the plain versions.  On the
card, a call that needs a gradient (grad mode on and an input that requires
one) goes through the kernel's ``torch.autograd.Function``, whose backward
is a kernel too (RMSNorm, flash attention, the RG-LRU and SSD scans); any
other call goes to the raw wrapper, as serving always did.  Called with such
inputs, a raw wrapper refuses rather than drop the gradient.
"""
from __future__ import annotations

import torch

from .flash_attention.kernel import (FlashAttentionFunction,
                                     flash_attention_cuda)
from .flash_attention.ref import mha_ref
from .rglru.kernel import RGLRUFunction, rglru_cuda
from .rglru.ref import rglru_assoc, rglru_sequential
from .rmsnorm.kernel import RMSNormFunction, rmsnorm_cuda
from .rmsnorm.ref import rmsnorm_ref
from .ssd.kernel import SSDFunction, ssd_cuda
from .ssd.ref import ssd_chunked, ssd_sequential


def _on_cuda(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, *, eps: float = 1e-6, residual=None):
    if _on_cuda(x):
        if _needs_grad(x, scale, residual):
            return RMSNormFunction.apply(x, scale, residual, eps)
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
        if _needs_grad(q, k, v):
            return FlashAttentionFunction.apply(q, k, v, causal, window,
                                                chunk, scale)
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

    The kernel takes every S, so the card sends prefill and decode (S = 1)
    alike to it; the CPU path is ``rglru_assoc`` from 64 steps on and
    ``rglru_sequential`` below, as the JAX package's CPU path."""
    if _on_cuda(gx):
        if _needs_grad(log_a, gx, h0):
            return RGLRUFunction.apply(log_a, gx, h0)
        return rglru_cuda(log_a, gx, h0)
    if gx.shape[1] >= 64:
        return rglru_assoc(log_a, gx, h0)
    return rglru_sequential(log_a, gx, h0)


# ---------------------------------------------------------------------------
# Mamba-2 SSD scan
# ---------------------------------------------------------------------------

def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk: int = 128):
    """x (B,S,H,P), dt (B,S,H), A, D (H,), Bm/Cm (B,S,G,N) ->
    (y (B,S,H,P) in ``x.dtype``, state (B,H,P,N) fp32 after the last token),
    from a zero state.

    The kernel takes every S (it pads the ragged last chunk itself); the CPU
    path is ``ssd_chunked`` when S is a multiple of the chunk and
    ``ssd_sequential`` otherwise, as the JAX package's CPU path."""
    if _on_cuda(x):
        if _needs_grad(x, dt, A, Bm, Cm, D):
            return SSDFunction.apply(x, dt, A, Bm, Cm, D, chunk)
        return ssd_cuda(x, dt, A, Bm, Cm, D, chunk=chunk)
    if x.shape[1] % chunk == 0:
        return ssd_chunked(x, dt, A, Bm, Cm, D, chunk=chunk)
    return ssd_sequential(x, dt, A, Bm, Cm, D)
