"""Plain PyTorch attention: the CPU path, the decode path, and the oracle for
the CUDA flash-attention kernel.

Mask semantics shared by every attention variant:

* ``causal``      — q_pos >= k_pos
* ``window > 0``  — sliding window: q_pos - k_pos < window
* ``chunk > 0``   — llama4-style chunked locality: q_pos//chunk == k_pos//chunk
* k positions < 0 mark invalid (unwritten cache slots)

GQA is native: q has H heads, k/v have K heads, H = K * G.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                   window: int = 0, chunk: int = 0) -> torch.Tensor:
    """(..., Sq), (..., Sk) int -> (..., Sq, Sk) bool (True = attend)."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    m = k >= 0
    if causal:
        m = m & (q >= k)
    if window:
        m = m & ((q - k) < window)
    if chunk:
        m = m & (torch.div(q, chunk, rounding_mode="floor")
                 == torch.div(k, chunk, rounding_mode="floor"))
    return m


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: int = 0, chunk: int = 0,
            q_positions: torch.Tensor | None = None,
            k_positions: torch.Tensor | None = None,
            softcap: float = 0.0, scale: float | None = None) -> torch.Tensor:
    """q (B,Sq,H,dh); k,v (B,Sk,K,dh) -> (B,Sq,H,dh).

    Logits and softmax in fp32; the probabilities are cast to ``v.dtype``
    before the PV product.  Output in ``q.dtype``."""
    B, Sq, H, dh = q.shape
    _, Sk, K, _ = k.shape
    if H % K:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {K}")
    G = H // K
    scale = scale if scale is not None else dh ** -0.5

    if q_positions is None:
        q_positions = torch.arange(Sq, device=q.device).expand(B, Sq)
        if Sq != Sk:  # decode: new tokens sit at the end of the kv history
            q_positions = q_positions + (Sk - Sq)
    if k_positions is None:
        k_positions = torch.arange(Sk, device=q.device).expand(B, Sk)

    qg = q.reshape(B, Sq, K, G, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    mask = attention_mask(q_positions, k_positions, causal=causal,
                          window=window, chunk=chunk)  # (B,Sq,Sk)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, dh).to(q.dtype)
