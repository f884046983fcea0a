"""Plain PyTorch attention: the CPU path, the decode path, and the oracle for
the CUDA flash-attention kernel.

Mask semantics shared by every attention variant:

* ``causal``      — q_pos >= k_pos
* ``window > 0``  — sliding window: q_pos - k_pos < window
* ``chunk > 0``   — llama4-style chunked locality: q_pos//chunk == k_pos//chunk
* k positions < 0 mark invalid (unwritten cache slots)

GQA is native: q has H heads, k/v have K heads, H = K * G.

The kernels' arithmetic has plain models here too
(``mha_fwd_by_products`` with ``tf32x3_trunc`` for the forward's
mma_tf32x3 body, ``mha_grads_by_products`` with ``tf32x3`` for the fp32
backward, with ``bf16_operands`` and ``bf16_hilo`` for the bf16 sm90
backward): the
tests hold their precision design against JAX; nothing on the CPU path
calls them.
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


def lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
            window: int = 0, chunk: int = 0) -> torch.Tensor:
    """q (B,S,H,dh); k (B,S,K,dh) -> (B,H,S) fp32: each row's log-sum-exp
    of its scaled scores, in fp32 from q and k: the log-sum-exp the flash
    kernels write for their backward."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    pos = torch.arange(S, device=q.device)
    logits = torch.einsum("bqkgd,bskd->bkgqs",
                          q.float().unflatten(2, (K, H // K)), k.float())
    logits = (logits * dh ** -0.5).masked_fill(
        ~attention_mask(pos, pos, causal=causal, window=window, chunk=chunk),
        -torch.inf)
    return torch.logsumexp(logits, -1).flatten(1, 2)


def split_tf32(v: torch.Tensor) -> torch.Tensor:
    """fp32 ``v`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: 10
    explicit mantissa bits, to nearest, ties away from zero (finite
    values)."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncate_tf32(v: torch.Tensor) -> torch.Tensor:
    """fp32 ``v`` truncated to TF32 (its low 13 bits cleared), as the SSD
    backward's and the fp32 forwards' mma bodies split their operands: hi
    = truncate_tf32(v), lo = truncate_tf32(v - hi)."""
    bits = v.float().contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def split_product(a: torch.Tensor, b: torch.Tensor, rnd) -> torch.Tensor:
    """``a @ b`` in fp32 from split operands: each x as hi = rnd(x) and
    lo = rnd(x - hi), and the product (lo·hi + hi·lo) + hi·hi, the two
    small terms first (lo·lo is dropped)."""
    a, b = a.float(), b.float()
    a_hi, b_hi = rnd(a), rnd(b)
    a_lo, b_lo = rnd(a - a_hi), rnd(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the backward kernel's fp32 body forms it on the TF32
    tensor cores (mma.sync m16n8k8, three products a step): about 22 bits
    of each operand's mantissa."""
    return split_product(a, b, split_tf32)


def tf32x3_trunc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the forward's mma_tf32x3 body forms it: ``tf32x3`` with
    truncating splits (``truncate_tf32``: 3 operations a split where
    rounding takes 5)."""
    return split_product(a, b, truncate_tf32)


def bf16_operands(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with each operand rounded to bf16 once and the products
    summed in fp32: the bf16 backward's sm90 body forms dV = Pᵀ dO so, P
    going to wgmma as a bf16 register operand (q, k, v and dO are bf16
    already)."""
    return a.bfloat16().float() @ b.bfloat16().float()


def bf16_hilo(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with each operand as bf16 hi + lo (``split_product``): the
    sm90 body's dK = dSᵀ Q and dQ = dS K (dS in two wgmma chains), and its
    dV above 8 query heads a KV head; about 16 bits of the fp32 operand."""
    return split_product(a, b, lambda t: t.bfloat16().float())


def mha_fwd_by_products(q, k, v, *, causal: bool = True, window: int = 0,
                        chunk: int = 0, scale: float | None = None,
                        matmul=torch.matmul, block: int = 64):
    """(o, lse) of ``mha_ref`` in fp32, formed as the forward's mma_tf32x3
    body forms them: S = Q·Kᵀ a ``block``-key tile at a time through
    ``matmul`` (``tf32x3_trunc``: three TF32 products), the masked softmax
    online over the tiles in fp32 (running max, rescaled sum and output), each
    tile's P·V through ``matmul`` and added to the rescaled output in fp32.
    q (B,S,H,dh); k, v (B,S,K,dh); self-attention.  o (B,S,H,dh), lse
    (B,H,S) with +inf for a row that sees no key."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    scale = scale if scale is not None else dh ** -0.5

    def heads(t, n):     # (B,S,n·g,dh) -> (B,n,g,S,dh)
        return t.float().reshape(B, S, n, -1, dh).permute(0, 2, 3, 1, 4)

    qh, kh, vh = heads(q, K), heads(k, K), heads(v, K)
    pos = torch.arange(S, device=q.device)
    mask = attention_mask(pos, pos, causal=causal, window=window,
                          chunk=chunk)                # (S,S)
    m = torch.full((B, K, H // K, S, 1), -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros((B, K, H // K, S, dh), device=q.device)
    for k0 in range(0, S, block):
        ks = slice(k0, k0 + block)
        s = matmul(qh, kh[..., ks, :].transpose(-1, -2)) * scale
        s = s.masked_fill(~mask[:, ks], -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        seen = torch.isfinite(m_new)
        alpha = torch.where(seen, torch.exp(m - m_new), 1.0)
        p = torch.where(seen, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + matmul(p, vh[..., ks, :])
        m = m_new
    out = torch.where(l > 0, o / l, 0.0)
    lse = torch.where(l > 0, m + torch.log(l), torch.inf)
    return (out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dh),
            lse.reshape(B, H, S))


def mha_grads_by_products(q, k, v, do, *, causal: bool = True,
                          window: int = 0, chunk: int = 0,
                          scale: float | None = None, matmul=torch.matmul,
                          ds_matmul=None):
    """(dq, dk, dv) of ``mha_ref`` in fp32, formed as the backward kernel
    forms them: the forward's row log-sum-exp and output exact, P
    recomputed from the log-sum-exp, D = rowsum(dO·O), and the five
    products S = Q Kᵀ, dP = dO Vᵀ, dV = Pᵀ dO, dQ = scale·dS K and
    dK = scale·dSᵀ Q each through ``matmul`` (``tf32x3``: the kernel's fp32
    body), dQ and dK through ``ds_matmul`` where it is given.  q, do
    (B,S,H,dh); k, v (B,S,K,dh); self-attention."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    scale = scale if scale is not None else dh ** -0.5

    def heads(t, n):     # (B,S,n·g,dh) -> (B,n,g,S,dh)
        return t.float().reshape(B, S, n, -1, dh).permute(0, 2, 3, 1, 4)

    qh, doh = heads(q, K), heads(do, K)
    kh, vh = heads(k, K), heads(v, K)                 # (B,K,1,S,dh)
    pos = torch.arange(S, device=q.device)
    mask = attention_mask(pos, pos, causal=causal, window=window,
                          chunk=chunk)                # (S,S)
    exact = (qh @ kh.transpose(-1, -2)) * scale
    lse = torch.logsumexp(exact.masked_fill(~mask, -torch.inf), -1)
    lse = torch.where(torch.isfinite(lse), lse, torch.inf)[..., None]
    o = torch.exp(exact - lse).masked_fill(~mask, 0.0) @ vh
    delta = (doh * o).sum(-1, keepdim=True)
    p = torch.exp(matmul(qh, kh.transpose(-1, -2)) * scale - lse)
    p = p.masked_fill(~mask, 0.0)
    ds = p * (matmul(doh, vh.transpose(-1, -2)) - delta)
    ds_matmul = matmul if ds_matmul is None else ds_matmul
    dv = matmul(p.transpose(-1, -2), doh).sum(2)      # (B,K,S,dh)
    dk = ds_matmul(ds.transpose(-1, -2), qh).sum(2) * scale
    dq = ds_matmul(ds, kh) * scale                    # (B,K,G,S,dh)
    return (dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, dh),
            dk.transpose(1, 2), dv.transpose(1, 2))
