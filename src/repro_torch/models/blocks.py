"""Transformer blocks as plain functions over parameter dicts.

Block contract:

    apply_block(kind, params, x, ctx, cache) -> x_out

where ``ctx`` carries positions, rotary tables and the config.
``cache=None`` means a full-sequence forward with no state; otherwise
``cache`` is this block's KV cache and is **updated in place** (the JAX
reference returns a new cache; writing the slots in place saves a copy of
the cache per layer and step).

This slice covers attention kinds with a dense gated FFN.  MoE, SSD,
RG-LRU and the ring-cache roll for prompts longer than the cache wait for
later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from .config import ATTN_KINDS, ModelConfig
from .layers import dense, gated_mlp, rmsnorm
from .rope import apply_rotary


# ---------------------------------------------------------------------------
# initialization helpers
# ---------------------------------------------------------------------------

def trunc_normal(shape: tuple, fan_in: int, *, lead: tuple = (), device,
                 dtype, generator: torch.Generator) -> torch.Tensor:
    """Truncated normal (±3σ) with std fan_in**-0.5, of shape lead + shape.

    Drawn in fp32 one ``shape`` slice at a time and cast to ``dtype`` as it
    goes, so a bf16 model never holds more than one fp32 slice beside its
    weights."""
    out = torch.empty(lead + tuple(shape), dtype=dtype, device=device)
    std = fan_in ** -0.5
    for dst in out.view(-1, *shape):
        buf = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -3.0, 3.0,
                                    generator=generator)
        dst.copy_(buf.mul_(std))
    return out


def init_attn(cfg: ModelConfig, *, lead: tuple = (), device, dtype,
              generator: torch.Generator) -> dict:
    D, dh = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    init = dict(lead=lead, device=device, dtype=dtype, generator=generator)
    p = {
        "wq": trunc_normal((D, H * dh), D, **init),
        "wk": trunc_normal((D, K * dh), D, **init),
        "wv": trunc_normal((D, K * dh), D, **init),
        "wo": trunc_normal((H * dh, D), H * dh, **init),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * dh), ("bk", K * dh), ("bv", K * dh)):
            p[name] = torch.zeros(lead + (width,), dtype=dtype, device=device)
    return p


def init_ffn(cfg: ModelConfig, d_ff: int, *, lead: tuple = (), device, dtype,
             generator: torch.Generator) -> dict:
    D = cfg.d_model
    init = dict(lead=lead, device=device, dtype=dtype, generator=generator)
    return {
        "gate": trunc_normal((D, d_ff), D, **init),
        "up": trunc_normal((D, d_ff), D, **init),
        "down": trunc_normal((d_ff, D), d_ff, **init),
    }


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def _attn_geometry(cfg: ModelConfig, kind: str):
    causal = cfg.causal and kind != "attn_bidir"
    window = cfg.window if kind in ("attn_sliding", "attn_local") else 0
    chunk = cfg.chunk_size if kind == "attn_chunked" else 0
    use_rope = cfg.pos_type != "none" and kind != "attn_global"  # iRoPE/NoPE
    return causal, window, chunk, use_rope


def attn_forward(p: dict, x: torch.Tensor, kind: str, ctx: dict,
                 cache: Optional[dict] = None):
    """Attention output; a given cache is written in place: prefill
    (S > 1, t == 0) fills slots [0, S) and ``pos[:S] = arange(S)``, decode
    writes slot ``t % Sc`` and ``pos[slot] = t``."""
    cfg: ModelConfig = ctx["cfg"]
    B, S, D = x.shape
    H, K, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    causal, window, chunk, use_rope = _attn_geometry(cfg, kind)

    q = dense(x, p["wq"], p.get("bq")).reshape(B, S, H, dh)
    k = dense(x, p["wk"], p.get("bk")).reshape(B, S, K, dh)
    v = dense(x, p["wv"], p.get("bv")).reshape(B, S, K, dh)
    if use_rope:
        q = apply_rotary(q, ctx["cos"], ctx["sin"])
        k = apply_rotary(k, ctx["cos"], ctx["sin"])

    if cache is None:  # full-sequence self-attention
        out = kops.flash_attention(q, k, v, causal=causal, window=window,
                                   chunk=chunk)
    else:
        Sc = cache["k"].shape[1]
        t = ctx["t"]  # tokens already in the cache
        if S > 1:      # prefill (t == 0)
            if S > Sc:
                raise NotImplementedError(
                    "prompt longer than the ring cache (roll branch) waits "
                    "for a later slice of the port")
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
            cache["pos"][:S] = torch.arange(S, dtype=torch.int32,
                                            device=x.device)
            out = kops.flash_attention(q, k, v, causal=causal, window=window,
                                       chunk=chunk)
        else:          # decode one token at position t
            slot = t % Sc
            cache["k"][:, slot] = k[:, 0]
            cache["v"][:, slot] = v[:, 0]
            cache["pos"][slot] = t
            q_pos = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
            k_pos = cache["pos"][None].expand(B, Sc)
            out = kops.flash_attention(
                q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                causal=causal, window=window, chunk=chunk, q_positions=q_pos,
                k_positions=k_pos)

    out = out.reshape(B, S, H * dh)
    return dense(out, p["wo"])


# ---------------------------------------------------------------------------
# block application (pre-norm residual layer)
# ---------------------------------------------------------------------------

def apply_block(kind: str, p: dict, x: torch.Tensor, ctx: dict,
                cache: Optional[dict] = None):
    """One full layer: attention + dense gated FFN, pre-norm residuals."""
    cfg: ModelConfig = ctx["cfg"]
    if kind not in ATTN_KINDS or "moe" in p:
        raise NotImplementedError(f"{kind} / MoE blocks wait for a later "
                                  "slice of the port")
    h = rmsnorm(x, p["norm1"], eps=cfg.norm_eps)
    x = x + attn_forward(p["mixer"], h, kind, ctx, cache)
    if "ffn" in p:
        h = rmsnorm(x, p["norm2"], eps=cfg.norm_eps)
        x = x + gated_mlp(h, p["ffn"], cfg.act)
    return x
