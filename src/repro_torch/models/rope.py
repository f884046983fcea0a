"""Rotary position embeddings (standard RoPE; M-RoPE waits for the vision
slice)."""
from __future__ import annotations

import torch


def _inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) int -> cos/sin (..., S, head_dim), fp32."""
    inv = _inv_freq(head_dim, theta, positions.device)
    freqs = positions[..., None].float() * inv  # (..., S, half)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, dh); cos/sin (B, S, dh) or (S, dh).  Rotation in fp32,
    result in ``x.dtype``."""
    while cos.ndim < x.ndim:
        cos = cos[..., None, :] if cos.ndim == x.ndim - 1 else cos[None]
        sin = sin[..., None, :] if sin.ndim == x.ndim - 1 else sin[None]
    x32 = x.float()
    out = x32 * cos + _rotate_half(x32) * sin
    return out.to(x.dtype)
