"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE.

M-RoPE (multimodal RoPE, arXiv:2409.12191): the head-dim frequency bands are
split into (temporal, height, width) sections; each band rotates by the
corresponding coordinate of the 3-D position id.  Text tokens carry equal
(t, h, w) ids, so M-RoPE degenerates to RoPE on pure text.
"""
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


def mrope_cos_sin(positions3: torch.Tensor, head_dim: int, theta: float,
                  sections: tuple):
    """positions3 (3, ..., S) int -> cos/sin (..., S, head_dim), fp32.

    ``sections`` (t, h, w) partition the head_dim / 2 frequency bands: band
    i rotates by the coordinate its section names, in order."""
    if positions3.shape[0] != 3:
        raise ValueError(f"positions3 needs a leading axis of 3, got "
                         f"{tuple(positions3.shape)}")
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    inv = _inv_freq(head_dim, theta, positions3.device)
    freqs = positions3[..., None].float() * inv  # (3, ..., S, half)
    # the coordinate of each band, built on the host: a repeat_interleave
    # by a tensor of counts has a data-dependent length, which a trace on
    # tensors that hold no data cannot follow
    band_src = torch.tensor([i for i, n in enumerate(sections)
                             for _ in range(n)], device=positions3.device)
    # band j takes coordinate band_src[j]: take_along_axis over the leading 3
    idx = band_src.view((1,) * (freqs.ndim - 1) + (half,))
    freqs = torch.gather(freqs, 0, idx.expand((1,) + freqs.shape[1:]))[0]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def text_positions3(positions: torch.Tensor) -> torch.Tensor:
    """Lift 1-D positions (..., S) to degenerate (t, h, w) ids (3, ..., S)
    for text tokens."""
    return positions[None].expand((3,) + tuple(positions.shape))


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
