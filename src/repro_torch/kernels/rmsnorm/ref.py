"""Plain PyTorch RMSNorm: the CPU path and the oracle for the CUDA kernel."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
                residual: torch.Tensor | None = None) -> torch.Tensor:
    """y = x / rms(x) * scale, statistics in fp32; the optional residual is
    added after scaling (the fused epilogue case).  Output in ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * (var + eps) ** -0.5
    y = y * scale.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)
